"""whisper-base — enc-dec audio backbone, conv frontend STUB
[arXiv:2212.04356; unverified].

6L(enc)+6L(dec) d_model=512 8H d_ff=2048 vocab=51865.  The conv frontend is
a stub: ``input_specs()`` provides precomputed frame embeddings
(batch, seq, d_frontend).  ``n_layers`` counts DECODER layers per the
assignment ("6L"); the encoder mirrors it.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attention=AttentionConfig(n_heads=8, n_kv_heads=8, head_dim=64),
    n_encoder_layers=6,
    d_frontend=512,
    n_frontend_tokens=0,   # encoder seq comes from the shape cell
    act="gelu",
    glu=False,
    subquadratic=False,
    source="arXiv:2212.04356; unverified",
)
