"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own up-projection (expand=2); there is no separate FFN.
Every 8th block is an sLSTM block (scalar memory, recurrent), the rest are
mLSTM (matrix memory, chunked-parallel).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    d_ff=0,
    vocab_size=50304,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=256),
    ssm=SSMConfig(state_dim=256, conv_dim=4, head_dim=512, expand=2,
                  chunk=256, slstm_every=8),
    glu=False,
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.04517; unverified",
)
