"""llama-3.2-vision-90b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  A cross-attention
layer is interleaved every 5th layer (20 cross-attn layers).  The vision
frontend is a STUB: ``input_specs()`` provides precomputed patch embeddings
(batch, n_img_tokens, d_frontend) which a linear projector maps to d_model.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    d_ff=28672,
    vocab_size=128256,
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    cross_attn_every=5,
    d_frontend=1280,
    n_frontend_tokens=1601,    # (448/14)^2 + 1 per tile, one tile
    subquadratic=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
