"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.  SWA window 4096
makes the arch sub-quadratic => long_500k runs with a window-capped KV.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    d_ff=10240,
    vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=120,
                              sliding_window=4096, rope_theta=100_000.0),
    subquadratic=True,   # via SWA: KV cache capped at the window
    source="arXiv:2401.16818; unverified",
)
