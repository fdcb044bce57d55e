"""qwen2.5-32b — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
40 heads are padded to 48 for TP=16 (DESIGN.md §4) — padding happens in the
model build, the config records the true head count.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    d_ff=27648,
    vocab_size=152064,
    attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                              qkv_bias=True, rope_theta=1_000_000.0),
    subquadratic=False,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
