"""codeqwen1.5-7b — qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (GQA kv=32, i.e. full MHA) d_ff=13440 vocab=92416.
Qwen1.5 uses QKV bias.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=13440,
    vocab_size=92416,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=128,
                              qkv_bias=True, rope_theta=1_000_000.0),
    subquadratic=False,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)
