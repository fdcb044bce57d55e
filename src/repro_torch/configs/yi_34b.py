"""yi-34b — llama-arch GQA [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
56 heads padded to 64 for TP=16 (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab_size=64000,
    attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                              rope_theta=5_000_000.0),
    subquadratic=False,
    source="arXiv:2403.04652; hf",
)
