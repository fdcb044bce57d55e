"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert width) vocab=151936.
Shared experts are fused into one 5632-wide MLP with a sigmoid gate
(Qwen-MoE design).  Routed experts are padded 60 -> 64 for EP=16
(router never selects pads; DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    d_ff=1408,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                              qkv_bias=True),
    moe=MoEConfig(n_routed=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=4 * 1408, shared_gate=True),
    subquadratic=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
