"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert width) vocab=102400.
MoE: 64 routed experts, top-6, 2 shared experts; first layer dense
(width 10944).  MLA: kv_lora_rank=512, decoupled rope head dim 64.

NOTE (DESIGN.md §5): the assignment line says both "MoE 64e top-6" and
"2 shared+160 routed"; we implement 64 routed + 2 shared top-6, matching the
published hf config for DeepSeek-V2-Lite.

subquadratic=True for long_500k: the MLA latent cache stores only
(kv_lora_rank + rope_head_dim) = 576 floats/token, ~18x smaller than a full
KV cache, making the 500k decode cell feasible (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    d_ff=1408,
    vocab_size=102400,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                              kv_lora_rank=512, rope_head_dim=64),
    moe=MoEConfig(n_routed=64, top_k=6, d_expert=1408,
                  n_shared=2, d_shared=2 * 1408,
                  first_dense_layers=1, d_first_dense=10944),
    subquadratic=True,
    source="arXiv:2405.04434; hf",
)
