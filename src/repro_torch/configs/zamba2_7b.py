"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242;
unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Every 6th layer slot applies the single SHARED attention+MLP block (params
shared across applications, per the Zamba2 design); the remaining slots are
Mamba2 blocks.  81 slots => 13 shared applications + 68 Mamba2 blocks.

Hybrid => subquadratic: the Mamba state is O(1) and the shared-attention KV
is window-capped at 32k for the long_500k cell (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=112,
                              sliding_window=32768),
    ssm=SSMConfig(state_dim=64, conv_dim=4, head_dim=64, expand=2, chunk=256),
    shared_attn_every=6,
    subquadratic=True,
    source="arXiv:2411.15242; unverified",
)
