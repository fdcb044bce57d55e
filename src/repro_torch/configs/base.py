"""Config dataclasses for architectures and input shapes.

A copy of the JAX package's ``configs/base.py`` (which imports no JAX), so
that the port imports nothing of that package.  Every ported architecture
gets one module in this package defining a ``CONFIG`` (full size) and
implicitly a reduced smoke variant via :meth:`ArchConfig.reduced`.  Configs
are plain frozen dataclasses: hashable and trivially serializable.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    """Multi-head attention settings (GQA / SWA / MLA)."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    # Sliding-window attention (Mistral-style). None = full attention.
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    # Multi-head latent attention (DeepSeek-V2). When kv_lora_rank is set the
    # KV path goes through a shared latent of this rank plus a decoupled
    # rope key of ``rope_head_dim``.
    kv_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    causal: bool = True

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN settings (shared + routed experts)."""

    n_routed: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: int = 0          # total width of the fused shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    shared_gate: bool = False  # qwen2-moe applies a sigmoid gate on shared out
    first_dense_layers: int = 0
    d_first_dense: int = 0     # FFN width of the leading dense layers


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / xLSTM recurrent block settings."""

    state_dim: int = 64
    conv_dim: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256           # SSD chunk length
    # xLSTM: every ``slstm_every``-th block is an sLSTM block (0 = none).
    slstm_every: int = 0


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture."""

    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid (zamba2): one shared attention block applied every N slots.
    shared_attn_every: int = 0
    # VLM: a cross-attention layer every N layers; audio: encoder-decoder.
    cross_attn_every: int = 0
    n_encoder_layers: int = 0
    d_frontend: int = 0         # stubbed modality frontend embedding width
    n_frontend_tokens: int = 0  # image/audio token count fed by the stub
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    glu: bool = True
    # Whether full attention makes long_500k infeasible (skip + note).
    subquadratic: bool = False
    source: str = ""

    # ---- derived ----
    @property
    def is_enc_dec(self) -> bool:
        return self.n_encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        a = self.attention
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention
        if a.is_mla:
            kvr = a.kv_lora_rank
            per_layer += d * (a.q_dim + a.n_heads * a.rope_head_dim)      # q (+rope part)
            per_layer += d * (kvr + a.rope_head_dim)                      # latent down
            per_layer += kvr * (a.q_dim + a.kv_dim)                       # k/v up
            per_layer += a.q_dim * d                                      # o
        else:
            per_layer += d * (a.q_dim + 2 * a.kv_dim) + a.q_dim * d
            if a.qkv_bias:
                per_layer += a.q_dim + 2 * a.kv_dim
        per_layer += 2 * d  # norms
        attn_params = per_layer

        def mlp_params(width: int) -> int:
            return d * width * (3 if self.glu else 2)

        total = emb
        if self.family == "moe":
            m = self.moe
            moe_layer = attn_params + m.n_routed * mlp_params(m.d_expert) \
                + (mlp_params(m.d_shared) if m.d_shared else 0) + d * m.n_routed
            dense_layer = attn_params + mlp_params(m.d_first_dense or self.d_ff)
            total += m.first_dense_layers * dense_layer \
                + (L - m.first_dense_layers) * moe_layer
        elif self.family == "ssm":
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            block = d * 2 * di + di * d + di * s.conv_dim + 2 * di * s.state_dim \
                + 2 * nh + 2 * d
            total += L * block
        elif self.family == "hybrid":
            s = self.ssm
            di = s.expand * d
            n_shared_apps = L // max(self.shared_attn_every, 1)
            n_mamba = L - n_shared_apps
            mamba_block = d * 2 * di + di * d + di * s.conv_dim \
                + 2 * di * s.state_dim + 2 * (di // s.head_dim) + 2 * d
            shared_block = attn_params + mlp_params(self.d_ff)
            total += n_mamba * mamba_block + shared_block
        elif self.family == "vlm":
            n_cross = L // max(self.cross_attn_every, 1)
            cross_layer = attn_params + mlp_params(self.d_ff)
            total += L * (attn_params + mlp_params(self.d_ff)) + n_cross * cross_layer
            total += self.d_frontend * d  # projector
        elif self.family == "audio":
            enc = self.n_encoder_layers * (attn_params + mlp_params(self.d_ff))
            dec = L * (attn_params * 2 + mlp_params(self.d_ff))  # self + cross
            total += enc + dec + self.d_frontend * d
        else:
            total += L * (attn_params + mlp_params(self.d_ff))
        return total

    def active_param_count(self) -> int:
        """Per-token active params (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model

        def mlp_params(width: int) -> int:
            return d * width * (3 if self.glu else 2)

        full = self.param_count()
        routed_total = (self.n_layers - m.first_dense_layers) * m.n_routed \
            * mlp_params(m.d_expert)
        routed_active = (self.n_layers - m.first_dense_layers) * m.top_k \
            * mlp_params(m.d_expert)
        return full - routed_total + routed_active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        a = self.attention
        small_attn = replace(
            a,
            n_heads=min(a.n_heads, 4),
            n_kv_heads=min(a.n_kv_heads, min(a.n_heads, 4)),
            head_dim=32,
            sliding_window=min(a.sliding_window, 64) if a.sliding_window else None,
            kv_lora_rank=32 if a.is_mla else None,
            rope_head_dim=16 if a.is_mla else a.rope_head_dim,
        )
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            attention=small_attn,
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe, n_routed=8, top_k=2, d_expert=32,
                d_shared=64 if self.moe.d_shared else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_first_dense=128 if self.moe.d_first_dense else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=16, head_dim=16, chunk=16)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 3
            kw["n_layers"] = 6
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
            kw["n_layers"] = 4
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
            kw["n_layers"] = 2
        if self.d_frontend:
            kw["d_frontend"] = 32
            kw["n_frontend_tokens"] = 16
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The assigned LM shape set (identical across the 10 archs).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, with the reason when skipped.

    ``long_500k`` needs a sub-quadratic attention path (SSM / hybrid /
    sliding-window / latent-compressed KV); pure full-attention archs skip it
    (see DESIGN.md §5).
    """
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: 500k KV cache infeasible (DESIGN.md §5)"
    if arch.is_enc_dec and shape.name == "long_500k":
        return False, "enc-dec audio backbone: 500k decode inapplicable (DESIGN.md §5)"
    return True, ""
