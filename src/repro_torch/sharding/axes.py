"""Logical-axis sharding (MaxText-style), the JAX package's
``sharding/axes.py`` without JAX.

Model code declares parameters with *logical* axis names ("embed",
"heads", "ff", "experts", "batch", "seq", ...).  A :class:`LogicalRules`
table maps logical names to physical mesh axes; the per-arch policy picks
the table (``rules_for``).  ``resolve`` returns a plain tuple, one entry
per dim (None, an axis name, or a tuple of names), where the reference
returns a ``PartitionSpec`` of the same entries.  The port's layers take
no rules (there is no ``logical_constraint``): a resolved spec places the
parameters on a mesh (``models/param.py`` ``sharding_tree``,
``shard_params``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

from repro_torch import runtime

Physical = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Physical, ...]


@dataclass(frozen=True)
class LogicalRules:
    """logical axis name -> physical mesh axis (or tuple, or None)."""

    rules: Tuple[Tuple[str, Physical], ...]

    def to_dict(self) -> Dict[str, Physical]:
        return dict(self.rules)

    def resolve(self, logical: Tuple[Optional[str], ...],
                shape: Optional[Tuple[int, ...]] = None,
                mesh_sizes: Optional[Dict[str, int]] = None) -> Spec:
        """Map logical dims to mesh axes.  With ``shape``+``mesh_sizes`` the
        resolution is divisibility-aware: axes a dim cannot evenly use are
        dropped *before* being marked used, so later dims can claim them
        (e.g. batch 128 cannot take ("data","model") -> "model" stays free
        for the kv_seq dim)."""
        table = self.to_dict()
        avail = runtime.mesh_axes          # None = no filtering
        phys = []
        used: set = set()

        def _flat(p):
            if p is None:
                return ()
            out = (p,) if isinstance(p, str) else tuple(p)
            if avail is not None:
                out = tuple(a for a in out if a in avail)
            return out

        for i, name in enumerate(logical):
            if name is None:
                phys.append(None)
                continue
            p = table.get(name)
            # Never map two tensor dims to the same mesh axis.
            fp = tuple(a for a in _flat(p) if a not in used)
            if shape is not None and mesh_sizes is not None:
                # greedily drop from the right until the dim divides
                while fp:
                    total = 1
                    for a in fp:
                        total *= mesh_sizes.get(a, 1)
                    if shape[i] % total == 0:
                        break
                    fp = fp[:-1]
            used.update(fp)
            if not fp:
                phys.append(None)
            elif len(fp) == 1:
                phys.append(fp[0])
            else:
                phys.append(fp)
        return tuple(phys)

    def replace(self, **updates: Physical) -> "LogicalRules":
        d = self.to_dict()
        d.update(updates)
        return LogicalRules(tuple(sorted(d.items())))


# ---------------------------------------------------------------------------
# Rule tables.  Mesh axes: ("pod",) "data", "model".
# DP := ("pod","data") for batch / task-grid / FSDP sharding.
# ---------------------------------------------------------------------------
DP = ("pod", "data")

# Big dense/MoE models: FSDP over data, tensor-parallel over model.
MEGATRON_FSDP = LogicalRules((
    # activations
    ("batch", DP),
    ("seq", None),
    ("seq_shard", "model"),       # sequence-parallel segments between blocks
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_ff", "model"),
    ("vocab_logits", "model"),
    ("kv_seq", "model"),          # decode: split-KV over the model axis
    # params: (fsdp dim, tp dim)
    ("embed", "data"),
    ("embed_tp", None),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("experts", "model"),
    ("expert_ff", None),
    ("layers", None),
    ("latent", None),
    ("frontend", None),
    ("conv", None),
    ("state", None),
))

# Small models (xlstm-350m, whisper-base): batch over every axis it divides,
# FFN width over model where divisible; no sequence sharding.
SMALL_DP = LogicalRules((
    ("batch", ("pod", "data", "model")),
    ("seq", None),
    ("seq_shard", None),
    ("act_embed", None),
    ("act_heads", None),
    ("act_ff", "model"),
    ("vocab_logits", "model"),
    ("kv_seq", "model"),
    ("embed", "data"),
    ("embed_tp", None),
    ("vocab", "model"),
    ("heads", None),
    ("kv_heads", None),
    ("ff", "model"),
    ("experts", None),
    ("expert_ff", None),
    ("layers", None),
    ("latent", None),
    ("frontend", None),
    ("conv", None),
    ("state", None),
))

# Kept for experiments: sequence sharding variant (context parallel).
SMALL_SEQ = SMALL_DP.replace(seq="model", seq_shard="model")


def rules_for(arch_name: str, shape_kind: str, d_model: int,
              global_batch: int = 0) -> LogicalRules:
    """Default policy table per (arch, shape-kind)."""
    small = d_model <= 1024
    base = SMALL_DP if small else MEGATRON_FSDP
    if shape_kind == "decode" and 0 < global_batch < 8:
        # long-context cells (batch 1): parallelism must come from the KV
        # sequence, not the batch
        return base.replace(batch=None, kv_seq=("data", "model"))
    return base
