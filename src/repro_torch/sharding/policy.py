"""Named variants of the LM step for the dry run, the split of a
megabatch program over a mesh, and the topology layer's bucket -> host
placement policy.

A variant = (sharding-rule changes, model-build overrides); the dry run's
``--variant NAME`` applies one.  The table is the JAX package's, field
for field.  On one card only the overrides act (``attn_chunk``,
``remat``, ``n_microbatch``): the port's layers take no sharding rules,
so ``rules_update`` is kept as the reference states it and changes
nothing here — ``no_seqpar`` and ``dp_heavy`` run as ``default`` does.

``place_bucket`` scores one megabatch bucket against every host's
page-pool residency — stack-cached beats pages-resident beats cold — and
``steal_choice`` picks what an idle host takes from the most loaded one.
Both are pure functions of the observed pools/queues, so a drain's
routing is reproducible; and because per-task keys are fixed at compile
time, no placement they produce can move an estimate.

``megabatch_specs`` says which operands of a megabatch program split
over the mesh's "data" axis and along which dim, the port's form of the
JAX package's PartitionSpecs (sharding/collectives.py::shard_map applies
it).

The JAX package's ``sharding/policy.py``, copied; ``megabatch_specs``
gives dims where the reference gives PartitionSpecs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Variant:
    name: str
    description: str
    rules_update: Dict[str, object] = field(default_factory=dict)
    attn_chunk: Optional[int] = None
    remat: Optional[str] = None
    n_microbatch: Optional[int] = None


VARIANTS: Dict[str, Variant] = {v.name: v for v in [
    Variant("default", "paper-faithful baseline policy"),
    Variant("no_seqpar",
            "hypothesis: sequence-parallel residual constraint is causing "
            "extra reshard traffic — drop it",
            rules_update={"seq_shard": None}),
    Variant("no_seqpar_m16",
            "no_seqpar trades wire for replicated activation checkpoints; "
            "recover HBM with 16 microbatches",
            rules_update={"seq_shard": None}, n_microbatch=16),
    Variant("dp_heavy",
            "hypothesis: TP all-reduces dominate — shard FFN/heads over "
            "(data,model) jointly and keep activations DP-only",
            rules_update={"act_heads": None, "act_ff": None,
                          "seq_shard": None}),
    Variant("remat_dots",
            "hypothesis: full remat recompute inflates the compute term — "
            "save matmul outputs instead",
            remat="dots"),
    Variant("chunk512", "smaller attention KV chunks (less transient traffic)",
            attn_chunk=512),
    Variant("chunk2048", "larger attention KV chunks (fewer softmax passes)",
            attn_chunk=2048),
]}


def apply_variant(variant: str) -> Variant:
    """The variant named ``variant``; its ``rules_update`` acts on no
    rules here (see above).  An unknown name raises ``KeyError``."""
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; known: "
                       f"{sorted(VARIANTS)}")
    return VARIANTS[variant]


def megabatch_specs(batch_axis: str = "data", *, fused: bool = False
                    ) -> Tuple[Tuple[Optional[int], ...], int]:
    """``(in_dims, out_dim)`` of a megabatch program ``run(pages,
    data_idx, y, w, valid, key_data) -> preds`` split over the mesh axis
    ``batch_axis``: every per-task operand splits on the task axis — the
    compiler pads B to a multiple of the shard count — and the page stack
    (None) is replicated, so every shard can gather any task's page; the
    predictions are reassembled on the task axis.  ``fused=True`` is the
    fused calling convention, whose operands lead with the block axis G:
    G is replicated (each shard runs every block) and the task axis is
    dim 1.  The port's meshes split over "data" alone."""
    if batch_axis != "data":
        raise ValueError(f"megabatch programs split over 'data', not "
                         f"{batch_axis!r}")
    task = 1 if fused else 0
    return (None, task, task, task, task, task), task


@dataclass(frozen=True)
class BucketPlacement:
    """One routing decision plus the residency evidence it came from."""
    host: int
    score: float                        # mean page points in [0, 2]
    resident: int                       # pages of this bucket already held
    total: int                          # pages the bucket needs
    stacked: int                        # pages whose launch stack is cached


def _page_points(pool, pk) -> float:
    """Locality value of one page on one host: 2 if it is launch-ready
    with zero copies (for canonical singleton launches the resident page
    IS the launch array, so this fires for every resident page), 1 if
    only the raw page is held (zero transfers but a copy pending — the
    multi-lane fusion case), 0 cold."""
    if pool.stack_cached((pk,)):
        return 2.0
    if pool.resident(pk):
        return 1.0
    return 0.0


def place_bucket(pkeys: Sequence, pools: Sequence,
                 loads: Sequence[int]) -> BucketPlacement:
    """Route one bucket to the host best positioned to run it.

    ``pkeys`` are the bucket's page keys (one per request in it),
    ``pools`` the per-host PagePools, ``loads`` each host's currently
    queued invocation count.  Score = mean per-page locality points
    (stack-cached > resident > cold); ties break to the least-loaded
    host, then the lowest host id — fully deterministic.
    """
    lane_keys = tuple(dict.fromkeys(pkeys))       # dedup, keep order
    total = max(len(lane_keys), 1)
    best = None
    for hid, pool in enumerate(pools):
        resident = sum(1 for pk in lane_keys if pool.resident(pk))
        stacked = sum(1 for pk in lane_keys if pool.stack_cached((pk,)))
        score = sum(_page_points(pool, pk) for pk in lane_keys) / total
        rank = (-score, loads[hid], hid)
        cand = BucketPlacement(host=hid, score=score, resident=resident,
                               total=total, stacked=stacked)
        if best is None or rank < best[0]:
            best = (rank, cand)
    return best[1]


def steal_choice(queues: Dict[int, List], pools: Sequence,
                 pkeys_of: Callable[[object], Sequence]) \
        -> Optional[Tuple[int, object]]:
    """What an idle host steals: from the donor with the most queued
    buckets (only if it has more than one — never strand a host's last
    bucket mid-flight), take the bucket *least* local to the donor, so
    the migrated residency costs the donor the least.  Returns
    ``(donor_host, bucket_key)`` or None when no steal is worthwhile.
    """
    donor = None
    for hid, keys in sorted(queues.items()):
        if len(keys) > 1 and (donor is None
                              or len(keys) > len(queues[donor])):
            donor = hid
    if donor is None:
        return None
    pool = pools[donor]

    def locality(key):
        lane_keys = tuple(dict.fromkeys(pkeys_of(key)))
        return sum(_page_points(pool, pk) for pk in lane_keys) \
            / max(len(lane_keys), 1)

    # min() is stable: the first enqueued among equally-cold buckets wins
    victim = min(queues[donor], key=locality)
    return donor, victim
