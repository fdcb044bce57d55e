"""The topology layer's bucket -> host placement policy.

``place_bucket`` scores one megabatch bucket against every host's
page-pool residency — stack-cached beats pages-resident beats cold — and
``steal_choice`` picks what an idle host takes from the most loaded one.
Both are pure functions of the observed pools/queues, so a drain's
routing is reproducible; and because per-task keys are fixed at compile
time, no placement they produce can move an estimate.

The placement half of the JAX package's ``sharding/policy.py``, copied;
its sharding-rule variants for the LM models are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


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
