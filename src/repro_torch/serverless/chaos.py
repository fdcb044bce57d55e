"""Order-independent fault plans for the chaos-hardened drain.

A copy of the JAX package's ``serverless/chaos.py`` (numpy only): the
verdicts are the reference's, draw for draw.

The legacy wave scheduler drew faults from ONE sequential Philox stream
per admitted request, which pinned the *draw order*: any scheduler that
dispatched invocations in a different order (bucket-coherent fill, the
two-deep pipeline, hedged duplicates, retries after a host loss) saw a
different fault pattern, so chaos pools were forced onto the
wave-synchronous slow path.  This module replaces the stream with a
**fault plan**: every verdict is a pure function of the invocation's
identity —

    verdict(slot, invocation, attempt)
        = f(Philox(key=pool.seed, counter=[0, attempt, inv, slot]))

where ``slot`` is the request's admission index.  Distinct identities
occupy disjoint counter blocks of one keyed Philox-4x64 cipher, so the
draws are independent, reproducible, and — the property the fast path
needs — **independent of the order anything asks for them**.  A
bucket-coherent pipelined drain, a host-killed rerouted drain, and a
crash-resumed drain all see the same fault schedule for the same pool.

Semantics (matching the legacy wave scheduler where it had them):

  * an *injected* failure fires only on attempt 0, so retries converge
    within the default budget; simulated durations are redrawn per
    attempt (attempt is part of the counter), so timeout-induced
    failures can repeat and genuinely consume the retry budget;
  * stragglers multiply the billed duration by
    ``pool.straggler_slowdown`` and, when ``pool.straggler_hold_s`` is
    set, delay the bucket's readiness — the synthetic long tail the
    deadline/hedge machinery (serverless/dispatch.py) exists to cut;
  * simulated durations follow the paper's speed curve with lognormal
    noise, exactly as before.

Retry scheduling is **capped exponential backoff**
(``backoff_s(attempt) = min(base * 2**(attempt-1), cap)``): a failed
invocation re-enters the pending view but is not re-dispatched before
its gate matures (backends track the gates in ``DrainState.retry_at``).

``REPRO_CHAOS`` arms a plan on pools that configured none — the CI chaos
job runs the ordinary suites under injected faults this way.  Accepted
forms: ``1`` (default 10% failures, 10% stragglers) or
``fail=<rate>,strag=<rate>``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# default rates REPRO_CHAOS=1 arms (the CI chaos job's setting)
ENV_FAILURE_RATE = 0.1
ENV_STRAGGLER_RATE = 0.1


@dataclass(frozen=True)
class Verdict:
    """One invocation-attempt's fate, drawn from its identity stream."""
    failed: bool                 # injected failure (attempt 0 only)
    straggler: bool              # duration multiplied by the slowdown
    noise: float                 # lognormal duration noise (simulate mode)


def env_chaos_rates() -> Optional[Tuple[float, float]]:
    """(failure_rate, straggler_rate) armed by ``REPRO_CHAOS``, or None.

    Read per call (tests flip it with monkeypatch.setenv), like the
    sanitizer's ``REPRO_SANITIZE``.
    """
    raw = os.environ.get("REPRO_CHAOS", "")
    if raw in ("", "0"):
        return None
    if raw == "1":
        return (ENV_FAILURE_RATE, ENV_STRAGGLER_RATE)
    rates = {"fail": ENV_FAILURE_RATE, "strag": ENV_STRAGGLER_RATE}
    for part in raw.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k in rates and v:
            rates[k] = float(v)
    return (rates["fail"], rates["strag"])


@dataclass(frozen=True)
class ChaosPlan:
    """Deterministic per-(slot, invocation, attempt) fault draws.

    Frozen value object: backends build one per pool and share it across
    drains; every query opens a fresh counter-keyed generator, so the
    plan itself carries no mutable stream state to corrupt or reorder.
    """
    failure_rate: float
    straggler_rate: float
    straggler_slowdown: float
    simulate: bool
    seed: int
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 0.25

    def _rng(self, slot: int, inv: int, attempt: int) -> np.random.Generator:
        # Philox-4x64: 128-bit key from the pool seed, 256-bit counter
        # carrying the identity in its high words.  A verdict consumes a
        # handful of 4x64 blocks (low word), so distinct identities can
        # never overlap streams.
        return np.random.Generator(np.random.Philox(
            key=self.seed,
            counter=[0, int(attempt), int(inv), int(slot)]))

    def verdict(self, slot: int, inv: int, attempt: int) -> Verdict:
        """The invocation-attempt's fate.  Pure function of identity:
        any dispatch order, bucketization, hedge race, or resume sees
        the same verdict."""
        rng = self._rng(slot, inv, attempt)
        u_fail = rng.random()
        u_strag = rng.random()
        noise = rng.lognormal(0.0, 0.08) if self.simulate else 1.0
        return Verdict(
            failed=bool(u_fail < self.failure_rate) and attempt == 0,
            straggler=bool(u_strag < self.straggler_rate),
            noise=float(noise))

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential retry backoff after the ``attempt``-th
        failure (attempt >= 1): base, 2*base, 4*base, ... capped."""
        if self.backoff_base_s <= 0:
            return 0.0
        return min(self.backoff_base_s * (2.0 ** (max(attempt, 1) - 1)),
                   self.backoff_cap_s)


def chaos_plan(pool) -> Optional[ChaosPlan]:
    """The pool's fault plan, or None for a fault-free pool (the hot
    path then pays nothing — no draws, no generator inits).

    A pool with its own rates (or ``simulate``) uses them; otherwise
    ``REPRO_CHAOS`` may arm the environment rates (CI chaos job).
    """
    failure, straggler = pool.failure_rate, pool.straggler_rate
    if not (pool.simulate or failure > 0 or straggler > 0):
        env = env_chaos_rates()
        if env is None:
            return None
        failure, straggler = env
    return ChaosPlan(
        failure_rate=failure,
        straggler_rate=straggler,
        straggler_slowdown=pool.straggler_slowdown,
        simulate=pool.simulate,
        seed=pool.seed,
        backoff_base_s=pool.retry_backoff_s,
        backoff_cap_s=pool.retry_backoff_cap_s)
