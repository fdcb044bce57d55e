"""Opt-in runtime sanitizer for the async drain protocol.

A copy of the JAX package's ``serverless/sanitize.py``.
``REPRO_SANITIZE=1`` arms cheap invariant checks at the protocol's
choke points — the live counterpart of the static checker
(``analysis/protocol.py``), driven by the SAME transition table so the
two cannot drift apart:

  * a bucket dispatch is harvested exactly once (a second harvest would
    re-book rows and double-bill the wave);
  * booking only lands on rows in a legal source state per
    ``LEDGER_TRANSITIONS`` (a DONE row being re-booked means a
    lost race or a double-harvest);
  * the duration-attribution frontier only moves forward (overlapping
    attribution double-charges GB-seconds and skews the autoscaler EMA);
  * every pushed bucket carries its booking continuation (book-at-push:
    under pipelined dispatch a bucket may land waves after it was
    pushed, so a missing continuation is work that would harvest into
    the void);
  * a drain never retires with buckets still in flight OR a pipelined
    wave still unsettled (a lost bucket/wave is work billed but never
    booked);
  * bucket lifecycle transitions (hedge, cancel, abandon, book) only
    leave legal source states per ``BUCKET_TRANSITIONS`` — a
    double-hedge, a cancel of an already-cancelled leg, or a booking of
    a CANCELLED/LOST bucket each raise at the transition site.

Checks are no-ops unless the environment variable is set — it is read
per call so a test can flip it with ``monkeypatch.setenv``.  The port's
``BucketDispatch`` keeps its own always-on armed-once flag besides
``check_harvest_once``: without the sanitizer a second harvest raises
``RuntimeError``, with it a ``ProtocolError``.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.analysis.protocol import (BUCKET_TRANSITIONS, INVOCATION_STATES,
                                     LEDGER_TRANSITIONS)


class ProtocolError(AssertionError):
    """An async-protocol invariant was violated at runtime."""


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


_STATE_NAME = {v: k for k, v in INVOCATION_STATES.items()}


def check_harvest_once(dispatch) -> None:
    """Arm-once flag on a BucketDispatch: a second ``harvest()`` of the
    same in-flight bucket raises (it would re-book every entry)."""
    if not enabled():
        return
    if getattr(dispatch, "_sanitize_harvested", False):
        raise ProtocolError(
            f"bucket {dispatch.key} harvested twice — a dispatch is "
            "booked exactly once; a second harvest re-books its rows")
    dispatch._sanitize_harvested = True


def check_booking(ledger, invs, method: str) -> None:
    """Rows being booked must be in a legal source state for ``method``
    per the protocol table (RUNNING, or PENDING on the resume path)."""
    if not enabled():
        return
    legal = {INVOCATION_STATES[s] for s in LEDGER_TRANSITIONS[method][0]}
    invs_arr = np.atleast_1d(np.asarray(invs, np.int64))
    status = np.asarray(ledger.status)[invs_arr]
    bad = invs_arr[~np.isin(status, list(legal))]
    if bad.size:
        states = sorted({_STATE_NAME[int(s)]
                         for s in np.asarray(ledger.status)[bad]})
        raise ProtocolError(
            f"{method} on invocations {bad.tolist()} in state(s) "
            f"{states} — legal sources are "
            f"{list(LEDGER_TRANSITIONS[method][0])}; a DONE row being "
            "re-booked means a double-harvest or lost race")


def check_attribution(t_harvest: float, t_frontier: float) -> None:
    """The non-overlapping duration-attribution frontier is monotone:
    booking a harvest behind the frontier would double-charge the span
    already attributed to an earlier harvest."""
    if not enabled():
        return
    if t_harvest < t_frontier:
        raise ProtocolError(
            f"harvest attribution frontier moved backwards "
            f"({t_harvest:.6f} < {t_frontier:.6f}) — concurrent buckets "
            "would be billed overlapping wall-clock spans")


def check_book_at_push(pb) -> None:
    """Every bucket entering a dispatch queue must carry its booking
    continuation (``PendingBucket.book``) — under pipelined dispatch the
    harvest may happen waves later, with no caller left to supply one."""
    if not enabled():
        return
    if pb.book is None:
        raise ProtocolError(
            f"bucket {pb.key} pushed without a booking continuation — "
            "book-at-push is required: a deferred harvest has no caller "
            "context to book against")


def _check_bucket_transition(pb, action: str) -> None:
    """Shared check: ``pb.state`` must be a legal source of ``action``
    per the protocol's BUCKET_TRANSITIONS table."""
    legal = BUCKET_TRANSITIONS[action][0]
    if pb.state not in legal:
        raise ProtocolError(
            f"{action} on bucket {pb.key} in state {pb.state} — legal "
            f"sources are {list(legal)}")


def check_hedge(pb) -> None:
    """A bucket is hedged at most once, and only while plainly
    DISPATCHED — hedging a HEDGED bucket would launch a third leg the
    settle logic doesn't know about; hedging a CANCELLED/LOST one
    duplicates work that is already accounted elsewhere."""
    if not enabled():
        return
    _check_bucket_transition(pb, "hedge")


def check_cancel(pb) -> None:
    """Only a live racing leg (DISPATCHED duplicate or HEDGED original)
    may be cancelled.  Cancelling a CANCELLED leg means two settle
    sites fired; cancelling a HARVESTED one means the race was settled
    after its loser already booked — both are double-performer bugs."""
    if not enabled():
        return
    _check_bucket_transition(pb, "cancel")


def check_abandon(pb) -> None:
    """Host-loss recovery may only orphan in-flight (DISPATCHED/HEDGED)
    buckets — a HARVESTED or CANCELLED bucket reaching abandon means the
    queue's bookkeeping already retired it once."""
    if not enabled():
        return
    _check_bucket_transition(pb, "abandon")


def check_bucket_bookable(pb) -> None:
    """A bucket being harvested-for-booking must be a live leg
    (DISPATCHED or HEDGED).  Booking a CANCELLED bucket means a losing
    hedge leg's results are entering the ledger alongside the winner's —
    double-booking; booking a LOST one means a dead host's handles were
    harvested."""
    if not enabled():
        return
    _check_bucket_transition(pb, "harvest")


def check_drained(state, where: str) -> None:
    """A drain may only retire with every dispatch queue empty and every
    pipelined wave settled — an in-flight bucket or unsettled wave left
    behind is work billed but never booked."""
    if not enabled():
        return
    n = 0
    q = getattr(state, "queue", None)
    if q is not None:
        n += len(q)
    for hq in getattr(state, "queues", {}).values():
        n += len(hq)
    if n:
        raise ProtocolError(
            f"{where}: drain retiring with {n} bucket(s) still in "
            "flight — every dispatched bucket must be harvested and "
            "booked before the state is dropped")
    waves = getattr(state, "waves_inflight", None)
    if waves:
        raise ProtocolError(
            f"{where}: drain retiring with {len(waves)} pipelined "
            "wave(s) unsettled — every dispatched wave must settle "
            "(book + bill) before the state is dropped")
