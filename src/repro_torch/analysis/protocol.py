"""The async drain protocol as an explicit, checked table.

A copy of the JAX package's ``analysis/protocol.py`` with its allowlists
pointing at this package's files and names.  It declares the TaskLedger /
DispatchQueue / PendingBucket machine as data — invocation states, legal
ledger transitions, and the *sole* call sites allowed to perform each
protocol action — and statically checks every audited file against the
table.  The same table drives the opt-in runtime sanitizer
(``serverless/sanitize.py``, ``REPRO_SANITIZE=1``), so the static
allowlist and the live assertions cannot drift apart.

The protocol (one bucket slice's life):

    PLANNED ──mark_running──▶ DISPATCHED ──harvest──▶ HARVESTED
        ──record_success(es)/record_failure──▶ BOOKED

    DISPATCHED ──hedge (overdue)──▶ HEDGED ──harvest──▶ HARVESTED
    DISPATCHED/HEDGED ──cancel (lost the race)──▶ CANCELLED (discarded)
    DISPATCHED/HEDGED ──abandon (host died)──▶ LOST (re-dispatched)

  * every ``dispatch_bucket`` launch is preceded by ``mark_running`` on
    its invocations (a checkpoint taken mid-flight must re-queue them);
  * a bucket is harvested exactly once, and only the dispatch queue and
    the declared scheduler steps may harvest;
  * only the booking functions may write ledger results — booking
    anywhere else would bypass billing, retry, and finalization;
  * schedulers must view pending work through
    ``pending_by_bucket(exclude=<in-flight>)`` so an invocation whose
    launch is on the device is never dispatched twice;
  * a hedge race is settled by exactly ONE performer
    (``HedgePair.settle``): the winning leg books, the loser is
    cancelled and discarded through the same harvest-once flag, so no
    fault schedule can ever double-book or double-bill a bucket;
  * only ``TopologyBackend.kill_host`` may abandon a queue — LOST
    buckets' invocations stay RUNNING in the ledger and resurface via
    the pending view once the dead host's queue is gone.

Where the port's names differ from the reference's, the allowlists name
the port's: the failure booking that the reference writes inline in
``_book_direct`` and ``_book_request_wave`` is one helper here
(``_StreamBackend._book_failure``), the in-flight tail that the
reference's steps harvest inline is ``_StreamBackend._drain_tail``, and
the topology backend's ``step`` harvests in ``TopologyBackend._step``
(``step`` wraps it to sum the per-host dispatch accounting after every
step), and
the port has no synchronous ``run_bucket`` wrapper.  The backends launch
through a wrapper (``_StreamBackend._dispatch``, and
``TopologyBackend._dispatch`` onto a host's stream), whose calls the
mark-before-dispatch rule checks as it checks ``dispatch_bucket``'s.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.report import Finding

# ---------------------------------------------------------------------------
# the state machine, as data
# ---------------------------------------------------------------------------
#: invocation states (mirrors serverless/ledger.py PENDING..FAILED)
INVOCATION_STATES: Dict[str, int] = {
    "PENDING": 0, "RUNNING": 1, "DONE": 2, "FAILED": 3,
}

#: ledger method -> (legal source states, destination state).  RUNNING
#: is a legal source of mark_running (re-dispatch of orphaned rows) and
#: PENDING a legal source of the record methods (resume path: a loaded
#: ledger books rows the previous process had already computed).
LEDGER_TRANSITIONS: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "mark_running": (("PENDING", "FAILED", "RUNNING"), "RUNNING"),
    "record_success": (("RUNNING", "PENDING"), "DONE"),
    "record_successes": (("RUNNING", "PENDING"), "DONE"),
    "record_failure": (("RUNNING",), "FAILED"),
}

#: bucket states (PendingBucket's life in a DispatchQueue)
BUCKET_STATES: Tuple[str, ...] = (
    "PLANNED", "DISPATCHED", "HARVESTED", "BOOKED",
    "HEDGED", "CANCELLED", "LOST")

#: bucket action -> (legal source states, destination state) — drives
#: the runtime sanitizer's check_hedge / check_cancel /
#: check_bucket_bookable hooks exactly as LEDGER_TRANSITIONS drives
#: check_booking, so the fault-tolerance path cannot drift from this
#: table.  "harvest" from HEDGED is the winning original leg;
#: CANCELLED/LOST are terminal (no legal outgoing transitions).
BUCKET_TRANSITIONS: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "dispatch": (("PLANNED",), "DISPATCHED"),
    "harvest": (("DISPATCHED", "HEDGED"), "HARVESTED"),
    "book": (("HARVESTED",), "BOOKED"),
    "hedge": (("DISPATCHED",), "HEDGED"),
    "cancel": (("DISPATCHED", "HEDGED"), "CANCELLED"),
    "abandon": (("DISPATCHED", "HEDGED"), "LOST"),
}

# ---------------------------------------------------------------------------
# performer allowlists: (file relative to src/repro_torch, qualname)
# ---------------------------------------------------------------------------
#: files the static checker audits (relative to the source root)
AUDITED_FILES: Tuple[str, ...] = (
    "serverless/backends.py", "serverless/dispatch.py",
    "serverless/topology.py", "serverless/ledger.py",
    "serverless/chaos.py",
    "core/session.py", "compile/program.py", "compile/buckets.py",
)

#: the ONLY call sites allowed to write ledger results
BOOKING_PERFORMERS: FrozenSet[Tuple[str, str]] = frozenset({
    ("serverless/backends.py", "_StreamBackend._book_direct"),
    ("serverless/backends.py", "WaveBackend._book_request_wave"),
    ("serverless/backends.py", "_StreamBackend._book_failure"),
})
_BOOKING_METHODS = ("record_success", "record_successes", "record_failure")

#: the ONLY call sites allowed to harvest in-flight work
HARVEST_PERFORMERS: FrozenSet[Tuple[str, str]] = frozenset({
    ("serverless/dispatch.py", "DispatchQueue.push"),
    ("serverless/dispatch.py", "DispatchQueue._harvest"),
    ("serverless/dispatch.py", "DispatchQueue.harvest_ready"),
    ("serverless/dispatch.py", "DispatchQueue.harvest_next"),
    ("serverless/dispatch.py", "DispatchQueue.harvest_all"),
    ("serverless/backends.py", "_StreamBackend._drain_tail"),
    ("serverless/backends.py", "_BucketStreamBackend.step"),
    ("serverless/backends.py", "WaveBackend.step"),
    ("serverless/topology.py", "TopologyBackend._step"),
})
_HARVEST_METHODS = ("harvest", "harvest_ready", "harvest_next",
                    "harvest_all", "discard")

#: the ONLY call site allowed to cancel a hedge leg — the race's single
#: settle point.  A rogue ``.cancel()`` elsewhere could cancel BOTH legs
#: (bucket never booked) or cancel after booking (double accounting).
CANCEL_PERFORMERS: FrozenSet[Tuple[str, str]] = frozenset({
    ("serverless/dispatch.py", "HedgePair.settle"),
})

#: the ONLY call site allowed to abandon a queue — host-death recovery.
#: Abandoning anywhere else silently drops in-flight work without the
#: ledger/pending-view bookkeeping that re-dispatches it.
ABANDON_PERFORMERS: FrozenSet[Tuple[str, str]] = frozenset({
    ("serverless/topology.py", "TopologyBackend.kill_host"),
})

#: call sites allowed to view pending work WITHOUT excluding in-flight
#: entries — only the wave autoscaler's roofline pricing thunk, which
#: runs strictly between harvest_all and the next dispatch (queue empty)
PENDING_VIEW_EXEMPT: FrozenSet[Tuple[str, str]] = frozenset({
    ("serverless/backends.py", "WaveBackend._wave_workers"),
})

#: files whose dispatch_bucket calls must be preceded by mark_running in
#: the same function
_LEDGER_LAYER = ("serverless/backends.py", "serverless/topology.py",
                 "core/session.py")

#: the backends' one-line launch wrapper (``dispatch_bucket`` with the
#: backend's device, pages and scheduling knobs): it sits below the
#: ledger layer, so calls of it are dispatches that must follow a
#: mark_running, and it is itself exempt
DISPATCH_WRAPPERS: FrozenSet[Tuple[str, str]] = frozenset({
    ("serverless/backends.py", "_StreamBackend._dispatch"),
    ("serverless/topology.py", "TopologyBackend._dispatch"),
})
_DISPATCH_CALLS = ("dispatch_bucket",) + tuple(
    q.rsplit(".", 1)[-1] for _, q in DISPATCH_WRAPPERS)

#: dataclasses whose generated __eq__ would compare in-flight tensors
#: elementwise — identity equality (eq=False) is load-bearing
IDENTITY_DATACLASSES: Dict[str, str] = {
    "PendingBucket": "serverless/dispatch.py",
    "Launch": "compile/program.py",
    "BucketDispatch": "compile/program.py",
}


def _last(callee: str) -> str:
    return callee.rsplit(".", 1)[-1]


def _check_file(rel: str, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    calls = astutil.module_calls(tree)

    for qual, lineno, callee in calls:
        leaf = _last(callee)
        if leaf in _BOOKING_METHODS and "." in callee:
            if (rel, qual) not in BOOKING_PERFORMERS:
                findings.append(Finding(
                    "protocol", "booking-performer", f"{rel}:{lineno}",
                    f"{callee}() in {qual} — ledger results may only be "
                    "written by the declared booking functions "
                    f"{sorted(q for _, q in BOOKING_PERFORMERS)}"))
        if leaf in _HARVEST_METHODS and "." in callee:
            if (rel, qual) not in HARVEST_PERFORMERS:
                findings.append(Finding(
                    "protocol", "harvest-performer", f"{rel}:{lineno}",
                    f"{callee}() in {qual} — only the dispatch queue and "
                    "the declared scheduler steps may harvest"))
        if leaf == "cancel" and "." in callee:
            if (rel, qual) not in CANCEL_PERFORMERS:
                findings.append(Finding(
                    "protocol", "cancel-performer", f"{rel}:{lineno}",
                    f"{callee}() in {qual} — only HedgePair.settle may "
                    "cancel a hedge leg; a rogue cancel site can cancel "
                    "both legs (never booked) or cancel after booking"))
        if leaf == "abandon" and "." in callee:
            if (rel, qual) not in ABANDON_PERFORMERS:
                findings.append(Finding(
                    "protocol", "abandon-performer", f"{rel}:{lineno}",
                    f"{callee}() in {qual} — only TopologyBackend."
                    "kill_host may abandon a queue; anywhere else drops "
                    "in-flight work without re-dispatch bookkeeping"))

    # pending_by_bucket(exclude=...) — never re-dispatch in-flight work
    for qual, fn in astutil.iter_functions(tree):
        for lineno, callee, node in astutil.calls_in(fn):
            if _last(callee) != "pending_by_bucket":
                continue
            has_exclude = any(kw.arg == "exclude" for kw in node.keywords) \
                or len(node.args) >= 1
            if not has_exclude and (rel, qual) not in PENDING_VIEW_EXEMPT:
                findings.append(Finding(
                    "protocol", "pending-view-excludes-in-flight",
                    f"{rel}:{lineno}",
                    f"{qual} calls pending_by_bucket() without "
                    "exclude= — dispatched-but-unharvested invocations "
                    "would be dispatched twice"))

    # mark_running must precede dispatch_bucket in the same function
    if rel in _LEDGER_LAYER:
        for qual, fn in astutil.iter_functions(tree):
            if (rel, qual) in DISPATCH_WRAPPERS:
                continue
            cs = astutil.calls_in(fn)
            dispatches = [ln for ln, c, _ in cs
                          if _last(c) in _DISPATCH_CALLS]
            if not dispatches:
                continue
            marks = [ln for ln, c, _ in cs if _last(c) == "mark_running"]
            for ln in dispatches:
                if not any(m < ln for m in marks):
                    findings.append(Finding(
                        "protocol", "mark-before-dispatch",
                        f"{rel}:{ln}",
                        f"{qual} dispatches a bucket without first "
                        "mark_running() its invocations — a checkpoint "
                        "taken mid-flight would not re-queue them"))

    # identity-equality dataclasses
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if IDENTITY_DATACLASSES.get(node.name) != rel:
            continue
        ok = False
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and \
                    astutil.call_name(dec) is not None and \
                    _last(astutil.call_name(dec)) == "dataclass":
                for kw in dec.keywords:
                    if kw.arg == "eq" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is False:
                        ok = True
        if not ok:
            findings.append(Finding(
                "protocol", "identity-equality", f"{rel}:{node.lineno}",
                f"{node.name} must be @dataclass(eq=False): a generated "
                "__eq__ compares in-flight tensors elementwise and "
                "raises when two pending buckets share a key"))

    # ledger.py: transition methods exist, save() is atomic
    if rel == "serverless/ledger.py":
        methods = {q.rsplit(".", 1)[-1]
                   for q, _ in astutil.iter_functions(tree)
                   if q.startswith("TaskLedger.")}
        for name in LEDGER_TRANSITIONS:
            if name not in methods:
                findings.append(Finding(
                    "protocol", "transition-table-drift", rel,
                    f"LEDGER_TRANSITIONS names TaskLedger.{name} but the "
                    "method does not exist — update the table with the "
                    "rename"))
        for qual, fn in astutil.iter_functions(tree):
            if qual != "TaskLedger.save":
                continue
            if not any(_last(c) == "replace" and c.startswith("os.")
                       for _, c, _ in astutil.calls_in(fn)):
                findings.append(Finding(
                    "protocol", "atomic-ledger-save",
                    f"{rel}:{fn.lineno}",
                    "TaskLedger.save must write tmp + os.replace — a "
                    "crash mid-write must never corrupt the ledger"))
    return findings


def run(root: Optional[Path] = None) -> List[Finding]:
    """Statically check every audited file against the protocol table."""
    root = root or astutil.default_root()
    findings: List[Finding] = []
    for action, (srcs, dst) in BUCKET_TRANSITIONS.items():
        for s in srcs + (dst,):
            if s not in BUCKET_STATES:
                findings.append(Finding(
                    "protocol", "transition-table-drift",
                    "analysis/protocol.py",
                    f"BUCKET_TRANSITIONS[{action!r}] names state {s!r} "
                    "missing from BUCKET_STATES — update the table with "
                    "the rename"))
    for rel in AUDITED_FILES:
        path = root / rel
        if not path.exists():
            findings.append(Finding(
                "protocol", "missing-audited-file", rel,
                "audited file disappeared — update AUDITED_FILES with "
                "the move"))
            continue
        findings.extend(_check_file(rel, astutil.parse(path)))
    return findings
