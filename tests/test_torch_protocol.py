"""The async drain protocol of the port: the static pass clean on the
port's own tree, each seeded mutation caught, the runtime sanitizer
(``REPRO_SANITIZE``) armed at the reference's choke points, and the
protocol tables exactly the JAX package's.

The static pass is pure-AST: mutations are applied textually to a copy
of ``src/repro_torch`` in tmp_path, so nothing broken is ever imported.
"""
import shutil

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.analysis.protocol as jprotocol

from repro_torch.analysis import astutil, protocol
from repro_torch.compile import ProgramCache, dispatch_bucket, plan_buckets
from repro_torch.core import DMLData, DMLPlan, DMLSession
from repro_torch.core.session import compile_request
from repro_torch.data import make_plr_data
from repro_torch.serverless import PoolConfig, TopologyBackend
from repro_torch.serverless.dispatch import DispatchQueue, PendingBucket
from repro_torch.serverless.sanitize import (
    ProtocolError, check_booking, check_bucket_bookable, check_cancel,
    check_drained, check_hedge,
)

CPU = "cpu"


def _mutated_tree(tmp_path, rel, old, new):
    tmp = tmp_path / "repro_torch"
    shutil.copytree(astutil.default_root(), tmp)
    src = (tmp / rel).read_text()
    assert old in src, f"mutation anchor missing from {rel}"
    (tmp / rel).write_text(src.replace(old, new))
    return tmp


# ---------------------------------------------------------------------------
# the tables: exactly the reference's
# ---------------------------------------------------------------------------
def test_transition_tables_are_exactly_the_references():
    assert protocol.BUCKET_TRANSITIONS == jprotocol.BUCKET_TRANSITIONS
    assert protocol.INVOCATION_STATES == jprotocol.INVOCATION_STATES
    assert protocol.LEDGER_TRANSITIONS == jprotocol.LEDGER_TRANSITIONS
    assert protocol.BUCKET_STATES == jprotocol.BUCKET_STATES
    assert protocol.AUDITED_FILES == jprotocol.AUDITED_FILES
    assert protocol.CANCEL_PERFORMERS == jprotocol.CANCEL_PERFORMERS
    assert protocol.ABANDON_PERFORMERS == jprotocol.ABANDON_PERFORMERS
    assert protocol.PENDING_VIEW_EXEMPT == jprotocol.PENDING_VIEW_EXEMPT


def test_transition_table_matches_the_ports_ledger():
    """The table the sanitizer and the static checker share names real
    TaskLedger methods and the ledger module's state constants."""
    from repro_torch.serverless import ledger as L
    for name in protocol.LEDGER_TRANSITIONS:
        assert callable(getattr(L.TaskLedger, name))
    for sname, code in protocol.INVOCATION_STATES.items():
        assert getattr(L, sname) == code


def test_allowlists_name_functions_that_exist():
    """Every (file, qualname) of the performer allowlists is a function
    of the port's tree."""
    root = astutil.default_root()
    quals = {}
    for rel in protocol.AUDITED_FILES:
        quals[rel] = {q for q, _ in astutil.iter_functions(
            astutil.parse(root / rel))}
    for table in (protocol.BOOKING_PERFORMERS, protocol.HARVEST_PERFORMERS,
                  protocol.CANCEL_PERFORMERS, protocol.ABANDON_PERFORMERS,
                  protocol.PENDING_VIEW_EXEMPT, protocol.DISPATCH_WRAPPERS):
        for rel, qual in table:
            assert qual in quals[rel], (rel, qual)


# ---------------------------------------------------------------------------
# green: the port's tree is clean
# ---------------------------------------------------------------------------
def test_static_protocol_pass_clean_on_head():
    assert protocol.run() == []


# ---------------------------------------------------------------------------
# red: each seeded scheduler mutation is caught
# ---------------------------------------------------------------------------
_CHECKPOINT = "    def _checkpoint(self, state: DrainState):"

MUTATIONS = {
    "pending-view-excludes-in-flight": (
        "serverless/backends.py",
        "groups = state.plan.pending_by_bucket(\n"
        "            exclude=q.in_flight_entries())",
        "groups = state.plan.pending_by_bucket()"),
    "booking-performer": (
        "serverless/backends.py", _CHECKPOINT,
        _CHECKPOINT + "\n        state.requests[0].ledger.record_failure(0)"),
    "cancel-performer": (
        "serverless/backends.py", _CHECKPOINT,
        _CHECKPOINT + "\n        state.queue.cancel(state.queue._pending[0])"),
    "abandon-performer": (
        "serverless/backends.py", _CHECKPOINT,
        _CHECKPOINT + "\n        state.queue.abandon()"),
    "identity-equality": (
        "serverless/dispatch.py",
        "@dataclass(eq=False)\nclass PendingBucket:",
        "@dataclass\nclass PendingBucket:"),
    "mark-before-dispatch": (
        "serverless/topology.py",
        "                state.requests[ri].ledger.mark_running(invs)\n"
        "            decision = self._plan_host_axis(",
        "                pass\n"
        "            decision = self._plan_host_axis("),
}


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_seeded_mutation_fails_protocol_pass(tmp_path, rule):
    rel, old, new = MUTATIONS[rule]
    tmp = _mutated_tree(tmp_path, rel, old, new)
    assert rule in {f.rule for f in protocol.run(tmp)}


# ---------------------------------------------------------------------------
# the runtime sanitizer
# ---------------------------------------------------------------------------
def _dispatched_bucket():
    data = DMLData.from_dict(
        make_plr_data(n_obs=40, dim_x=3, theta=0.5, seed=0))
    plan = DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0},
                             n_folds=2, n_rep=1, seed=7)
    req = compile_request(plan, data)
    mp = plan_buckets([req])
    key, entries = next(iter(mp.pending_by_bucket().items()))
    return req, dispatch_bucket(mp, ProgramCache(), key, entries,
                                device=torch.device(CPU))


def test_sanitizer_trips_on_double_harvest(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    _, bd = _dispatched_bucket()
    bd.harvest()
    with pytest.raises(ProtocolError, match="harvested twice"):
        bd.harvest()


def test_sanitizer_off_double_harvest_still_refused(monkeypatch):
    """The reference lets a second harvest through with the sanitizer
    off; the port's always-on armed-once flag refuses it either way."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    _, bd = _dispatched_bucket()
    first = bd.harvest()
    assert first
    with pytest.raises(RuntimeError, match="already harvested"):
        bd.harvest()


def test_sanitizer_trips_on_booking_done_rows(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    req, bd = _dispatched_bucket()
    results = bd.harvest()
    invs = sorted({inv for _, inv in bd.entries})
    req.ledger.record_successes(
        invs, np.stack([results[(0, inv)] for inv in invs]))
    with pytest.raises(ProtocolError, match="record_successes"):
        check_booking(req.ledger, invs, "record_successes")


def test_sanitizer_trips_on_lost_bucket(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")

    class _State:
        queue = DispatchQueue()
        queues = {1: DispatchQueue()}

    _, bd = _dispatched_bucket()
    _State.queues[1]._pending.append(PendingBucket(dispatch=bd))
    with pytest.raises(ProtocolError, match="in\\s?flight"):
        check_drained(_State, "test retire")
    _State.queues[1]._pending.clear()
    check_drained(_State, "test retire")     # empty queues pass


def test_sanitizer_trips_on_double_hedge(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    _, bd = _dispatched_bucket()
    pb = PendingBucket(dispatch=bd)
    check_hedge(pb)                          # DISPATCHED: legal
    pb.state = "HEDGED"
    with pytest.raises(ProtocolError, match="hedge .* HEDGED"):
        check_hedge(pb)


def test_sanitizer_trips_on_booking_cancelled_bucket(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    _, bd = _dispatched_bucket()
    pb = PendingBucket(dispatch=bd)
    check_bucket_bookable(pb)                # DISPATCHED: legal
    check_cancel(pb)
    pb.state = "CANCELLED"
    with pytest.raises(ProtocolError, match="harvest .* CANCELLED"):
        check_bucket_bookable(pb)
    with pytest.raises(ProtocolError, match="cancel .* CANCELLED"):
        check_cancel(pb)


def test_sanitizer_reads_the_environment_per_call(monkeypatch):
    from repro_torch.serverless import sanitize
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize.enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize.enabled()


@pytest.mark.parametrize("backend", ["wave", "inline", "topology"])
def test_armed_sanitizer_passes_correct_drains(monkeypatch, backend):
    """Correct code is unaffected: chaos drains (failures, stragglers,
    held tails and hedges) and a host loss run clean with every check
    armed, bit for bit the fault-free inline drain."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    data = DMLData.from_dict(make_plr_data(n_obs=90, dim_x=4, seed=5))
    plan = DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0}, n_folds=3,
                             n_rep=4, seed=6)
    pool = PoolConfig(n_workers=1, memory_mb=256, n_hosts=2,
                      failure_rate=0.3, straggler_rate=0.3,
                      straggler_hold_s=0.02, hedge_after_s=0.002,
                      max_retries=10, seed=1)
    sess = DMLSession(backend=backend, pool=pool, device=CPU)
    rid = sess.submit(plan, data)
    if backend == "topology":
        killed = 0
        for _ in range(100):
            sess.poll()
            q = sess._state.queues.get(0) if sess._state else None
            if q is not None and q.in_flight:
                killed = sess.backend.kill_host(sess._state, 0)
                break
        assert killed > 0
    sess.run()
    clean = DMLSession(backend="inline", device=CPU)
    want = clean.request(clean.estimate(plan, data).request_id)
    np.testing.assert_array_equal(sess.request(rid).gathered_preds(),
                                  want.gathered_preds())


def test_kill_host_is_the_abandon_site():
    """Only the topology backend's host loss abandons a queue: its
    orphans are LOST, counted, and re-dispatched."""
    backend = TopologyBackend(PoolConfig(n_hosts=2), device=CPU)
    state = backend.begin_drain()
    _, bd = _dispatched_bucket()
    pb = PendingBucket(dispatch=bd, host=0)
    state.queues[0]._pending.append(pb)
    assert backend.kill_host(state, 0) == 1
    assert pb.state == "LOST" and 0 not in state.queues
    assert state.info.dispatch.lost == 1
    assert state.info.topology.lost_buckets == 1
    assert backend.kill_host(state, 0) == 0          # dead stays dead
