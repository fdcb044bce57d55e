"""Host loss on the topology backend and durable, crash-resumable
sessions of the port, on the CPU.

The load-bearing property: a lost host or a crashed process changes the
SCHEDULE, never the estimate.  Every admitted request completes, DONE
invocations are never re-executed, and the predictions are bit for bit
those of a fault-free inline drain.  A durable session's request specs
are byte for byte the JAX package's (same msgpack payload), so a session
directory written by one package names the same requests to the other.
Inputs come from numpy with a seed.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.core as rcore
from repro.data import make_irm_data, make_plr_data

import repro_torch.core as tcore
from repro_torch.core import DMLSession
from repro_torch.core.session import compile_request
from repro_torch.serverless import InlineBackend, PoolConfig

SRC = str(Path(__file__).resolve().parent.parent / "src")
CPU = "cpu"

FAMILIES = [
    ("ridge", {"reg": 1.0}),
    ("ols", {}),
    ("lasso", {"reg": 0.01}),
    ("logistic", {"reg": 1.0}),
    ("kernel_ridge", {"reg": 1.0, "n_landmarks": 32}),
    ("mlp", {"hidden": (8,), "n_steps": 20}),
]


def _case(learner, params, seed=3, core=tcore):
    if learner == "logistic":
        data = core.DMLData.from_dict(make_irm_data(n_obs=130, dim_x=4,
                                                    theta=0.4, seed=seed))
        plan = core.DMLPlan.for_model("irm", learner="ridge", n_folds=3,
                                      n_rep=2, seed=seed + 100)
        return plan, data
    data = core.DMLData.from_dict(make_plr_data(n_obs=120, dim_x=5,
                                                theta=0.5, seed=seed))
    plan = core.DMLPlan.for_model("plr", learner=learner,
                                  learner_params=params, n_folds=3,
                                  n_rep=2, seed=seed + 100)
    return plan, data


def _inline_preds(plan, data):
    ref = compile_request(plan, data)
    InlineBackend(device=CPU).run_requests([ref])
    return ref.gathered_preds()


# ---------------------------------------------------------------------------
# host loss: kill a host mid-flight, the survivors finish everything
# ---------------------------------------------------------------------------
def test_topology_survives_host_loss_mid_flight():
    """Kill host 0 while its queue holds in-flight buckets: its pages
    are invalidated, its orphans re-route, and every admitted request
    still completes — bit for bit the fault-free inline path, for every
    learner family."""
    cases = [_case(learner, params, seed=3 + i)
             for i, (learner, params) in enumerate(FAMILIES)]
    sess = DMLSession(backend="topology",
                      pool=PoolConfig(n_workers=2, memory_mb=256,
                                      n_hosts=2), device=CPU)
    rids = [sess.submit(plan, data) for plan, data in cases]
    backend = sess.backend
    killed = False
    for _ in range(400):
        sess.poll()
        state = sess._state
        if state is None:
            break
        q = state.queues.get(0)
        if q is not None and q.in_flight > 0:
            assert backend.kill_host(state, 0) > 0
            killed = True
            break
    assert killed, "drain finished before any in-flight work on host 0"
    sess.run()
    t = sess.topology_info
    assert t.host_losses == 1
    assert t.lost_buckets > 0
    assert t.lost_buckets == sess.last_run_info.dispatch.lost
    for rid, (plan, data) in zip(rids, cases):
        assert sess.request(rid).ledger.complete
        np.testing.assert_array_equal(sess.request(rid).gathered_preds(),
                                      _inline_preds(plan, data))
    # the dead host's pool is empty and unreachable via the directory
    assert backend.topology.hosts[0].pool.n_pages == 0
    assert 0 not in backend.topology.directory._pools


def test_killed_host_never_rejoins():
    """Host death is permanent for the topology's lifetime: later drains
    route and steal over the survivors only."""
    sess = DMLSession(backend="topology",
                      pool=PoolConfig(n_workers=2, memory_mb=256,
                                      n_hosts=2), device=CPU)
    plan, data = _case("ridge", {"reg": 1.0})
    sess.submit(plan, data)
    sess.run()
    sess.backend.topology.kill(0)
    plan2, data2 = _case("ridge", {"reg": 1.0}, seed=9)
    rid = sess.submit(plan2, data2)
    sess.run()
    assert sess.request(rid).ledger.complete
    t = sess.topology_info
    assert t.hosts[0].waves == 0         # the corpse never stepped
    assert [h.host_id for h in sess.backend.topology.alive()] == [1]


# ---------------------------------------------------------------------------
# crash-resumable sessions, in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["wave", "topology"])
def test_durable_session_resumes_partial_drain(tmp_path, backend):
    """A durable session dropped mid-drain resumes in a fresh session
    object: DONE invocations never re-execute, and the thetas are bit
    for bit an uninterrupted run's."""
    plan, data = _case("ridge", {"reg": 1.0})
    sdir = str(tmp_path / "sess")
    pool = PoolConfig(n_workers=1, memory_mb=256, n_hosts=2)
    sess = DMLSession(backend=backend, pool=pool, device=CPU,
                      session_dir=sdir)
    sess.submit(plan, data)
    n_done = 0
    for _ in range(3):                   # partial drain, then "crash"
        sess.poll()
        if sess._queue and sess._queue[0].req is not None:
            n_done = sess._queue[0].req.ledger.n_done
    assert 0 < n_done
    del sess                             # the crash: nothing carried over
    assert sorted(os.listdir(sdir)) == ["ledger_00000.msgpack",
                                        "request_00000.msgpack"]

    resumed = DMLSession.resume(sdir, backend=backend, pool=pool,
                                device=CPU)
    res, = resumed.run()
    req = resumed.request(res.request_id)
    assert req.ledger.complete
    # only the not-DONE rows were re-executed in the resumed session
    assert res.report.bill.n_invocations == req.ledger.n_invocations - n_done
    ref = DMLSession(backend="inline", device=CPU).estimate(plan, data)
    np.testing.assert_array_equal(res.thetas, ref.thetas)
    assert res.theta == ref.theta


def test_resume_under_chaos_is_bitwise(tmp_path):
    """Crash-resume composed with fault injection: the resumed drain
    draws the SAME identity-keyed verdicts for the surviving rows (the
    checkpointed ledger carries the attempt counters), so the estimate
    is bit for bit the fault-free one."""
    plan, data = _case("ridge", {"reg": 1.0})
    pool = PoolConfig(n_workers=2, memory_mb=256, failure_rate=0.3,
                      max_retries=10, seed=2)
    sdir = str(tmp_path / "sess")
    sess = DMLSession(backend="wave", pool=pool, device=CPU,
                      session_dir=sdir)
    sess.submit(plan, data)
    for _ in range(2):
        sess.poll()
    del sess
    resumed = DMLSession.resume(sdir, backend="wave", pool=pool,
                                device=CPU)
    res, = resumed.run()
    np.testing.assert_array_equal(
        resumed.request(res.request_id).gathered_preds(),
        _inline_preds(plan, data))


@pytest.mark.parametrize("learner,params", FAMILIES[:3] + FAMILIES[4:5])
def test_request_spec_bytes_equal_the_references(tmp_path, learner, params):
    """The port's ``request_*.msgpack`` is byte for byte the reference's
    for the same (plan, data), and so is the ledger checkpoint written at
    admission (before any booking)."""
    files = []
    for side, core, kw in ((0, tcore, {"device": CPU}), (1, rcore, {})):
        plan, data = _case(learner, params, core=core)
        sdir = tmp_path / f"side{side}"
        sess = core.DMLSession(backend="inline", session_dir=str(sdir),
                               **kw)
        sess.submit(plan, data)
        sess._admit_queued()
        files.append({name: (sdir / name).read_bytes()
                      for name in sorted(os.listdir(sdir))})
    assert list(files[0]) == ["ledger_00000.msgpack", "request_00000.msgpack"]
    assert files[0] == files[1]


def test_resume_refuses_a_gap_in_the_request_ids(tmp_path):
    plan, data = _case("ridge", {"reg": 1.0})
    sdir = str(tmp_path / "sess")
    sess = DMLSession(backend="inline", device=CPU, session_dir=sdir)
    sess.submit(plan, data)
    sess.submit(plan, data)
    os.remove(os.path.join(sdir, "request_00000.msgpack"))
    with pytest.raises(RuntimeError, match="resume id drift"):
        DMLSession.resume(sdir, backend="inline", device=CPU)


# ---------------------------------------------------------------------------
# crash-resume across a real process boundary
# ---------------------------------------------------------------------------
# Three lasso PLR requests on one durable single-lane session.
_CASE = """
from repro_torch.core import DMLData, DMLPlan
from repro_torch.data import make_plr_data

SEEDS = (3, 4, 5)

def cases():
    for s in SEEDS:
        data = DMLData.from_dict(
            make_plr_data(n_obs=96, dim_x=5, theta=0.5, seed=s))
        plan = DMLPlan.for_model("plr", learner="lasso",
                                 learner_params={"reg": 0.01},
                                 n_folds=3, n_rep=3, seed=s + 4)
        yield plan, data
"""

# Child 1: submit all three, poll until the drain is mid-flight — at
# least one request COMPLETE, at least one not — then hard-crash via
# os._exit so no cleanup runs: only the atomic spec files and ledger
# checkpoints survive.
_CRASH = _CASE + """
import json, os, sys
from repro_torch.core import DMLSession
from repro_torch.serverless import PoolConfig

sess = DMLSession(backend="wave", pool=PoolConfig(n_workers=1),
                  device="cpu", session_dir=sys.argv[1])
for plan, data in cases():
    sess.submit(plan, data)
for _ in range(200):
    sess.poll()
    if sess.completion_order and sess._queue:
        break
assert sess.completion_order and sess._queue     # genuinely mid-flight
done = {p.request_id: p.req.ledger.n_done for p in sess._queue}
n_inv = {p.request_id: p.req.ledger.n_invocations for p in sess._queue}
for rid in sess.completion_order:
    led = sess.request(rid).ledger
    done[rid] = led.n_done
    n_inv[rid] = led.n_invocations
print(json.dumps({"done": done, "n_inv": n_inv,
                  "completed": sess.completion_order}), flush=True)
os._exit(0)      # the simulated crash: skip interpreter teardown entirely
"""

# Child 2: resume from the session dir in a cold process and finish the
# drain, reporting what it re-executed and what it computed.
_RESUME = _CASE + """
import json, sys
from repro_torch.core import DMLSession
from repro_torch.serverless import PoolConfig

sess = DMLSession.resume(sys.argv[1], backend="wave",
                         pool=PoolConfig(n_workers=1), device="cpu")
resumed_done = {p.request_id: p.ledger.n_done for p in sess._queue}
results = sess.run()
print(json.dumps({
    "resumed_done": resumed_done,
    "billed": {r.request_id: r.report.bill.n_invocations for r in results},
    "thetas": {r.request_id: [float(t) for t in r.thetas]
               for r in results},
}), flush=True)
"""


def _run_child(script, session_dir, sanitize=False):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_SANITIZE", None)
    if sanitize:
        env["REPRO_SANITIZE"] = "1"
    out = subprocess.run([sys.executable, "-c", script, str(session_dir)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_crash_mid_drain_resumes_bitwise(tmp_path):
    """Crash a durable drain mid-flight, resume in a new process under
    the runtime sanitizer: zero DONE invocations re-execute, and the
    thetas are bit for bit an uninterrupted in-process run's."""
    session_dir = tmp_path / "session"
    first = _run_child(_CRASH, session_dir)
    total_inv = sum(first["n_inv"].values())
    total_done = sum(first["done"].values())
    assert first["completed"]                       # some request finished
    assert 0 < total_done < total_inv               # ...and some did not
    for rid in ("0", "1", "2"):
        assert (session_dir / f"request_0000{rid}.msgpack").exists()
        assert (session_dir / f"ledger_0000{rid}.msgpack").exists()

    second = _run_child(_RESUME, session_dir, sanitize=True)
    # the checkpointed ledgers carried every completed row across the
    # crash — including the fully-DONE request, which resumes complete
    assert second["resumed_done"] == first["done"]
    # zero re-executed DONE invocations: the resumed drain bills exactly
    # the invocations the crash orphaned, request by request
    for rid, billed in second["billed"].items():
        assert billed == first["n_inv"][rid] - first["done"][rid]
    assert second["billed"][str(first["completed"][0])] == 0

    ns = {}
    exec(_CASE, ns)
    for rid, (plan, data) in enumerate(ns["cases"]()):
        ref = DMLSession(backend="inline", pool=PoolConfig(n_workers=2),
                         device=CPU).estimate(plan, data)
        np.testing.assert_array_equal(
            np.asarray(second["thetas"][str(rid)]),
            np.asarray([float(t) for t in ref.thetas]))
