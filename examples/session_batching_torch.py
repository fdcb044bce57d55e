"""Multi-request serving on the PyTorch/CUDA port —
``examples/session_batching.py`` one for one, with ``repro_torch`` in
place of ``repro``: a DMLSession fusing concurrent estimations.

Several tenants submit estimation requests (different data, models, and
seeds); the session compiles them all onto ONE warm wave backend so their
task grids share dispatch waves — the batch-processing lever for serving
heavy traffic.  Compare the shared-wave count against running each request
back-to-back.

Run:  python examples/session_batching_torch.py [--device cuda|cpu]
(on a machine without a GPU it raises unless ``--device cpu`` is given)
"""
import argparse

try:
    import _bootstrap_torch  # noqa: F401  (run as a script from examples/)
except ModuleNotFoundError:          # imported as examples.<module>
    from examples import _bootstrap_torch  # noqa: F401

from repro_torch.core import DMLData, DMLPlan, DMLSession, estimate
from repro_torch.data import make_irm_data, make_plr_data
from repro_torch.runtime import resolve_device
from repro_torch.serverless import PoolConfig


def requests():
    return [
        (DMLPlan.for_model("plr", learner="ridge",
                           learner_params={"reg": 1.0},
                           n_folds=5, n_rep=4, seed=11),
         DMLData.from_dict(make_plr_data(n_obs=800, dim_x=12, theta=0.5,
                                         seed=1))),
        (DMLPlan.for_model("plr", learner="kernel_ridge",
                           learner_params={"reg": 1.0, "n_landmarks": 128},
                           n_folds=5, n_rep=4, seed=12),
         DMLData.from_dict(make_plr_data(n_obs=600, dim_x=8, theta=-0.3,
                                         seed=2))),
        (DMLPlan.for_model("irm", learner="ridge", n_folds=4, n_rep=4,
                           seed=13),
         DMLData.from_dict(make_irm_data(n_obs=700, dim_x=10, theta=0.4,
                                         seed=3))),
    ]


def run(device: str = "cuda"):
    """The requests, the session's ids, results and run info, and the
    solo runs' results (each request alone on the same capacity)."""
    device = resolve_device(device)
    reqs = requests()
    pool = PoolConfig(n_workers=4, memory_mb=1024)
    sess = DMLSession(backend="wave", pool=pool, device=device)
    ids = [sess.submit(plan, data) for plan, data in reqs]
    results = sess.run()
    solo = [estimate(plan.replace(pool=pool), data, device=device)
            for plan, data in reqs]
    return reqs, ids, results, sess.last_run_info, solo


def main(device: str = "cuda"):
    reqs, ids, results, info, solo = run(device)
    print(f"{len(reqs)} requests drained in {info.waves} waves "
          f"({info.shared_waves} carried 2+ requests)")
    for rid, (plan, data), res in zip(ids, reqs, results):
        s = res.report.summary()
        print(f"  request {rid} [{plan.model:>4}] theta={res.theta:+.4f} "
              f"(se {res.se:.4f}, true {data.theta0:+.2f})  "
              f"invocations={s['invocations']} billed={s['billed_gb_s']:.2f} GB-s")
    solo_waves = sum(res.report.waves for res in solo)
    print(f"\nsequential solo runs: {solo_waves} waves total "
          f"vs {info.waves} fused — shared waves amortize dispatch capacity")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
