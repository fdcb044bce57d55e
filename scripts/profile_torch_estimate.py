#!/usr/bin/env python3
"""Where one estimation request — or one served burst of zamba2-7b or
deepseek-v2-lite-16b — spends its time on the card.

    python3 scripts/profile_torch_estimate.py
        [--config paper|tall|irm|quickstart|mlp|zamba2|deepseek|topology|
                  topology3]
        [--n-rep M] [--src DIR] [--out DIR]

Drives one of the port's paths through ``estimate`` — ``paper``: the
paper's configuration (PLR on the bonus data, K = 5, ridge, M 100) on the
inline backend; ``tall``: PLR on ``make_plr_data`` with 250 000 rows and
20 covariates (K = 5, ridge, M 10) on the sharded backend, whose bucket
streams through the blocked Gram kernel; ``irm``: the default IRM plan
(ridge, logistic propensity) on ``make_irm_data`` with 5000 rows and 20
covariates (K = 5, M 10) on the inline backend; ``quickstart``: the
README's plan (PLR on the bonus data, kernel_ridge with reg 1.0 and 256
landmarks, K = 5, M 100, seed 42, ``scaling="n_rep"``, the wave backend
with ``PoolConfig(n_workers=8, memory_mb=1024)``); ``mlp``: PLR on the
bonus data with the mlp learner's defaults (hidden (64, 64), 300 Adam
steps, lr 3e-3), K = 5, M 10, on the default (wave) backend — once to warm
the process up, then again under ``torch.profiler`` (CPU and CUDA
activities).  For ``quickstart`` and ``mlp`` the trace also records
shapes, and ``by_op`` gives the device time of each PyTorch operator by
its input shapes (the RBF products, ``eigh``, ``knm @ inv_sqrt``, the
Cholesky solve; mlp's products, GELU and its gradient, Adam's foreach
passes), beside the hand-written kernels' rows, and ``host_syncs`` the
runtime's synchronising calls.  Prints
one JSON object: the request's wall time on the host's clock (device
drained), the device's busy time summed over kernels and copies, its
idle share, the device time of its host-to-device copies, the device
time and launches by kernel name, and what the drain's scheduler did:
program launches, fused launches, the calls of each hand-written kernel
(``runtime.launch_counts``) and the page pool's uploads.  The backend is
made with its default ``PoolConfig``, so a tree's own defaults apply.  For
``irm`` it also traces one 32-lane logistic block alone (the IRLS
program at the request's bucket shape) and counts its launches.
``zamba2``: the full zamba2-7b (bf16 weights from a seed) serving one
burst at ``chip_smoke.py``'s serve shape (B 4, prompts of 2048 tokens, 16
generated): one warm ``Engine.generate``, then its prefill and its 15
decode steps traced apart, each with its wall time, device busy time, idle
share and launches, and the device time split into the flash-attention
kernel, the SSD-scan kernel, matrix products (cuBLAS/CUTLASS) and the
rest.  ``deepseek``: the same for the full deepseek-v2-lite-16b (bf16 weights
from a seed, the same burst), the device time also split by the MoE
layer's ranges: ``moe_dispatch`` (router, sort and capacity scatter,
combine) and ``moe_experts`` (the grouped expert products), with each
share of the busy time and the peak memory.
``topology``: the paper configuration on the topology backend
(``PoolConfig(n_hosts=2)``: simulated hosts, each on its own CUDA
stream).  ``topology3``: ``chip_smoke.py``'s steal drain — two paper
requests (seeds 42, 43) and a PLIV one (``make_pliv_data`` 5000 x 20, K
5, M 10) in one ``DMLSession`` on two hosts with host 0's pool holding
every page, so that host 1 steals — against the same with stealing off
(every wave on host 0's stream), warm, in turns (on, off, off, on), then
each traced once; for every traced drain the device time summed over
kernels and copies beside the union of their intervals on the card
(``overlapped_ms``: device time that ran while another stream's work
ran).  ``--src DIR`` imports ``repro_torch`` from ``DIR/src`` (default:
this checkout), so that a parent commit unpacked beside this one is
profiled by the same script, in turns in one call.  Needs a CUDA device;
exits non-zero without one.  ``--out`` also writes the Chrome trace
there.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _source_tree(argv) -> Path:
    """The tree named by ``--src`` (read before anything imports
    ``repro_torch``), put first on the path."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--src", default=str(ROOT))
    tree = Path(ap.parse_known_args(argv)[0].src).resolve()
    sys.path.insert(0, str(tree / "src"))
    return tree


TREE = _source_tree(sys.argv[1:])

import torch                                               # noqa: E402
from torch.profiler import (                                # noqa: E402
    ProfilerActivity, profile, record_function,
)

from repro_torch import runtime                            # noqa: E402
from repro_torch.core import DMLData, DMLPlan, estimate    # noqa: E402
from repro_torch.data import (                             # noqa: E402
    make_bonus_data, make_irm_data, make_plr_data,
)
from repro_torch.learners import get_batched_learner       # noqa: E402
from repro_torch.serverless import PoolConfig, make_backend  # noqa: E402

assert Path(runtime.__file__).resolve().is_relative_to(TREE)

# rows of the profiler's own work (CUPTI's buffers), not of the program
PROFILER_ROWS = ("Buffer Flush", "Activity Buffer Request")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "cublas", "sm90_", "gemv", "nvjet")
# the CUDA kernels of each LM kernel wrapper (csrc/lm.cu): K5 in bf16 and
# float32, K6's four launches.  flash_attention_kernel and ssd_scan_kernel
# are no longer in lm.cu: they are kept to profile trees from before their
# redesign in the same terms
KERNEL_NAMES = {
    "flash_attention": ("flash_attention_kernel", "flash_attention_tc_kernel",
                        "flash_attention_tf32_kernel"),
    "ssd_scan": ("ssd_scan_kernel", "ssd_scores_kernel", "ssd_states_kernel",
                 "ssd_pass_kernel", "ssd_out_kernel"),
}


def _device_rows(prof):
    """Device time and launches by kernel (and copy) name."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # operator rows ("aten::...") repeat the time of the kernels and
        # copies they launch, and the runtime's API rows ("cudaLaunchKernel",
        # one a launch) carry a little device time too: keep the device-side
        # rows only
        if dev_us > 0 and not ev.key.startswith(("aten::", "cuda")) \
                and ev.key not in PROFILER_ROWS:
            rows.append({"name": ev.key[:80], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def _op_rows(prof, top: int = 30):
    """Device time of each PyTorch operator by its input shapes: the
    kernels an operator launches itself (not those of the operators it
    calls), so the rows add up to the traced device time less the
    hand-written kernels' (launched through ctypes, outside any
    operator)."""
    rows = []
    for ev in prof.key_averages(group_by_input_shape=True):
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.key.startswith("aten::"):
            rows.append({"op": ev.key, "shapes": str(ev.input_shapes)[:120],
                         "calls": ev.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:top]


def _irls_block(data):
    """One 32-lane logistic block at the IRM bucket's shape (N 5000, P 20
    padded to 32, plus the intercept), warm, traced alone: the IRLS
    program's launches and device time."""
    gen = torch.Generator().manual_seed(0)
    n, p = data.x.shape
    xs = torch.zeros((32, n, 32))
    xs[:, :, :p] = torch.as_tensor(data.x)
    y = torch.as_tensor(data.d).expand(32, n).contiguous()
    w = (torch.rand((32, n), generator=gen) < 0.8).float()
    args = [a.cuda() for a in (xs, y, w, torch.ones((32, n)),
                               torch.zeros((32, 2), dtype=torch.int64))]
    fn = get_batched_learner("logistic", {"reg": 1.0})
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    return {"shape": [32, n, 33], "n_iter": 32, "wall_s": wall,
            "device_ms": sum(r["device_ms"] for r in rows),
            "launches": sum(r["calls"] for r in rows), "by_kernel": rows}


def _busy(rows, wall_s):
    busy_ms = sum(r["device_ms"] for r in rows)
    if not rows:
        return {"device_busy_ms": "not measured",
                "device_idle_share": "not measured"}
    split = {"flash_attention": 0.0, "ssd_scan": 0.0, "matmul": 0.0,
             "other": 0.0}
    for r in rows:
        name = r["name"].lower()
        kind = next((k for k, names in KERNEL_NAMES.items()
                     if any(n in name for n in names)), None)
        if kind is None:
            kind = "matmul" if any(m in name for m in GEMM_MARKS) \
                else "other"
        split[kind] += r["device_ms"]
    return {"wall_s": wall_s, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / 1e3 / wall_s,
            "device_launches": sum(r["calls"] for r in rows),
            "device_ms_by_kind": split, "by_kernel": rows[:25]}


def _stream_overlap(prof):
    """Device time of the trace's kernels and copies summed, and the
    length of the union of their intervals: their difference is time two
    streams' work ran at once."""
    ivs, streams = [], set()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ivs.append((ev.time_range.start, ev.time_range.end))
            streams.add(ev.device_resource_id)
    if not ivs:
        return {"overlapped_ms": "not measured"}
    total = sum(e - s for s, e in ivs)
    union, cur_s, cur_e = 0, None, None
    for s, e in sorted(ivs):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union += cur_e - cur_s
    return {"streams": len(streams), "device_sum_ms": total / 1e3,
            "device_union_ms": union / 1e3,
            "overlapped_ms": (total - union) / 1e3}


def _topology3(smi, out_dir):
    from repro_torch.compile import PagePool, plan_buckets
    from repro_torch.core import DMLSession
    from repro_torch.core.session import compile_request
    from repro_torch.data import make_pliv_data
    bonus = DMLData.from_dict(make_bonus_data())
    pliv = DMLData.from_dict(make_pliv_data(n_obs=5000, dim_x=20))
    paper = dict(learner="ridge", learner_params={"reg": 1.0}, n_folds=5,
                 n_rep=100, scaling="n_rep")
    jobs = [(DMLPlan.for_model("plr", seed=42, **paper), bonus),
            (DMLPlan.for_model("plr", seed=43, **paper), bonus),
            (DMLPlan.for_model("pliv", learner="ridge", n_folds=5,
                               n_rep=10), pliv)]
    sessions = {}
    for steal in (True, False):
        sess = DMLSession(backend="topology",
                          pool=PoolConfig(n_hosts=2, steal=steal))
        pool = sess.backend.topology.hosts[0].pool
        for plan, data in jobs:
            req = compile_request(plan, data)
            for key in plan_buckets([req]).buckets:
                pool._page(PagePool.page_key(req, key.n_pad, key.p_pad),
                           req, key.n_pad, key.p_pad)
        sessions["steal" if steal else "no_steal"] = sess

    def drain(sess):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for plan, data in jobs:
            sess.submit(plan, data)
        sess.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"card": smi, "tree": str(TREE), "config": "topology3"}
    for name, sess in sessions.items():         # cold: pages, programs
        out[f"{name}_cold_s"] = drain(sess)
    walls = {name: [] for name in sessions}
    for name in ("steal", "no_steal", "no_steal", "steal"):
        walls[name].append(drain(sessions[name]))
    out["warm_s"] = walls
    for name, sess in sessions.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = drain(sess)
        rows = _device_rows(prof)
        t = sess.topology_info
        out[name] = {**_busy(rows, traced), **_stream_overlap(prof),
                     "steals": t.steals,
                     "host_waves": [h.waves for h in t.hosts],
                     "dispatch": {h.host_id: h.dispatch.in_flight_peak
                                  for h in t.hosts}}
        out[name].pop("by_kernel", None)
        if out_dir:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(
                str(Path(out_dir) / f"topology3_{name}_trace.json"))
    return out


def _zamba2(smi, out_dir):
    """One warm burst of the full zamba2-7b, prefill and decode traced
    apart."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, init_tree
    from repro_torch.serving import Engine, grow_cache
    import numpy as np

    batch, prompt_len, n_gen = 4, 2048, 16
    cfg = get_arch("zamba2-7b")
    bundle = build_model(cfg)
    params = init_tree(bundle.decls,
                       torch.Generator(device="cuda").manual_seed(20241115),
                       "cuda")
    engine = Engine(bundle, params)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    warm = engine.generate({"tokens": tokens}, n_gen=n_gen)
    toks = torch.as_tensor(tokens, device="cuda")
    out = {"card": smi, "config": "zamba2", "arch": cfg.name,
           "batch": batch, "prompt_len": prompt_len, "n_gen": n_gen,
           "warm_generate": {"prefill_s": warm.prefill_s,
                             "decode_s": warm.decode_s,
                             "decode_tokens_per_s": warm.tokens_per_s}}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_p:
            t0 = time.perf_counter()
            logits, cache = bundle.prefill_fn(params, {"tokens": toks})
            cache = grow_cache(cfg, cache, n_gen)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_d:
            t0 = time.perf_counter()
            for _ in range(n_gen - 1):
                logits, cache = bundle.decode_fn(params, cache,
                                                 {"tokens": tok})
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
    out["prefill"] = _busy(_device_rows(prof_p), prefill_s)
    out["decode"] = _busy(_device_rows(prof_d), decode_s)
    out["decode"]["steps"] = n_gen - 1
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        prof_p.export_chrome_trace(str(Path(out_dir)
                                       / "zamba2_prefill_trace.json"))
        prof_d.export_chrome_trace(str(Path(out_dir)
                                       / "zamba2_decode_trace.json"))
    return out


@contextlib.contextmanager
def _moe_ranges():
    """Profiler ranges around the MoE layer's parts: ``moe_dispatch`` (the
    router, the sort and scatter into the capacity buffer, the combine)
    and ``moe_experts`` (the grouped expert products)."""
    from repro_torch.models import moe
    real = {name: getattr(moe, name) for name in (
        "_route", "_capacity_dispatch", "_combine", "_expert_mlp")}

    def ranged(fn, label):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call

    for name, fn in real.items():
        setattr(moe, name, ranged(fn, "moe_experts" if name == "_expert_mlp"
                                  else "moe_dispatch"))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)


MOE_RANGES = ("moe_dispatch", "moe_experts")


def _range_ms(prof, label):
    """Device time of the kernels launched inside the ranges ``label``
    (the host-side ranges' kernels; the device-side span of a range also
    counts the card's idle time inside it, and is not summed)."""
    us = sum(ev.device_time_total for ev in prof.events()
             if ev.name == label
             and ev.device_type == torch.autograd.DeviceType.CPU)
    return us / 1e3


def _deepseek(smi, out_dir):
    """One warm burst of the full deepseek-v2-lite-16b at chip_smoke.py's
    serve shape, prefill and decode traced apart, the MoE layer's dispatch
    and expert products as ranges."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, init_tree
    from repro_torch.serving import Engine, grow_cache
    import numpy as np

    batch, prompt_len, n_gen = 4, 2048, 16
    cfg = get_arch("deepseek-v2-lite-16b")
    bundle = build_model(cfg)
    params = init_tree(bundle.decls,
                       torch.Generator(device="cuda").manual_seed(20241115),
                       "cuda")
    engine = Engine(bundle, params)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    warm = engine.generate({"tokens": tokens}, n_gen=n_gen)
    toks = torch.as_tensor(tokens, device="cuda")
    out = {"card": smi, "config": "deepseek", "arch": cfg.name,
           "batch": batch, "prompt_len": prompt_len, "n_gen": n_gen,
           "warm_generate": {"prefill_s": warm.prefill_s,
                             "decode_s": warm.decode_s,
                             "decode_tokens_per_s": warm.tokens_per_s}}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), _moe_ranges():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_p:
            t0 = time.perf_counter()
            logits, cache = bundle.prefill_fn(params, {"tokens": toks})
            cache = grow_cache(cfg, cache, n_gen)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_d:
            t0 = time.perf_counter()
            for _ in range(n_gen - 1):
                logits, cache = bundle.decode_fn(params, cache,
                                                 {"tokens": tok})
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    for name, prof, wall in (("prefill", prof_p, prefill_s),
                             ("decode", prof_d, decode_s)):
        # the ranges' device-side rows span kernels already counted
        rows = [r for r in _device_rows(prof) if r["name"] not in MOE_RANGES]
        out[name] = _busy(rows, wall)
        busy = out[name]["device_busy_ms"]
        for label in MOE_RANGES:
            ms = _range_ms(prof, label)
            out[name][f"{label}_ms"] = ms
            out[name][f"{label}_share"] = ms / busy if busy else None
        k5 = out[name]["device_ms_by_kind"]["flash_attention"]
        out[name]["flash_attention_share"] = k5 / busy if busy else None
    out["decode"]["steps"] = n_gen - 1
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        prof_p.export_chrome_trace(str(Path(out_dir)
                                       / "deepseek_prefill_trace.json"))
        prof_d.export_chrome_trace(str(Path(out_dir)
                                       / "deepseek_decode_trace.json"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("paper", "tall", "irm",
                                         "quickstart", "mlp", "zamba2",
                                         "deepseek", "topology",
                                         "topology3"),
                    default="paper")
    ap.add_argument("--n-rep", type=int, default=None,
                    help="repetitions M (default: 100 paper, quickstart; "
                         "10 tall, irm, mlp)")
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the source tree whose repro_torch to run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_estimate: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.config == "zamba2":
        print(json.dumps(_zamba2(smi, args.out), indent=1))
        return 0
    if args.config == "deepseek":
        print(json.dumps(_deepseek(smi, args.out), indent=1))
        return 0
    if args.config == "topology3":
        print(json.dumps(_topology3(smi, args.out), indent=1))
        return 0
    model, learner, params, kw = "plr", "ridge", {"reg": 1.0}, {}
    if args.config in ("paper", "topology"):
        data = DMLData.from_dict(make_bonus_data())
        n_rep = args.n_rep or 100
        name = "inline" if args.config == "paper" else "topology"
    elif args.config == "tall":
        data = DMLData.from_dict(make_plr_data(n_obs=250_000, dim_x=20))
        n_rep, name = args.n_rep or 10, "sharded"
    elif args.config == "irm":
        data = DMLData.from_dict(make_irm_data(n_obs=5000, dim_x=20))
        n_rep, name, model = args.n_rep or 10, "inline", "irm"
    elif args.config == "quickstart":
        data = DMLData.from_dict(make_bonus_data())
        n_rep, name = args.n_rep or 100, "wave"
        learner, params = "kernel_ridge", {"reg": 1.0, "n_landmarks": 256}
        kw = dict(seed=42, scaling="n_rep",
                  pool=PoolConfig(n_workers=8, memory_mb=1024))
    else:
        data = DMLData.from_dict(make_bonus_data())
        n_rep, name, learner, params = args.n_rep or 10, "wave", "mlp", {}
        kw = dict(seed=42, scaling="n_rep")
    plan = DMLPlan.for_model(model, learner=learner, learner_params=params,
                             n_folds=5, n_rep=n_rep, backend=name, **kw)
    backend = make_backend(name, kw.get("pool"))
    by_shape = args.config in ("quickstart", "mlp")

    def request():
        t0 = time.perf_counter()
        res = estimate(plan, data, backend=backend)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    _, cold = request()
    _, warm = request()
    stats = backend.compiler.stats
    before = (stats.launches, getattr(stats, "fused_launches", 0))
    pages = getattr(backend, "pages", None)
    pages0 = pages.stats.snapshot() if pages is not None else None
    runtime.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_shape) as prof:
        res, traced = request()
    rows = _device_rows(prof)
    busy_ms = sum(r["device_ms"] for r in rows)
    out = {"card": smi, "tree": str(TREE), "config": args.config,
           "backend": name, "n_rep": n_rep, "theta": res.theta,
           "wall_cold_s": cold, "wall_warm_s": warm,
           "wall_traced_s": traced,
           "program_launches": stats.launches - before[0],
           "fused_launches": getattr(stats, "fused_launches", 0) - before[1],
           "kernel_calls": {k: v for k, v in runtime.launch_counts.items()
                            if v},
           "page_stats": pages.stats.delta(pages0).summary()
           if pages is not None else None}
    if rows:
        out.update(device_busy_ms=busy_ms,
                   device_idle_share=1.0 - busy_ms / 1e3 / traced,
                   device_launches=sum(r["calls"] for r in rows),
                   h2d_device_ms=sum(r["device_ms"] for r in rows
                                     if "HtoD" in r["name"]),
                   h2d_copies=sum(r["calls"] for r in rows
                                  if "HtoD" in r["name"]),
                   by_kernel=rows[:25])
    else:
        out.update(device_busy_ms="not measured",
                   device_idle_share="not measured",
                   note="the profiler recorded no device time")
    if args.config == "irm":
        out["irls_block"] = _irls_block(data)
    if by_shape and rows:
        out["by_op"] = _op_rows(prof)
        out["host_syncs"] = {
            ev.key: ev.count for ev in prof.key_averages()
            if "Synchronize" in ev.key or "cudaMemcpy" == ev.key}
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(Path(args.out) / f"estimate_{args.config}_trace.json"))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
