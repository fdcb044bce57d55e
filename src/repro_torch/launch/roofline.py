"""Roofline pricing: megabatch buckets and their parallelization axes (the
DML half), and the LM models' step terms (the LM half).

The DML half of the JAX package's ``launch/roofline.py``: analytic
operations and bytes of one task lane, the launch overhead, and the
per-bucket axis candidates the planner (compile/buckets.py) picks from.
Pure arithmetic on shapes — no device access — except
``measure_launch_overhead_s``, which times the device it is given, and
``measure_shard_overhead_frac``, which times a launch spread over the
mesh it is given.

The LM half (``ProbePlan``, ``probe_plan``, ``solve_extrapolation``,
``analytic_extra_flops``, ``model_flops``, ``RooflineTerms``) is the
reference's, retargeted to the port's configs: the dry run
(``launch/dryrun.py``) counts a step's operations and bytes at two or
three small depths and extrapolates the layer stacks linearly to the full
depth; ``model_flops`` is the useful work of a step (6 N tokens to train,
2 N to prefill), the numerator of the model-FLOPs share (MFU).  The
reference's HLO-text parser of collective bytes has no counterpart: a
PyTorch trace has no HLO; the mesh collectives
(sharding/collectives.py) are counted in ``runtime.launch_counts``.

Hardware model: one NVIDIA H100 SXM (data sheet): 67 TFLOP/s plain float32
(the estimator's kernels use plain FMA, no tensor cores), 989 TFLOP/s
dense bf16 on the tensor cores (the LM models' products), 3.35 TB/s HBM3,
NVLink 450 GB/s each way to every other card of the host.

  compute term = operations / PEAK_FLOPS (estimator), / PEAK_BF16_FLOPS (LM)
  memory term  = bytes / HBM_BW
  wire term    = collective bytes / NVLINK_BW
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.runtime import DeviceLike, resolve_device

PEAK_FLOPS = 67e12           # NVIDIA H100 SXM, plain float32 FLOP/s
HBM_BW = 3.35e12             # NVIDIA H100 SXM, HBM3 bytes/s
NVLINK_BW = 450e9            # NVIDIA H100 SXM, NVLink bytes/s each way
PEAK_BF16_FLOPS = 989e12     # NVIDIA H100 SXM, dense bf16 tensor-core FLOP/s


# ---------------------------------------------------------------------------
# Megabatch bucket pricing
# ---------------------------------------------------------------------------
def megabatch_task_flops(learner: str, n: int, p: int,
                         params: Dict = None) -> float:
    """Analytic FLOPs of ONE task lane of a megabatch bucket launch at
    the bucket's padded (n, p) (multiply-add = 2 FLOPs), per learner
    family.  Padded rows and columns do real arithmetic, so the estimate
    is taken at the padded shape.  Fidelity to ~2x is plenty: ranking
    candidates only needs relative scale."""
    params = dict(params or ())
    gram = 2.0 * n * p * p               # X^T W X
    solve = (2.0 / 3.0) * p ** 3         # cholesky-ish SPD solve
    predict = 2.0 * n * p
    if learner in ("ridge", "ols"):
        return gram + solve + predict
    if learner == "lasso":               # FISTA: one gram, iterated grads
        n_iter = int(params.get("n_iter", 200))
        return gram + n_iter * (4.0 * p * p + 8.0 * p) + predict
    if learner == "logistic":            # IRLS: gram + solve per newton step
        n_iter = int(params.get("n_iter", 32))
        return n_iter * (gram + solve + 4.0 * n * p) + predict
    if learner == "kernel_ridge":        # m landmarks: K_nm, K_mm, solve
        m = int(params.get("n_landmarks", 128))
        return (2.0 * n * m * p + 2.0 * m * m * p
                + (2.0 / 3.0) * m ** 3 + 2.0 * n * m)
    if learner == "mlp":                 # fwd+bwd per step over the widths
        hidden = tuple(params.get("hidden", (64, 64)))
        n_steps = int(params.get("n_steps", 300))
        dims = (p,) + hidden + (1,)
        per_row = sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
        return n_steps * 6.0 * n * per_row + 2.0 * n * per_row
    return gram + solve + predict        # unknown family: linear-ish guess


def megabatch_task_bytes(n: int, p: int) -> float:
    """Device-memory bytes one task lane moves per launch: its feature
    page plus the y/w/valid rows in, the prediction row out (f32)."""
    return 4.0 * (n * p + 4.0 * n)


# Host-side cost of one program launch.  This constant is the FALLBACK
# (the JAX package's serving-host figure, kept so that an unmeasured
# process prices as the reference does); ``measure_launch_overhead_s``
# replaces it with a measurement on the device a session runs on.
LAUNCH_OVERHEAD_S = 3e-4

# device -> measured seconds; the most recent measurement prices
_MEASURED_LAUNCH_OVERHEAD_S: Dict[torch.device, float] = {}
_LAST_MEASURED_S: Optional[float] = None


def launch_overhead_s() -> float:
    """Host dispatch cost of one launch: the latest session measurement
    when one has been taken, else the fallback constant."""
    if _LAST_MEASURED_S is not None:
        return _LAST_MEASURED_S
    return LAUNCH_OVERHEAD_S


def measure_launch_overhead_s(device: DeviceLike = "cuda",
                              repeats: int = 30) -> float:
    """Time a no-op launch plus a synchronise on ``device``: one warm-up,
    then the median of ``repeats`` calls, clamped to 10 us .. 10 ms.
    Memoized per device; the value becomes what ``launch_overhead_s``
    returns.  A device that cannot be reached raises."""
    global _LAST_MEASURED_S
    dev = resolve_device(device)
    measured = _MEASURED_LAUNCH_OVERHEAD_S.get(dev)
    if measured is None:
        x = torch.zeros((8,), dtype=torch.float32, device=dev)

        def once() -> None:
            x.add(1.0)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        once()                                  # first launch: set-up
        samples = []
        for _ in range(max(int(repeats), 3)):
            t0 = time.perf_counter()
            once()
            samples.append(time.perf_counter() - t0)
        measured = min(max(statistics.median(samples), 1e-5), 1e-2)
        _MEASURED_LAUNCH_OVERHEAD_S[dev] = measured
    _LAST_MEASURED_S = measured
    return measured


def invocation_roofline_s(learner: str, params, tasks_per_invocation: int,
                          n_pad: int, p_pad: int, *,
                          amortized_launches: float = 0.0) -> float:
    """Roofline lower bound on one invocation's duration: max of the
    compute and memory terms over its task lanes, plus its share
    (``amortized_launches``) of the launch overhead."""
    t = max(int(tasks_per_invocation), 1)
    flops = t * megabatch_task_flops(learner, n_pad, p_pad, params)
    byts = t * megabatch_task_bytes(n_pad, p_pad)
    return max(flops / PEAK_FLOPS, byts / HBM_BW) \
        + amortized_launches * launch_overhead_s()


# Hedge-deadline shape (the reference's formula, priced at this card's
# rates): a bucket is declared overdue — and a duplicate dispatch raced
# against it — once its in-flight age exceeds FACTOR x the roofline
# estimate of the whole slice, floored so that sub-millisecond serving
# buckets are not hedged on scheduler jitter.
HEDGE_DEADLINE_FACTOR = 4.0
HEDGE_DEADLINE_FLOOR_S = 0.05


def bucket_deadline_s(learner: str, params, tasks_per_invocation: int,
                      n_pad: int, p_pad: int, n_entries: int,
                      n_workers: int = 1) -> float:
    """Roofline-derived hedge deadline for one dispatched bucket slice:
    FACTOR x the estimated wall of its ``n_entries`` invocations over
    ``n_workers`` lanes (plus one launch overhead), floored.  Backends
    cap this by ``PoolConfig.timeout_s``."""
    per_inv = invocation_roofline_s(learner, params, tasks_per_invocation,
                                    n_pad, p_pad)
    lanes = max(int(n_workers), 1)
    waves = -(-max(int(n_entries), 1) // lanes)      # ceil division
    est = waves * per_inv + launch_overhead_s()
    return max(HEDGE_DEADLINE_FACTOR * est, HEDGE_DEADLINE_FLOOR_S)


# ---------------------------------------------------------------------------
# Parallelization-axis pricing (the per-bucket axis planner)
# ---------------------------------------------------------------------------
# Rows of one device-resident feature page: a bucket whose N_pad exceeds
# this cannot run the one-page task layout and streams N-chunks through
# the blocked Gram kernel (kernels/ops.py::batched_gram_blocked).  The
# value is the TPU's layout threshold, inherited from the JAX package so
# that the planner takes the reference's decisions; it is not a memory
# limit of the H100 (a 65536-row page of 33 float32 columns is 8.65 MB of
# its 80 GB).
DEVICE_PAGE_ROWS = 1 << 16

# Dispatch tax of an m-way launch relative to the single-device program,
# as a fraction of one launch overhead per extra shard.  This constant is
# the FALLBACK an unmeasured process prices with (the JAX package's);
# ``measure_shard_overhead_frac`` replaces it with a measurement on the
# mesh a session runs on.
SHARD_OVERHEAD_FRAC = 0.15

# (device kind, collective, shards) -> measured fraction; the most recent
# measurement prices
_MEASURED_SHARD_OVERHEAD_FRAC: Dict[Tuple[str, str, int], float] = {}
_LAST_SHARD_OVERHEAD_FRAC: Optional[float] = None


def shard_overhead_frac() -> float:
    """Per-extra-shard dispatch tax (fraction of one launch overhead):
    the latest session measurement when one has been taken, else the
    fallback constant."""
    if _LAST_SHARD_OVERHEAD_FRAC is not None:
        return _LAST_SHARD_OVERHEAD_FRAC
    return SHARD_OVERHEAD_FRAC


def measure_shard_overhead_frac(mesh, repeats: int = 20) -> float:
    """Measure the dispatch tax of a launch spread over ``mesh``: a no-op
    (``x + 1``) plain on the lead device against the same no-op through
    ``sharding/collectives.py::shard_map`` over the mesh's shards (split,
    one launch a shard, the gather), each warm, the median of
    ``repeats`` calls ending in a synchronise.  The extra time, as a
    fraction of one plain launch per extra shard — the ``launch_cost``
    model ``axis_candidate_costs`` charges; a one-shard mesh measures
    the wrapper's own tax as one extra shard — clamped to [0.02, 2.0].
    Memoized per (device kind, collective, shard count); the value
    becomes what ``shard_overhead_frac`` returns.  A failed measurement
    raises; the probe's own collectives are not left in
    ``runtime.launch_counts``."""
    global _LAST_SHARD_OVERHEAD_FRAC
    from repro_torch import runtime
    from repro_torch.sharding.collectives import shard_map
    dev = mesh.device
    m = len(mesh.shard_devices)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    memo = (kind, mesh.collective, m)
    frac = _MEASURED_SHARD_OVERHEAD_FRAC.get(memo)
    if frac is None:
        x = torch.zeros((8 * m,), dtype=torch.float32, device=dev)
        plain = lambda t: t + 1.0                       # noqa: E731
        sharded = shard_map(plain, mesh, (0,), 0)

        def median_s(fn) -> float:
            def once():
                fn(x)
                for d in set(mesh.devices):
                    if d.type == "cuda":
                        torch.cuda.synchronize(d)
            once()                              # first launch: set-up
            samples = []
            for _ in range(max(int(repeats), 3)):
                t0 = time.perf_counter()
                once()
                samples.append(time.perf_counter() - t0)
            return statistics.median(samples)

        counts = dict(runtime.launch_counts)
        try:
            t_plain = max(median_s(plain), 1e-7)
            t_sharded = median_s(sharded)
        finally:
            runtime.launch_counts.update(counts)
        extra = max(t_sharded - t_plain, 0.0)
        frac = min(max(extra / (t_plain * max(m - 1, 1)), 0.02), 2.0)
        _MEASURED_SHARD_OVERHEAD_FRAC[memo] = frac
    _LAST_SHARD_OVERHEAD_FRAC = frac
    return frac


#: families whose fit is a pure function of (X'X, X'y): the data-parallel
#: blocked-Gram axis rebuilds their exact statistics from partial sums,
#: and the feature axis can split their coordinate updates.  Everything
#: else prices only the task axis.
GRAM_FAMILIES = ("ols", "ridge", "lasso")


def chunked_gram_flops(n: int, p: int, chunk_rows: int) -> float:
    """FLOPs of accumulating X'X / X'y over ceil(n/chunk) N-chunks: the
    unblocked Gram's 2np^2 + 2np plus one (p, p) accumulator add per
    extra chunk."""
    n_chunks = max(int(np.ceil(n / max(int(chunk_rows), 1))), 1)
    return 2.0 * n * p * p + 2.0 * n * p + (n_chunks - 1) * float(p) * p


def _solve_flops(learner: str, n: int, p: int, params: Dict) -> float:
    """The non-Gram remainder of a Gram-family fit: what data-parallel
    sharding cannot split (it runs replicated on the reduced moments)."""
    gram = 2.0 * n * p * p
    total = megabatch_task_flops(learner, n, p, params)
    return max(total - gram, 0.0)


def axis_candidate_costs(learner: str, params, n_tasks: int, n_pad: int,
                         p_pad: int, n_devices: int,
                         ) -> List[Tuple[str, int, float, bool]]:
    """Price every parallelization-axis candidate for one bucket.

    Returns ``[(axis, shards, est_s, executable), ...]``: the roofline
    wall-clock of draining ``n_tasks`` tasks of padded shape
    (n_pad, p_pad) on an ``n_devices`` mesh under each layout —
    ``task`` (whole tasks per shard, no collectives), ``data`` (partial
    Grams over N/m rows through the blocked kernel, a sum of the (P, P)
    statistics, a replicated solve; the only layout for a bucket whose
    N_pad exceeds DEVICE_PAGE_ROWS) and ``feature`` (P/m columns per
    shard, gathered coefficients).  ``executable`` marks what the launch
    layer can run.  On one device the candidates are task@1 and, for the
    Gram families, the chunk-streamed data@1 rescue, executable exactly
    when the task layout is not.
    """
    params = dict(params or ())
    b = max(int(n_tasks), 1)
    m = max(int(n_devices), 1)
    lo = launch_overhead_s()
    f1 = megabatch_task_flops(learner, n_pad, p_pad, params)
    by1 = megabatch_task_bytes(n_pad, p_pad)
    gram_ok = learner in GRAM_FAMILIES
    fits_page = n_pad <= DEVICE_PAGE_ROWS

    frac = shard_overhead_frac()

    def launch_cost(shards: int) -> float:
        return lo * (1.0 + frac * (shards - 1))

    out: List[Tuple[str, int, float, bool]] = []
    # ---- task axis: ceil(b/m) whole tasks per shard, no collectives
    for shards in sorted({1, m}):
        per_dev = float(int(np.ceil(b / shards)))
        est = max(per_dev * f1 / PEAK_FLOPS, per_dev * by1 / HBM_BW) \
            + launch_cost(shards)
        out.append(("task", shards, est, fits_page))
    if m == 1:
        # chunk-streamed data@1: the page-overflow rescue, priced with
        # one shard's dispatch tax and executable only when the task
        # layout is not (a fitting page always takes the untaxed task
        # program)
        if gram_ok:
            gram_dev = b * chunked_gram_flops(n_pad, p_pad,
                                              DEVICE_PAGE_ROWS)
            tail = b * _solve_flops(learner, n_pad, p_pad, params)
            est = max((gram_dev + tail) / PEAK_FLOPS, by1 * b / HBM_BW) \
                + lo * (1.0 + frac)
            out.append(("data", 1, est, not fits_page))
        return out

    # ---- data axis: blocked-Gram partials over N/m rows + sum of P^2
    if gram_ok or learner == "logistic":
        chunk = max(int(np.ceil(n_pad / m)), 1)
        gram_dev = b * chunked_gram_flops(n_pad, p_pad, chunk) / m
        tail = b * _solve_flops(learner, n_pad, p_pad, params)
        psum_rounds = 1.0 if learner != "logistic" \
            else float(params.get("n_iter", 32))
        psum_bytes = b * (p_pad * p_pad + p_pad) * 4.0 * psum_rounds
        coll = psum_bytes * 2.0 * (m - 1) / m / NVLINK_BW
        est = max((gram_dev + tail) / PEAK_FLOPS, by1 * b / m / HBM_BW) \
            + coll + launch_cost(m)
        out.append(("data", m, est, gram_ok))
    else:
        # no analytic data-parallel decomposition for this family
        out.append(("data", m, float("inf"), False))

    # ---- feature axis: P/m columns per shard + coefficient gathers
    if gram_ok:
        sweeps = float(params.get("n_iter", 200)) \
            if learner == "lasso" else 1.0
        gather_bytes = b * (n_pad * p_pad / m + sweeps * p_pad) * 4.0
        coll = gather_bytes * (m - 1) / m / NVLINK_BW
        est = max(f1 * b / m / PEAK_FLOPS, by1 * b / m / HBM_BW) \
            + coll + launch_cost(m)
        out.append(("feature", m, est, fits_page))
    else:
        out.append(("feature", m, float("inf"), False))
    return out


# ---------------------------------------------------------------------------
# The LM half: probe configs (layer-stack trip counts per family), their
# extrapolation, the analytic terms, and the step's roofline terms
# ---------------------------------------------------------------------------
@dataclass
class ProbePlan:
    """probes[i] = (cfg_variant, trips vector a_i); full_trips for the real
    config.  cost_full = c0 + full_trips . c  with [c0, c] solved from probes.
    """
    probes: List[Tuple[ArchConfig, Tuple[float, ...]]]
    full_trips: Tuple[float, ...]


def probe_plan(cfg: ArchConfig) -> ProbePlan:
    fam = cfg.family
    if fam in ("dense", "moe"):
        head = cfg.moe.first_dense_layers if fam == "moe" else 0
        full = cfg.n_layers - head
        return ProbePlan(
            probes=[(replace(cfg, n_layers=head + 1), (1.0,)),
                    (replace(cfg, n_layers=head + 2), (2.0,))],
            full_trips=(float(full),))
    if fam == "ssm":                      # xlstm: groups of slstm_every
        per = cfg.ssm.slstm_every or cfg.n_layers
        return ProbePlan(
            probes=[(replace(cfg, n_layers=per), (1.0,)),
                    (replace(cfg, n_layers=2 * per), (2.0,))],
            full_trips=(float(cfg.n_layers // per),))
    if fam == "hybrid":                   # groups of 6 + mamba tail
        per = cfg.shared_attn_every
        return ProbePlan(
            probes=[(replace(cfg, n_layers=per), (1.0, 0.0)),
                    (replace(cfg, n_layers=2 * per), (2.0, 0.0)),
                    (replace(cfg, n_layers=per + 1), (1.0, 1.0))],
            full_trips=(float(cfg.n_layers // per),
                        float(cfg.n_layers % per)))
    if fam == "audio":                    # encoder / decoder stacks
        return ProbePlan(
            probes=[(replace(cfg, n_encoder_layers=1, n_layers=1), (1.0, 1.0)),
                    (replace(cfg, n_encoder_layers=2, n_layers=1), (2.0, 1.0)),
                    (replace(cfg, n_encoder_layers=1, n_layers=2), (1.0, 2.0))],
            full_trips=(float(cfg.n_encoder_layers), float(cfg.n_layers)))
    if fam == "vlm":                      # groups of cross_attn_every
        per = cfg.cross_attn_every
        return ProbePlan(
            probes=[(replace(cfg, n_layers=per), (1.0,)),
                    (replace(cfg, n_layers=2 * per), (2.0,))],
            full_trips=(float(cfg.n_layers // per),))
    raise KeyError(fam)


def solve_extrapolation(plan: ProbePlan,
                        probe_costs: List[Dict[str, float]]) -> Dict[str, float]:
    """Least-squares solve of cost = c0 + trips . c per metric key."""
    keys = set()
    for c in probe_costs:
        keys.update(c)
    a = np.array([[1.0, *trips] for _, trips in plan.probes])
    out = {}
    for k in keys:
        b = np.array([c.get(k, 0.0) for c in probe_costs])
        coef, *_ = np.linalg.lstsq(a, b, rcond=None)
        full = coef[0] + float(np.dot(coef[1:], np.array(plan.full_trips)))
        out[k] = max(full, 0.0)
    return out


def analytic_extra_flops(cfg: ArchConfig, shape: ShapeConfig,
                         n_devices: int) -> float:
    """Per-device FLOPs the trace leaves out: the sLSTM's time loop, which
    the dry run steps once, not once a token (the reference's rolled
    scan, which its cost analysis counts once)."""
    if cfg.family != "ssm" or not (cfg.ssm and cfg.ssm.slstm_every):
        return 0.0
    n_slstm = cfg.n_layers // cfg.ssm.slstm_every
    d = cfg.d_model
    nh = cfg.attention.n_heads
    hd = d // nh
    steps = 1 if shape.kind == "decode" else shape.seq_len
    per_step = 2 * nh * hd * 4 * hd + 40 * d      # R matmul + gate flops
    total = n_slstm * steps * shape.global_batch * per_step
    if shape.kind == "train":
        total *= 3.0                              # fwd + bwd
    return total / n_devices


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Useful-model FLOPs for the whole step (all devices)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch    # one token per sequence


@dataclass
class RooflineTerms:
    """A step's roofline on ``n_devices`` cards: the compute term at the
    dense bf16 rate, the memory term at HBM3's, the wire term at
    NVLink's."""
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    n_devices: int
    model_flops_total: float
    coll_detail: Dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / PEAK_BF16_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap upper bound on step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_dev * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        denom = self.step_s * self.n_devices * PEAK_BF16_FLOPS
        return self.model_flops_total / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops_total": self.model_flops_total,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
            "coll_detail": self.coll_detail,
        }
