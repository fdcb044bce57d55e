"""In-mesh executors for the non-task parallelization axes.

The axis planner (compile/buckets.py::plan_bucket_axis) prices three
layouts per bucket; this module supplies the two that split *inside* a
task, for the Gram families, whose fit is a pure function of the
(X'X, X'y) statistics:

``data``     shards the N axis over the mesh: each device accumulates a
             partial Gram over its rows, streamed as N-chunks through
             ``chunk_tall_n`` + ``batched_gram_blocked`` (the CUDA K3),
             and a sum over the mesh's "data" axis rebuilds the exact
             statistics.  The only layout that runs a bucket whose N
             exceeds one device page (launch/roofline.py::DEVICE_PAGE_ROWS).
``feature``  shards the P axis: each device owns P/m columns, gathers the
             rows it needs, and emits its column block of the Gram.

``axis_fit_program`` is the drain form: one bucket launch at the
ProgramCache signature ``run(pages, data_idx, y, w, valid, key_data) ->
preds (B, N_pad)``; the solve runs replicated on the rebuilt statistics
(``gram_solve`` for ridge/OLS, the FISTA moments form for lasso) and the
predictions come from ``batched_predict`` (the CUDA K2).

The mesh (launch/mesh.py) has m shards on "data": distinct cards (NCCL)
or one device repeated (simulated).  Each body is written as its stages
between the collectives of sharding/collectives.py (``mesh_sum``,
``mesh_gather``), each stage run on every shard in shard order, on the
shard's device; on one shard the collectives are the identity.  Results
agree with the task layout to float tolerance, not bitwise: the LU solve
and the chunked, per-shard order of summation differ from the task
path's Cholesky and single walk.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.analysis.registry import warm_cache
from repro_torch.runtime import bounded_put
from repro_torch.sharding.collectives import (
    mesh_gather, mesh_sum, on_device, on_shard,
)

F32 = torch.float32

#: in-mesh programs, one per (mesh, mesh_axis, family, params) — the
#: in-mesh analogue of the ProgramCache, bounded because meshes and
#: hyperparameter bindings churn across sessions
_DATA_GRAM_PROGRAMS: Dict[Tuple, Callable] = {}
_FEATURE_GRAM_PROGRAMS: Dict[Tuple, Callable] = {}
_GRAM_PROGRAM_CACHE_MAX = 64


def _chunk_rows(n_local: int, page_rows: int) -> int:
    """Chunk size for streaming ``n_local`` rows through fixed device
    pages: one chunk when the rows fit, else the balanced chunk size
    rounded up to a multiple of 8 (minimising the ragged tail that
    ``chunk_tall_n`` pads with w == 0 rows)."""
    if n_local <= page_rows:
        return n_local
    n_chunks = -(-n_local // page_rows)
    return min((-(-n_local // n_chunks) + 7) // 8 * 8, page_rows)


def gram_solve(g, b, live=None):
    """The ridge/OLS epilogue on rebuilt statistics: solve G beta = b per
    task with an LU factorisation (``torch.linalg.solve_ex``: no raise and
    no wait for the device).  A singular lane — a launch's padding lanes
    are, at reg 1 with an intercept — yields NaN coefficients; ``live``
    (B,) marks the lanes whose failure counts in
    ``learners.linear.solve_failures``."""
    from repro_torch.learners.linear import _note_solve_status
    sol, info = torch.linalg.solve_ex(g, b.unsqueeze(-1))
    _note_solve_status(info, live)
    beta = sol.squeeze(-1).masked_fill(info.ne(0).unsqueeze(-1),
                                       float("nan"))
    return beta.contiguous()


def _fit_epilogue(family: str, params: Dict, g, b, nw, live=None):
    """The replicated solve on fully rebuilt raw moments.

    g (B,Pa,Pa), b (B,Pa) are the *unregularised* statistics (with the
    intercept column when the learner has one); nw (B,) is the global
    training-weight sum.  Mirrors learners/linear.py: ridge adds reg to
    the diagonal and un-penalises the intercept, OLS is ridge at 1e-8,
    lasso runs the FISTA moments form.
    """
    from repro_torch.learners.linear import _fista_beta_moments
    intercept = bool(params.get("intercept", True))
    if family == "lasso":
        return _fista_beta_moments(
            g, b, nw, reg=float(params.get("reg", 0.01)),
            intercept=intercept, n_iter=int(params.get("n_iter", 200)))
    reg = 1e-8 if family == "ols" else float(params.get("reg", 1.0))
    pa = g.shape[-1]
    g = g + reg * torch.eye(pa, dtype=g.dtype, device=g.device)
    if intercept and reg:
        # in this order: in f32 (x + reg) + (-reg + 1e-8) is not x + 1e-8
        g[:, pa - 1, pa - 1] += -reg + 1e-8
    return gram_solve(g, b, live)


def _fit_params(params: Tuple) -> Tuple[Dict, bool]:
    p = dict(params)
    p.pop("classify", None)     # linear families fit propensities as
    return p, bool(p.get("intercept", True))     # regression (base.py)


def _split(t: torch.Tensor, m: int, dim: int, s: int) -> torch.Tensor:
    """Shard ``s``'s part of ``t``: one of ``m`` equal parts along
    ``dim``, contiguous (the kernels take contiguous operands)."""
    if t.shape[dim] % m:
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not "
                         f"split over {m} shards")
    return t.tensor_split(m, dim)[s].contiguous()


def _data_fit_body(mesh, mesh_axis: str, family: str, params: Tuple):
    """Body of the data@m bucket program, as its stages between the
    collectives, each stage run on every shard: (1) a shard streams its
    N/m rows of the pages as N-chunks through the blocked Gram kernel;
    (2) ``mesh_sum`` rebuilds the exact (G, b, nw) moments of all N rows;
    (3) each shard solves replicated and predicts its own rows; (4) the
    predictions are gathered on N."""
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.learners.linear import _augment_b
    p, intercept = _fit_params(params)
    devices = mesh.shard_devices
    m = len(devices)

    def body(pages, data_idx, y, w, valid, key_data):
        del key_data                       # gram families draw no keys
        live = valid.ne(0).any(dim=1)      # lanes with a row on any shard
        rows, gs, bs, sws = [], [], [], []
        for s, dev in enumerate(devices):
            with on_shard(dev):
                ps = on_device(_split(pages, m, 1, s), dev)
                xb = ps[on_device(data_idx, dev)]            # (B, N/m, P)
                ws = on_device(_split(w, m, 1, s), dev)
                ys = on_device(_split(y, m, 1, s), dev)
                xa = _augment_b(xb) if intercept else xb
                del ps, xb
                chunk = _chunk_rows(int(xa.shape[1]),
                                    roofline.DEVICE_PAGE_ROWS)
                xc, wc, yc = ops.chunk_tall_n(xa, ws, ys, chunk)
                g, b = ops.batched_gram_blocked(xc, wc, yc)
                del xc, wc, yc
                rows.append(xa)
                gs.append(g)
                bs.append(b)
                sws.append(torch.sum(ws, dim=1))
        gs, bs = mesh_sum(gs, mesh), mesh_sum(bs, mesh)
        sws = mesh_sum(sws, mesh)
        preds = []
        for s, dev in enumerate(devices):
            with on_shard(dev):
                nw = torch.clamp(sws[s], min=1.0)
                beta = _fit_epilogue(family, p, gs[s], bs[s], nw,
                                     live=on_device(live, dev))
                vs = on_device(_split(valid, m, 1, s), dev)
                preds.append(ops.batched_predict(rows[s], beta, vs))
        return mesh_gather(preds, 1, mesh)[0]

    return body


def _feature_blocks(mesh, cols, w, y):
    """The feature@m statistics from each shard's columns ``cols`` (B, N,
    P/m): ``mesh_gather`` gives every shard the whole rows; each shard
    forms its (P, P/m) column block of the raw Gram and its slice of
    X'(w*y); ``mesh_gather`` assembles the blocks.  Returns the rows, G
    and b, one of each per shard."""
    x_full = mesh_gather(cols, 2, mesh)          # the row gather
    g_blks, b_blks = [], []
    for s, dev in enumerate(mesh.shard_devices):
        with on_shard(dev):
            wf, yf = on_device(w, dev), on_device(y, dev)
            g_blks.append(torch.einsum("bnp,bn,bnq->bpq", x_full[s], wf,
                                       cols[s]))
            b_blks.append(torch.einsum("bn,bnp->bp", wf * yf, cols[s]))
    return x_full, mesh_gather(g_blks, 2, mesh), mesh_gather(b_blks, 1, mesh)


def _feature_fit_body(mesh, mesh_axis: str, family: str, params: Tuple):
    """Body of the feature@m bucket program: each shard takes its P/m
    columns of the pages, ``_feature_blocks`` gathers the rows and the
    Gram's column blocks, and each shard adds the intercept row and
    column from O(NP) moments, solves replicated and predicts every row
    (one shard's predictions are the result)."""
    from repro_torch.kernels import ops
    from repro_torch.learners.linear import _augment_b
    p, intercept = _fit_params(params)
    devices = mesh.shard_devices
    m = len(devices)

    def body(pages, data_idx, y, w, valid, key_data):
        del key_data
        live = valid.ne(0).any(dim=1)
        cols = []
        for s, dev in enumerate(devices):
            with on_shard(dev):
                ps = on_device(_split(pages, m, 2, s), dev)
                cols.append(ps[on_device(data_idx, dev)])  # (B, N, P/m)
        x_full, gs, bs = _feature_blocks(mesh, cols, w, y)
        preds = []
        for s, dev in enumerate(devices):
            with on_shard(dev):
                ws, ys = on_device(w, dev), on_device(y, dev)
                g, b = gs[s], bs[s]
                nw = torch.clamp(torch.sum(ws, dim=1), min=1.0)
                if intercept:
                    xw1 = torch.einsum("bn,bnp->bp", ws, x_full[s])  # (B, P)
                    sw = torch.sum(ws, dim=1)
                    swy = torch.sum(ws * ys, dim=1)
                    g = torch.cat([torch.cat([g, xw1[:, :, None]], dim=2),
                                   torch.cat([xw1[:, None, :],
                                              sw[:, None, None]], dim=2)],
                                  dim=1)
                    b = torch.cat([b, swy[:, None]], dim=1)
                    xa = _augment_b(x_full[s])
                else:
                    xa = x_full[s]
                beta = _fit_epilogue(family, p, g, b, nw,
                                     live=on_device(live, dev))
                preds.append(ops.batched_predict(xa, beta,
                                                 on_device(valid, dev)))
        return preds[0]

    return body


def _data_gram(mesh, xs, w, y):
    """The standalone data@m Gram: each shard's moments over its N/m
    rows, summed over the mesh (the lead shard's copy)."""
    devices = mesh.shard_devices
    m = len(devices)
    gs, bs = [], []
    for s, dev in enumerate(devices):
        with on_shard(dev):
            xf, wf, yf = (on_device(_split(t, m, 1, s), dev)
                          for t in (xs, w, y))
            gs.append(torch.einsum("bnp,bn,bnq->bpq", xf, wf, xf))
            bs.append(torch.einsum("bn,bnp->bp", wf * yf, xf))
    return mesh_sum(gs, mesh)[0], mesh_sum(bs, mesh)[0]


def _feature_gram(mesh, xs, w, y):
    """The standalone feature@m Gram: ``_feature_blocks`` on each shard's
    P/m columns of ``xs`` (the lead shard's copy)."""
    devices = mesh.shard_devices
    cols = [on_device(_split(xs, len(devices), 2, s), dev)
            for s, dev in enumerate(devices)]
    _, gs, bs = _feature_blocks(mesh, cols, w, y)
    return gs[0], bs[0]


# family/params select a pure body builder; the program is otherwise a
# function of (mesh, mesh_axis) only
@warm_cache(name="data_gram_programs",
            key=("mesh", "mesh_axis", "family", "params"))
def _data_gram_fn(mesh, mesh_axis: str, family: Optional[str] = None,
                  params: Tuple = ()) -> Callable:
    """The N-sharded executor, cached per (mesh, mesh_axis, family,
    params).  ``family=None`` is the standalone Gram form
    ((xs, w, y) -> (G, b)); a Gram family selects the bucket
    fit-predict program at the ProgramCache launch signature."""
    ck = (mesh, mesh_axis, family, params)
    prog = _DATA_GRAM_PROGRAMS.get(ck)
    if prog is not None:
        return prog
    if family is None:
        def prog(xs, w, y):
            return _data_gram(mesh, xs, w, y)
    else:
        prog = _data_fit_body(mesh, mesh_axis, family, params)
    bounded_put(_DATA_GRAM_PROGRAMS, ck, prog, _GRAM_PROGRAM_CACHE_MAX)
    return prog


def data_parallel_gram(mesh, xs, w, y, reg: float = 0.0,
                       mesh_axis: str = "data"):
    """Per-task normal equations with the N axis sharded over ``mesh``.

    xs: (B, N, P); w/y: (B, N), float32 on the mesh's lead device; N a
    multiple of the shard count (callers pad with w == 0 rows, which
    are inert).  Each shard reduces its N/m rows and a sum over
    ``mesh_axis`` rebuilds the full (G (B,P,P), b (B,P)).
    """
    g, b = _data_gram_fn(mesh, mesh_axis)(xs, w, y)
    if reg:
        g = g + reg * torch.eye(xs.shape[-1], dtype=g.dtype,
                                device=g.device)
    return g, b


@warm_cache(name="feature_gram_programs",
            key=("mesh", "mesh_axis", "family", "params"))
def _feature_gram_fn(mesh, mesh_axis: str, family: Optional[str] = None,
                     params: Tuple = ()) -> Callable:
    """The P-sharded executor: same cache and ``family=None`` split as
    ``_data_gram_fn``."""
    ck = (mesh, mesh_axis, family, params)
    prog = _FEATURE_GRAM_PROGRAMS.get(ck)
    if prog is not None:
        return prog
    if family is None:
        def prog(xs, w, y):
            return _feature_gram(mesh, xs, w, y)
    else:
        prog = _feature_fit_body(mesh, mesh_axis, family, params)
    bounded_put(_FEATURE_GRAM_PROGRAMS, ck, prog, _GRAM_PROGRAM_CACHE_MAX)
    return prog


def feature_parallel_gram(mesh, xs, w, y, reg: float = 0.0,
                          mesh_axis: str = "data"):
    """Per-task normal equations with the P axis sharded over ``mesh``:
    each shard holds P/m columns (P a multiple of the shard count),
    gathers the full row matrix and computes its (P, P/m) column block of
    the Gram and its slice of X'(w*y); the blocks concatenate into the
    full statistics."""
    g, b = _feature_gram_fn(mesh, mesh_axis)(xs, w, y)
    if reg:
        g = g + reg * torch.eye(xs.shape[-1], dtype=g.dtype,
                                device=g.device)
    return g, b


def axis_fit_program(mesh, axis: str, family: str, params: Tuple,
                     mesh_axis: str = "data") -> Callable:
    """The in-mesh bucket program executing a data/feature
    ``AxisDecision`` at the ProgramCache launch signature ``run(pages,
    data_idx, y, w, valid, key_data) -> preds (B, N_pad)``.  ``params``
    is the bucket ident's sorted hyperparameter tuple."""
    if axis == "data":
        return _data_gram_fn(mesh, mesh_axis, family, tuple(params))
    if axis == "feature":
        return _feature_gram_fn(mesh, mesh_axis, family, tuple(params))
    raise ValueError(f"no in-mesh executor for axis {axis!r}")


def axis_fit_program_cached(mesh, axis: str, family: str, params: Tuple,
                            mesh_axis: str = "data") -> bool:
    """Whether ``axis_fit_program`` would be a warm hit (hit/miss
    booking in dispatch_bucket)."""
    ck = (mesh, mesh_axis, family, tuple(params))
    cache = _DATA_GRAM_PROGRAMS if axis == "data" \
        else _FEATURE_GRAM_PROGRAMS
    return ck in cache
