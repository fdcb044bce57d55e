"""K6's backward (the SSD scan's gradient) on the CPU, against the JAX
package: ``jax.vjp`` of the reference's chunked ``ssd_chunked``
(``src/repro/models/ssm.py``) on the kernels' lanes and of its sequential
oracle ``repro.kernels.ref.ssd_scan_ref``.

(a) the plain backward (autograd through the plain forward, chunked and
sequential) within 1e-5 of each gradient's max|.|; (b) a plain emulation
of the backward kernels' launches (``csrc/ssd_bwd.cu``: products of
three bf16 parts in six passes, the chunks in reverse order for the
state's gradient, dS formed by row bands and again by column bands, the
heads' dB and dC summed by head groups, dcl from per-row parts) within
2e-5, the tier chip_smoke.py holds the kernels to on the card; (c) the
routing: an input that needs a
gradient takes ``ssd_scan_cuda``'s backward route, the CPU route
differentiates the plain version with no launch; (d) the backward's shape
limits; (e) the reduced zamba2-7b and xlstm-350m ``loss_fn`` gradients
through ``_ssd_kernel_route`` and ``SsdScanFunction`` with the launches
replaced by the emulations of the forward and backward kernels, against
``jax.value_and_grad``.  Inputs come from numpy with a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref
from repro.models import build_model as jax_build_model
from repro.models import init_tree as jax_init_tree
from repro.models import ssm as JS
from repro_torch import runtime
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import ssm as S
from repro_torch.models.param import tree_paths

PLAIN_TIER = 1e-5
SCHEDULE_TIER = 2e-5
NAMES = ("dxbar", "dla", "dbm", "dcm")

# (BH, heads, S, P, N, chunk, la): heads sharing bm/cm, a ragged S, strong
# decay (la = -50: the clip at -60 bites two rows apart), heads 1, N and P
# past 64 with a ragged S, odd N and P, the serve path's widths (P = N =
# 64, Q 256) on a few lanes with S past one chunk
CASES = [
    (6, 3, 128, 16, 8, 32, "slow"),
    (4, 2, 100, 16, 16, 32, "slow"),
    (4, 2, 64, 16, 8, 16, "strong"),
    (2, 1, 96, 32, 16, 32, "slow"),
    (4, 2, 200, 72, 80, 64, "slow"),
    (6, 3, 150, 13, 7, 64, "slow"),
    (2, 2, 300, 64, 64, 256, "slow"),
]


def _inputs(bh, heads, s, p, n, decay):
    """xbar, la, bm, cm and the gradients dy, dS_final (non-zero) as
    numpy float32."""
    rng = np.random.default_rng(bh * s + 7 * p + n)
    g = bh // heads
    xb = rng.standard_normal((bh, s, p), dtype=np.float32)
    if decay == "strong":
        la = np.full((bh, s), -50.0, np.float32)
    else:
        la = (-0.1 * rng.random((bh, s))).astype(np.float32)
    bm = rng.standard_normal((g, s, n), dtype=np.float32)
    cm = rng.standard_normal((g, s, n), dtype=np.float32)
    dy = rng.standard_normal((bh, s, p), dtype=np.float32)
    dst = rng.standard_normal((bh, n, p), dtype=np.float32)
    return xb, la, bm, cm, dy, dst


def _chunked_lanes(chunk, heads):
    """The reference's ssd_chunked on the kernels' lanes: (BH, S, P) as
    (BH / heads, S, heads, P), bm and cm shared by a row's heads."""
    def fn(xb, la, bm, cm):
        g = xb.shape[0] // heads
        s, p = xb.shape[1:]
        x4 = xb.reshape(g, heads, s, p).transpose(0, 2, 1, 3)
        l3 = la.reshape(g, heads, s).transpose(0, 2, 1)
        y, st = JS.ssd_chunked(x4, l3, bm, cm, chunk)
        return (y.transpose(0, 2, 1, 3).reshape(g * heads, s, p),
                st.reshape(g * heads, *st.shape[2:]))
    return fn


def _oracle_lanes(heads):
    """The reference's sequential oracle on bm, cm repeated to every
    lane (its gradient sums the lanes of a row)."""
    def fn(xb, la, bm, cm):
        return ref.ssd_scan_ref(xb, la, jnp.repeat(bm, heads, axis=0),
                                jnp.repeat(cm, heads, axis=0))
    return fn


def _jax_vjp(fn, xb, la, bm, cm, dy, dst):
    _, pull = jax.vjp(jax.jit(fn), *map(jnp.asarray, (xb, la, bm, cm)))
    return [np.asarray(g) for g in pull((jnp.asarray(dy),
                                         jnp.asarray(dst)))]


def _gaps(got, want):
    """Per gradient, max |got - want| as a fraction of max |want| (0
    where both are 0 throughout)."""
    out = []
    for a, b in zip(got, want):
        err = float(np.abs(np.asarray(a, np.float64) - b).max())
        scale = float(np.abs(b).max())
        out.append(err / scale if scale > 0 else (0.0 if err == 0 else
                                                   np.inf))
    return out


def _held(gaps, decay, same_kind):
    """The gaps a comparison holds: at strong decay dla only between forms
    of one kind (see test_strong_decay_dla_is_rounded_away_by_the_chunked_
    reference)."""
    return {name: gap for name, gap in zip(NAMES, gaps)
            if same_kind or decay != "strong" or name != "dla"}


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------
def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero: the kernels' split_tf32_int."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, split=True):
    """``einsum(eq, a, b)`` from TF32 parts summed in float32: the three
    passes a_lo b_hi + a_hi b_lo + a_hi b_hi (``split=False``: one TF32
    rounding of each operand).  The forward kernels' products."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _bf16_trunc(x):
    """x with its low 16 bits cleared: a bf16 truncated toward zero."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _parts3(x):
    """x as three bf16 parts h + m + l (float32 tensors), exactly: h and
    m x and its remainder truncated, l the rest (the backward kernels'
    split3)."""
    h = _bf16_trunc(x)
    m = _bf16_trunc(x - h)
    return h, m, (x - h) - m


# the parts (of a, of b) of the six passes, smallest first
PASSES = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _product3(eq, a, b):
    """``einsum(eq, a, b)`` as the backward kernels' wgmma takes it: each
    operand as three bf16 parts, six passes smallest first, summed in
    float32 (a product of two bf16 values is exact in float32)."""
    pa, pb = _parts3(a), _parts3(b)
    out = torch.einsum(eq, pa[PASSES[0][0]], pb[PASSES[0][1]])
    for i, j in PASSES[1:]:
        out = out + torch.einsum(eq, pa[i], pb[j])
    return out


def _chunks(s, chunk):
    q = min(chunk, s)
    return q, [slice(t0, min(s, t0 + q)) for t0 in range(0, s, q)]


def _fwd_schedule(x, la, bm, cm, chunk, heads, split=True):
    """The forward kernels (``csrc/lm.cu``) emulated, with the scratch
    they leave for the backward: y, the final state, the scores cb (BH /
    heads, chunks, Qp, Qp; the 64 x 64 sub-tiles on and below the
    diagonal that a chunk's rows reach, the rest NaN as never written),
    the state entering each chunk (BH, chunks, N, P) and the chunks'
    decays exp(cl_Q) (BH, chunks)."""
    bh, s, p = x.shape
    n, g = bm.shape[-1], bm.shape[0]
    grp = torch.arange(bh) // heads
    q, chunks = _chunks(s, chunk)
    qp = -(-q // 64) * 64
    cb = torch.full((g, len(chunks), qp, qp), float("nan"))
    states = torch.empty((bh, len(chunks), n, p))
    decay = torch.empty((bh, len(chunks)))
    local, cls = [], []
    for c, sl in enumerate(chunks):
        ln = sl.stop - sl.start
        cl = torch.cumsum(la[:, sl], dim=1)
        cls.append(cl)
        full = torch.zeros((g, qp, qp))
        full[:, :ln, :ln] = _product("gin,gjn->gij", cm[:, sl], bm[:, sl],
                                     split)
        for ti in range(-(-ln // 64)):
            rows = slice(64 * ti, 64 * ti + 64)
            cb[:, c, rows, :64 * ti + 64] = full[:, rows, :64 * ti + 64]
        tail = torch.exp(cl[:, -1:] - cl)
        local.append(_product("hjn,hjp->hnp", bm[grp, sl] * tail[..., None],
                              x[:, sl], split))
        decay[:, c] = torch.exp(cl[:, -1])
    state = torch.zeros((bh, n, p))
    for c in range(len(chunks)):
        states[:, c] = state
        state = decay[:, c, None, None] * state + local[c]
    ys = []
    for c, (sl, cl) in enumerate(zip(chunks, cls)):
        ln = sl.stop - sl.start
        d = torch.clamp(cl[:, :, None] - cl[:, None, :], -60.0, 0.0)
        w = torch.where(torch.ones((ln, ln), dtype=torch.bool).tril(),
                        cb[grp, c, :ln, :ln] * torch.exp(d), torch.zeros(()))
        ys.append(torch.exp(cl)[..., None]
                  * _product("hin,hnp->hip", cm[grp, sl], states[:, c], split)
                  + _product("hij,hjp->hip", w, x[:, sl], split))
    return torch.cat(ys, dim=1), state, cb, states, decay


def _bwd_schedule(x, la, bm, cm, cb, states, decay, dy, dst, chunk, heads,
                  split=True):
    """The backward kernels' launches (``csrc/ssd_bwd.cu``) emulated from
    the forward's scratch: (a) each chunk's (C exp(cl))' dy; (b) the
    gradients G of the states leaving the chunks, in reverse chunk order
    from dS_final; (c) the ROW blocks: dS = tril(dy x') * L by row bands,
    g = dS * scores (0 where the clip bites) summed along rows, each head's
    dC = exp(cl) (dy S_in') + dS B with the row sums against C; the COL
    blocks: dS' = tril(x dy') * L' formed again by column bands, g summed
    along columns, each head's dB = tail (x G') + dS' C with the row sums
    against B, dxbar = tail (B G) + W' dy; a head group's dB, dC summed over
    its heads in order; (d) dcl from the parts and the chunk-end terms, dla
    its reverse cumulative sum in the chunk, dbm, dcm the groups' sums in
    group order.  Every product as three bf16 parts in six passes
    (``split=False``: one TF32 rounding of each operand)."""
    prod = _product3 if split else (
        lambda eq, a, b: _product(eq, a, b, split=False))
    bh, s, p = x.shape
    n, g = bm.shape[-1], bm.shape[0]
    grp = torch.arange(bh) // heads
    _, chunks = _chunks(s, chunk)
    mask = {}
    pre = []
    for sl in chunks:
        cl = torch.cumsum(la[:, sl], dim=1)
        pre.append((cl, torch.exp(cl), torch.exp(cl[:, -1:] - cl)))
    local = [prod("hin,hip->hnp", cm[grp, sl] * ecl[..., None], dy[:, sl])
             for sl, (_, ecl, _) in zip(chunks, pre)]
    gst = [None] * len(chunks)
    run = torch.zeros((bh, n, p)) if dst is None else dst
    for c in reversed(range(len(chunks))):
        gst[c] = run
        run = decay[:, c, None, None] * run + local[c]
    dx, dla = torch.empty_like(x), torch.empty_like(la)
    # each lane's two terms of dC (u, dS B) and of dB (tail v, dS' C)
    lane_c = torch.empty((2, bh, s, n))
    lane_b = torch.empty((2, bh, s, n))
    for c, (sl, (cl, ecl, tail)) in enumerate(zip(chunks, pre)):
        ln = sl.stop - sl.start
        if ln not in mask:
            mask[ln] = torch.ones((ln, ln), dtype=torch.bool).tril()
        tril = mask[ln]
        s_in, gc = states[:, c], gst[c]
        bc, cc, xc, dyc = bm[grp, sl], cm[grp, sl], x[:, sl], dy[:, sl]
        d = cl[:, :, None] - cl[:, None, :]
        lmat = torch.exp(torch.clamp(d, -60.0, 0.0))
        scores = cb[grp, c, :ln, :ln]
        bites = tril.tril(-1) & (d >= -60.0) & (d <= 0.0)
        zero = torch.zeros(())
        # ROW blocks: dS [i, j]
        ds = torch.where(tril, prod("hip,hjp->hij", dyc, xc) * lmat, zero)
        grow = torch.where(bites, ds * scores, zero).sum(2)
        u = prod("hip,hnp->hin", dyc, s_in) * ecl[..., None]
        t2 = (cc * u).sum(-1)
        lane_c[0, :, sl], lane_c[1, :, sl] = u, prod("hij,hjn->hin", ds, bc)
        # COL blocks: dS' [j, i], W' [j, i]
        tt = tril.T
        dst_ = torch.where(tt, prod("hjp,hip->hji", xc, dyc)
                           * lmat.transpose(1, 2), zero)
        gcol = torch.where(bites.transpose(1, 2),
                           dst_ * scores.transpose(1, 2), zero).sum(2)
        wt = torch.where(tt, (scores * lmat).transpose(1, 2), zero)
        dx[:, sl] = prod("hjn,hnp->hjp", bc, gc) * tail[..., None] \
            + prod("hji,hip->hjp", wt, dyc)
        v = prod("hjp,hnp->hjn", xc, gc)
        tr = tail * (bc * v).sum(-1)
        tr[:, -1] = 0.0
        lane_b[0, :, sl] = v * tail[..., None]
        lane_b[1, :, sl] = prod("hji,hin->hjn", dst_, cc)
        sg = (s_in * gc).sum((1, 2))
        dcl = grow - gcol + t2 - tr
        dcl[:, -1] += tr.sum(1) + decay[:, c] * sg
        dla[:, sl] = torch.flip(torch.cumsum(torch.flip(dcl, [1]), 1), [1])
    per, ngrp = ssd_mod.head_groups(heads)
    sums = []
    for lanes in (lane_b, lane_c):
        out = None
        for k in range(ngrp):
            part = torch.zeros((g, s, n))
            for h in range(k * per, min(heads, (k + 1) * per)):
                part = part + lanes[0, h::heads]
                part = part + lanes[1, h::heads]
            out = part if out is None else out + part
        sums.append(out)
    return dx, dla, sums[0], sums[1]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# (a) the plain backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [True, False], ids=["chunked",
                                                        "sequential"])
@pytest.mark.parametrize("bh,heads,s,p,n,chunk,decay", CASES)
def test_plain_backward_matches_jax_vjp(bh, heads, s, p, n, chunk, decay,
                                        chunked):
    """Autograd through the plain forward (the lanes' chunked form, or the
    sequential recurrence) against jax.vjp of the reference's ssd_chunked
    and of ssd_scan_ref, with a non-zero gradient of the final state:
    within 1e-5 of each gradient's max|.| (measured at most 9.7e-7)."""
    xb, la, bm, cm, dy, dst = _inputs(bh, heads, s, p, n, decay)
    got = ssd_mod.ssd_scan_backward_plain(*_torch(xb, la, bm, cm, dy, dst),
                                          chunk=chunk, heads=heads,
                                          chunked=chunked)
    assert [tuple(t.shape) for t in got] == [a.shape for a in
                                             (xb, la, bm, cm)]
    for kind, fn in ((True, _chunked_lanes(chunk, heads)),
                     (False, _oracle_lanes(heads))):
        want = _jax_vjp(fn, xb, la, bm, cm, dy, dst)
        gaps = _held(_gaps([t.numpy() for t in got], want), decay,
                     kind == chunked)
        assert max(gaps.values()) <= PLAIN_TIER, gaps


def test_plain_backward_without_a_final_state_gradient():
    """dS_final None counts as zero: the gradients of y alone."""
    bh, heads, s, p, n, chunk, decay = CASES[1]
    xb, la, bm, cm, dy, dst = _inputs(bh, heads, s, p, n, decay)
    got = ssd_mod.ssd_scan_backward_plain(*_torch(xb, la, bm, cm, dy),
                                          None, chunk=chunk, heads=heads)
    want = _jax_vjp(_chunked_lanes(chunk, heads), xb, la, bm, cm, dy,
                    np.zeros_like(dst))
    assert max(_gaps([t.numpy() for t in got], want)) <= PLAIN_TIER


# ---------------------------------------------------------------------------
# (b) the backward kernels' schedule
# ---------------------------------------------------------------------------
def _schedule_grads(xb, la, bm, cm, dy, dst, chunk, heads, split=True):
    x, a, b, c, g, d = _torch(xb, la, bm, cm, dy, dst)
    _, _, cb, states, decay = _fwd_schedule(x, a, b, c, chunk, heads, split)
    return _bwd_schedule(x, a, b, c, cb, states, decay, g, d, chunk, heads,
                         split)


@pytest.mark.parametrize("bh,heads,s,p,n,chunk,decay", CASES)
def test_backward_schedule_matches_jax_vjp(bh, heads, s, p, n, chunk, decay):
    """The backward kernels' passes, from the forward kernels' scratch,
    against jax.vjp of ssd_chunked and of ssd_scan_ref: within 2e-5 of
    each gradient's max|.| (measured at most 8.9e-7).  At strong decay
    dla is held against the oracle: the kernels leave out the terms whose
    rounding the chunked reference's dla drowns in."""
    xb, la, bm, cm, dy, dst = _inputs(bh, heads, s, p, n, decay)
    got = _schedule_grads(xb, la, bm, cm, dy, dst, chunk, heads)
    assert all(torch.isfinite(t).all() for t in got)
    for chunked, fn in ((True, _chunked_lanes(chunk, heads)),
                        (False, _oracle_lanes(heads))):
        want = _jax_vjp(fn, xb, la, bm, cm, dy, dst)
        gaps = _held(_gaps([t.numpy() for t in got], want), decay,
                     not chunked)
        assert max(gaps.values()) <= SCHEDULE_TIER, gaps


def test_strong_decay_dla_is_rounded_away_by_the_chunked_reference():
    """At la = -50, dla is about 1e-20 (each row's decay of the one pair
    the clip leaves, exp(-50)); the chunked forms (the reference's
    ssd_chunked, and autograd through the port's plain chunked form) add
    the diagonal's order-1 decay terms of W and take them away again, and
    in float32 return 0.  The oracle has it, and so do the kernels'
    passes, which leave those terms out: within 2e-5 of the oracle's
    max|dla|."""
    bh, heads, s, p, n, chunk, decay = CASES[2]
    xb, la, bm, cm, dy, dst = _inputs(bh, heads, s, p, n, decay)
    chunked = _jax_vjp(_chunked_lanes(chunk, heads), xb, la, bm, cm, dy,
                       dst)[1]
    oracle = _jax_vjp(_oracle_lanes(heads), xb, la, bm, cm, dy, dst)[1]
    plain = ssd_mod.ssd_scan_backward_plain(
        *_torch(xb, la, bm, cm, dy, dst), chunk=chunk, heads=heads)[1]
    assert np.abs(chunked).max() == 0.0 and float(plain.abs().max()) == 0.0
    assert 0.0 < np.abs(oracle).max() < 1e-18
    got = _schedule_grads(xb, la, bm, cm, dy, dst, chunk, heads)[1]
    assert _gaps([got.numpy()], [oracle])[0] <= SCHEDULE_TIER


def test_backward_one_tf32_rounding_leaves_the_tier():
    """One TF32 rounding of each operand (finer than one bf16 rounding),
    at the serve path's widths, puts a gradient more than 2e-5 of its max
    off the reference: why the backward kernels split every operand into
    three bf16 parts, as the forward kernels split it into hi and lo."""
    bh, heads, s, p, n, chunk, decay = CASES[-1]
    xb, la, bm, cm, dy, dst = _inputs(bh, heads, s, p, n, decay)
    got = _schedule_grads(xb, la, bm, cm, dy, dst, chunk, heads, split=False)
    want = _jax_vjp(_chunked_lanes(chunk, heads), xb, la, bm, cm, dy, dst)
    assert max(_gaps([t.numpy() for t in got], want)) > SCHEDULE_TIER


# ---------------------------------------------------------------------------
# (c) the routing
# ---------------------------------------------------------------------------
def _small(requires_grad):
    x = torch.zeros((4, 8, 4), requires_grad=requires_grad)
    return x, torch.zeros((4, 8)), torch.zeros((2, 8, 3)), \
        torch.zeros((2, 8, 3))


def test_ssd_scan_needing_a_gradient_takes_the_backward_route():
    """An input that needs a gradient goes through ``SsdScanFunction``,
    whose shape check is the backward's (a shape the forward takes and
    the backward does not raises before anything launches), then meets
    the device check in the Function's forward; under no_grad the same
    input takes the forward alone.  On the CPU ``ops.ssd_scan``
    differentiates the plain version with no launch."""
    # 2**26 lanes of 8 chunks of 256 rows at P 320: the forward's 2**30
    # output blocks fit, the backward's 5 * 2**29 state tiles do not (meta
    # tensors: shapes without storage)
    big = [torch.empty(shape, device="meta") for shape in (
        (2 ** 26, 2048, 320), (2 ** 26, 2048), (2 ** 26, 2048, 1),
        (2 ** 26, 2048, 1))]
    big[0].requires_grad_(True)
    with pytest.raises(ValueError, match="backward"):
        ssd_mod.ssd_scan_cuda(*big, chunk=256)
    x, la, bm, cm = _small(True)
    entered = []
    real = ssd_mod.SsdScanFunction.forward

    def forward(ctx, *args):
        entered.append(True)
        return real(ctx, *args)
    ssd_mod.SsdScanFunction.forward = staticmethod(forward)
    try:
        with pytest.raises(ValueError, match="card"):
            ssd_mod.ssd_scan_cuda(x, la, bm, cm, chunk=4, heads=2)
        assert entered == [True]
        with torch.no_grad():
            with pytest.raises(ValueError, match="card"):
                ssd_mod.ssd_scan_cuda(x, la, bm, cm, chunk=4, heads=2)
        assert entered == [True]
    finally:
        ssd_mod.SsdScanFunction.forward = staticmethod(real)
    runtime.reset_launch_counts()
    y, st = ops.ssd_scan(x, la, bm, cm, chunk=4, heads=2)
    (y.sum() + st.sum()).backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert set(runtime.launch_counts.values()) == {0}


def test_backward_wrapper_takes_only_card_tensors():
    """The backward's wrapper checks the forward's scratch it is given
    and refuses CPU tensors before building anything."""
    x, la, bm, cm = _small(False)
    cb, states, decay = (torch.zeros(shape) for shape in
                         ssd_mod.scratch_shapes(4, 8, 4, 3, 4, 2))
    with pytest.raises(ValueError, match="card"):
        ssd_mod.ssd_scan_bwd_cuda(x, la, bm, cm, cb, states, decay,
                                  torch.zeros_like(x), None, chunk=4,
                                  heads=2)
    with pytest.raises(ValueError, match="states"):
        ssd_mod.ssd_scan_bwd_cuda(x, la, bm, cm, cb, states[:, :1], decay,
                                  torch.zeros_like(x), None, chunk=4,
                                  heads=2)


# ---------------------------------------------------------------------------
# (d) the backward's shape limits and scratch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bh,s,p,n,chunk,ok", [
    (448, 2048, 64, 64, 256, True),       # zamba2-7b's training call
    (16, 2048, 513, 512, 256, True),      # xlstm-350m's
    (112, 2049, 64, 64, 256, True),       # a ragged S
    (53687091, 2048, 320, 1, 256, True),  # 40 BH state tiles < 2**31
    (53687092, 2048, 320, 1, 256, False),  # 40 BH >= 2**31
    (2 ** 25, 2048, 1, 1, 64, True),      # 64-row chunks: 2**30 items
    (8, 777, 64, 64, 257, False),         # the forward's chunk limit
    (1, 64, 2 ** 20, 64, 256, False),     # the forward's N * P limit
])
def test_ssd_backward_shape_limits(bh, s, p, n, chunk, ok):
    """The backward takes every shape the forward takes while its grids
    stay under 2**31 blocks (BH * chunks * ceil(N / 64) * ceil(P / 64)
    state tiles, BH * chunks + 2**20 blocks of the last launch; the band
    blocks' grid, at most BH * chunks, is under both); each limit raises
    naming it."""
    if ok:
        ssd_mod.check_backward_shape(bh, s, p, n, chunk)
    else:
        with pytest.raises(ValueError, match="limits"):
            ssd_mod.check_backward_shape(bh, s, p, n, chunk)


@pytest.mark.parametrize("bh,s,p,n,chunk,heads,want", [
    (448, 2048, 64, 64, 256, 112,
     ((448, 8, 64, 64), (448, 2048, 4), (4, 8, 2048, 64),
      (4, 8, 2048, 64))),
    (16, 2048, 513, 512, 256, 1,
     ((16, 8, 512, 513), (16, 2048, 18), None, None)),
    (6, 300, 13, 7, 64, 3,
     ((6, 5, 7, 13), (6, 300, 4), (2, 3, 300, 7), (2, 3, 300, 7))),
])
def test_ssd_backward_scratch_shapes(bh, s, p, n, chunk, heads, want):
    """The backward's scratch: a state gradient per (lane, chunk), the
    parts of dcl per row, and the head groups' partial dB, dC only where
    heads share them; no dS and no per-lane dB, dC."""
    assert ssd_mod.bwd_scratch_shapes(bh, s, p, n, chunk, heads) == want
    if heads > 1:
        assert want[2][1] == ssd_mod.head_groups(heads)[1] \
            <= ssd_mod.HEAD_GROUPS


@pytest.mark.parametrize("heads,groups", [(112, (14, 8)), (20, (3, 7))])
def test_head_group_sums_match_jax_vjp(heads, groups):
    """dbm and dcm as the kernels sum them (each head group's heads in
    order, then the groups in order) at heads 112 (zamba2-7b's: 8 groups
    of 14) and 20 (7 groups, the last of 2), one batch row, with a ragged
    S (100 rows in chunks of 32): within 2e-5 of max|.| of jax.vjp of
    the reference's ssd_chunked, dxbar and dla too."""
    assert ssd_mod.head_groups(heads) == groups
    xb, la, bm, cm, dy, dst = _inputs(heads, heads, 100, 8, 8, "slow")
    got = _schedule_grads(xb, la, bm, cm, dy, dst, 32, heads)
    want = _jax_vjp(_chunked_lanes(32, heads), xb, la, bm, cm, dy, dst)
    gaps = _gaps([t.numpy() for t in got], want)
    assert max(gaps) <= SCHEDULE_TIER, gaps


# ---------------------------------------------------------------------------
# (e) the families' gradients through the kernels' route, emulated
# ---------------------------------------------------------------------------
LOSS_TIER = 1e-5
GRAD_TIER = 1e-4
FAMILIES = {"hybrid": ("zamba2-7b", {}), "xlstm": ("xlstm-350m",
                                                   {"slstm_every": 2})}
SEQ = 64


def _family_cfg(get, name):
    arch, ssm = FAMILIES[name]
    cfg = get(arch, reduced=True)
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm))
    return cfg


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_gradients_through_the_kernel_route(name, monkeypatch):
    """The reduced model's loss and gradients with every SSD scan taken
    through ``_ssd_kernel_route`` (heads folded into lanes, B and C
    shared) and ``SsdScanFunction``, the four forward and the backward
    launches replaced by their emulations, against
    ``jax.value_and_grad``: the loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its max|.|.  dbm and dcm come back as (B, S, N)."""
    calls = {"forward": 0, "backward": []}

    def forward(xbar, la, bm, cm, chunk, heads):
        calls["forward"] += 1
        return _fwd_schedule(xbar, la, bm, cm, chunk, heads)

    def backward(xbar, la, bm, cm, cb, states, decay, dy, dstate, *, chunk,
                 heads):
        grads = _bwd_schedule(xbar, la, bm, cm, cb, states, decay, dy,
                              dstate, chunk, heads)
        calls["backward"].append([tuple(t.shape) for t in grads])
        return grads

    monkeypatch.setattr(ssd_mod, "_forward_cuda", forward)
    monkeypatch.setattr(ssd_mod, "ssd_scan_bwd_cuda", backward)
    monkeypatch.setattr(ops, "ssd_scan", ssd_mod.ssd_scan_cuda)
    monkeypatch.setattr(S, "ssd_chunked", S._ssd_kernel_route)

    jb = jax_build_model(_family_cfg(jax_get_arch, name), remat="none",
                         attn_chunk=32)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_init_tree(jb.decls, jax.random.key(0)))
    cfg = _family_cfg(get_arch, name)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (want, _), want_grads = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})

    pb = build_model(cfg, attn_chunk=32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for _, t in tree_paths(params):
        t.requires_grad_(True)
    loss, _ = pb.loss_fn(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    assert calls["forward"] >= 1 and len(calls["backward"]) >= 1
    for dx, _, dbm, dcm in calls["backward"]:
        # the hybrid's heads share B and C: (B, S, N) beside (B * heads,
        # S, P); the mLSTM's lanes are its heads, each with its own
        assert dbm == dcm and dbm[:2] == ((2, SEQ) if name == "hybrid"
                                          else dx[:2])
        assert dx[0] > 2 if name == "hybrid" else True
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= LOSS_TIER * abs(float(want))
    for path, t in tree_paths(params):
        ref_grad = np.asarray(_leaf(want_grads, path))
        got = np.zeros(ref_grad.shape, np.float32) if t.grad is None \
            else t.grad.numpy()
        scale = max(float(np.abs(ref_grad).max()), 1e-12)
        err = float(np.abs(got - ref_grad).max())
        assert err <= GRAD_TIER * scale, (name, path, err, scale)
