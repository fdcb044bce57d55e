"""The port's megabatch kernel wrappers against the JAX package's.

On the CPU the port's ``ops`` wrappers run each kernel's plain PyTorch
version; the reference side runs the Pallas kernels in interpret mode
(inputs pre-padded as ``repro.kernels.ops`` pads them) and the jnp
oracles of ``repro.kernels.ref``.  Inputs come from numpy with a seed.
Tolerance: rtol 1e-5, atol 1e-5 * max|G| — all sides accumulate in
float32, in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.megabatch import (
    batched_gram_blocked_pallas, batched_gram_pallas, batched_predict_pallas,
)
from repro_torch import runtime
from repro_torch.kernels import megabatch, ops

SHAPES = [(8, 128, 8), (16, 256, 16), (8, 64, 24), (5, 100, 7), (3, 37, 33)]


def _inputs(b, n, p, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, n, p)).astype(np.float32)
    w = (rng.random((b, n)) > 0.4).astype(np.float32)
    y = rng.standard_normal((b, n)).astype(np.float32)
    beta = rng.standard_normal((b, p)).astype(np.float32)
    valid = (rng.random((b, n)) > 0.25).astype(np.float32)
    return xs, w, y, beta, valid


def _pad(a, axis, mult):
    pad = (-a.shape[axis]) % mult
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def _pallas_gram(xs, w, y):
    """batched_gram_pallas in interpret mode, padded as the reference
    wrapper pads: P to 128 lanes, N to the row block, B to 8."""
    b, n, p = xs.shape
    bn = 256 if n >= 256 else 8
    xp = _pad(_pad(_pad(xs, 2, 128), 1, bn), 0, 8)
    wp = _pad(_pad(w, 1, bn), 0, 8)
    yp = _pad(_pad(y, 1, bn), 0, 8)
    g, bv = batched_gram_pallas(jnp.asarray(xp), jnp.asarray(wp),
                                jnp.asarray(yp), block_b=8, block_n=bn,
                                interpret=True)
    return np.asarray(g)[:b, :p, :p], np.asarray(bv)[:b, :p]


def _pallas_predict(xs, beta, valid):
    b, n, p = xs.shape
    bn = 256 if n >= 256 else 8
    xp = _pad(_pad(_pad(xs, 2, 128), 1, bn), 0, 8)
    bp = _pad(_pad(beta, 1, 128), 0, 8)
    vp = _pad(_pad(valid, 1, bn), 0, 8)
    out = batched_predict_pallas(jnp.asarray(xp), jnp.asarray(bp),
                                 jnp.asarray(vp), block_b=8, block_n=bn,
                                 interpret=True)
    return np.asarray(out)[:b, :n]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want, scale_of=None):
    scale = float(np.abs(want if scale_of is None else scale_of).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("b,n,p", SHAPES)
def test_batched_gram_matches_pallas_interpret(b, n, p):
    xs, w, y, _, _ = _inputs(b, n, p, seed=b + n + p)
    g, bv = ops.batched_gram(*_t(xs, w, y))
    g0, b0 = _pallas_gram(xs, w, y)
    assert g.dtype == torch.float32 and tuple(g.shape) == (b, p, p)
    assert bv.dtype == torch.float32 and tuple(bv.shape) == (b, p)
    _close(g.numpy(), g0)
    _close(bv.numpy(), b0)


@pytest.mark.parametrize("b,n,p", SHAPES)
def test_batched_gram_matches_jnp_oracle(b, n, p):
    xs, w, y, _, _ = _inputs(b, n, p, seed=7 * b + n + p)
    g, bv = ops.batched_gram(*_t(xs, w, y))
    g0, b0 = ref.batched_gram_ref(jnp.asarray(xs), jnp.asarray(w),
                                  jnp.asarray(y))
    _close(g.numpy(), np.asarray(g0))
    _close(bv.numpy(), np.asarray(b0))


@pytest.mark.parametrize("reg", [1.0, 1e-8, 0.25])
def test_batched_gram_reg_lands_on_the_diagonal(reg):
    xs, w, y, _, _ = _inputs(4, 64, 6, seed=11)
    g0, b0 = ops.batched_gram(*_t(xs, w, y))
    g1, b1 = ops.batched_gram(*_t(xs, w, y), reg=reg)
    want, _ = ref.batched_gram_ref(jnp.asarray(xs), jnp.asarray(w),
                                   jnp.asarray(y), reg)
    _close(g1.numpy(), np.asarray(want))
    diff = (g1 - g0).numpy()
    eye = np.eye(6, dtype=bool)
    assert (diff[:, ~eye] == 0).all()           # off-diagonal untouched
    assert torch.equal(b0, b1)
    if reg >= 0.25:                             # 1e-8 is below f32 resolution
        np.testing.assert_allclose(diff[:, eye], reg, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 17, 256])
def test_zero_weight_rows_are_inert(seed):
    xs, w, y, _, _ = _inputs(6, 96, 9, seed)
    g0, b0 = ops.batched_gram(*_t(xs, w, y))
    rng = np.random.default_rng(seed + 1)
    xs2, y2 = xs.copy(), y.copy()
    dead = w == 0
    xs2[dead] = rng.standard_normal((int(dead.sum()), 9)).astype(np.float32)
    y2[dead] = 123.0
    g1, b1 = ops.batched_gram(*_t(xs2, w, y2))
    assert torch.equal(g0, g1) and torch.equal(b0, b1)


def test_poisoned_padding_rows_with_zero_weight():
    """Rows appended as padding carry w == 0; whatever they hold (here
    1e6) must not reach the moments — on either side."""
    xs, w, y, _, _ = _inputs(4, 80, 5, seed=5)
    g0, b0 = ops.batched_gram(*_t(xs, w, y))
    xs_p = np.concatenate([xs, np.full((4, 24, 5), 1e6, np.float32)], axis=1)
    w_p = np.concatenate([w, np.zeros((4, 24), np.float32)], axis=1)
    y_p = np.concatenate([y, np.full((4, 24), 1e6, np.float32)], axis=1)
    g1, b1 = ops.batched_gram(*_t(xs_p, w_p, y_p))
    _close(g1.numpy(), g0.numpy())
    _close(b1.numpy(), b0.numpy())
    g2, b2 = _pallas_gram(xs_p, w_p, y_p)
    _close(g1.numpy(), g2)
    _close(b1.numpy(), b2)


@pytest.mark.parametrize("b,n,p", SHAPES)
def test_batched_predict_matches_reference(b, n, p):
    xs, _, _, beta, valid = _inputs(b, n, p, seed=b * n + p)
    out = ops.batched_predict(*_t(xs, beta, valid))
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, n)
    want = _pallas_predict(xs, beta, valid)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    oracle = ref.batched_predict_ref(jnp.asarray(xs), jnp.asarray(beta),
                                     jnp.asarray(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,n,p", SHAPES[:3])
def test_batched_predict_invalid_rows_exactly_zero(b, n, p):
    xs, _, _, beta, valid = _inputs(b, n, p, seed=3 * b + p)
    out = ops.batched_predict(*_t(xs, beta, valid)).numpy()
    assert (valid == 0).any()
    assert (out[valid == 0] == 0.0).all()
    assert (out[valid == 1] != 0.0).any()


def test_cpu_tensors_never_launch_a_kernel():
    runtime.reset_launch_counts()
    xs, w, y, beta, valid = _inputs(2, 16, 3, seed=1)
    ops.batched_gram(*_t(xs, w, y))
    ops.batched_predict(*_t(xs, beta, valid))
    ops.batched_gram_blocked(*_t(xs.reshape(2, 2, 8, 3), w.reshape(2, 2, 8),
                                 y.reshape(2, 2, 8)))
    ops.crossfit_gram(*_t(xs[0], w, y))
    assert runtime.launch_counts == {"batched_gram": 0,
                                     "batched_gram_blocked": 0,
                                     "batched_predict": 0,
                                     "crossfit_gram": 0,
                                     "flash_attention": 0,
                                     "ssd_scan": 0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "ndim"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    xs, w, y, beta, valid = _t(*_inputs(2, 16, 4, seed=2))
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.batched_gram(xs.double(), w, y)
        with pytest.raises(TypeError):
            ops.batched_predict(xs, beta.half(), valid)
    elif bad == "shape":
        with pytest.raises(ValueError):
            ops.batched_gram(xs, w[:, :-1], y)
        with pytest.raises(ValueError):
            ops.batched_predict(xs, beta[:, :-1], valid)
    elif bad == "strides":
        with pytest.raises(ValueError):
            ops.batched_gram(xs.transpose(1, 2).contiguous().transpose(1, 2),
                             w, y)
    else:
        with pytest.raises(ValueError):
            ops.batched_predict(xs[0], beta, valid)


def test_cuda_wrappers_raise_on_cpu_tensors():
    """The kernel entry points themselves never take the plain route."""
    xs, w, y, beta, valid = _t(*_inputs(2, 16, 4, seed=3))
    with pytest.raises(ValueError):
        megabatch.batched_gram_cuda(xs, w, y)
    with pytest.raises(ValueError):
        megabatch.batched_predict_cuda(xs, beta, valid)


# ---------------------------------------------------------------------------
# the streaming blocked Gram (K3)
# ---------------------------------------------------------------------------
# (B, C, Nc, P): Nc a multiple of the reference's 256-row block (exact
# tiling), a multiple of 8 only, and ragged
BLOCKED_SHAPES = [(8, 2, 256, 8), (3, 4, 64, 5), (5, 3, 37, 7),
                  (2, 1, 100, 33), (9, 2, 13, 3)]


def _pallas_gram_blocked(xc, w, y):
    """batched_gram_blocked_pallas in interpret mode, padded as the
    reference wrapper pads: P to 128 lanes, Nc to the row block (256 when
    it tiles Nc exactly, else 8), B to 8."""
    b, c, nc, p = xc.shape
    bn = 256 if nc % 256 == 0 and nc >= 256 else 8
    xp = _pad(_pad(_pad(xc, 3, 128), 2, bn), 0, 8)
    wp = _pad(_pad(w, 2, bn), 0, 8)
    yp = _pad(_pad(y, 2, bn), 0, 8)
    g, bv = batched_gram_blocked_pallas(jnp.asarray(xp), jnp.asarray(wp),
                                        jnp.asarray(yp), block_b=8,
                                        block_n=bn, interpret=True)
    return np.asarray(g)[:b, :p, :p], np.asarray(bv)[:b, :p]


def _blocked_inputs(b, c, nc, p, seed):
    xs, w, y, _, _ = _inputs(b, c * nc, p, seed)
    return xs.reshape(b, c, nc, p), w.reshape(b, c, nc), y.reshape(b, c, nc)


@pytest.mark.parametrize("b,c,nc,p", BLOCKED_SHAPES)
def test_batched_gram_blocked_matches_pallas_interpret(b, c, nc, p):
    xc, w, y = _blocked_inputs(b, c, nc, p, seed=b + c + nc + p)
    g, bv = ops.batched_gram_blocked(*_t(xc, w, y))
    assert g.dtype == torch.float32 and tuple(g.shape) == (b, p, p)
    assert bv.dtype == torch.float32 and tuple(bv.shape) == (b, p)
    g0, b0 = _pallas_gram_blocked(xc, w, y)
    _close(g.numpy(), g0)
    _close(bv.numpy(), b0)


@pytest.mark.parametrize("b,c,nc,p", BLOCKED_SHAPES)
def test_batched_gram_blocked_is_batched_gram_on_the_merged_tensor(b, c, nc,
                                                                    p):
    """The plain version merges the chunk axis, a relayout: bitwise
    ``batched_gram`` on (B, C*Nc, P), and equal to the jnp oracle."""
    xc, w, y = _blocked_inputs(b, c, nc, p, seed=3 * b + nc)
    g, bv = ops.batched_gram_blocked(*_t(xc, w, y), reg=0.5)
    g1, b1 = ops.batched_gram(*_t(xc.reshape(b, c * nc, p),
                                  w.reshape(b, c * nc), y.reshape(b, c * nc)),
                              reg=0.5)
    assert torch.equal(g, g1) and torch.equal(bv, b1)
    g0, b0 = ref.batched_gram_blocked_ref(jnp.asarray(xc), jnp.asarray(w),
                                          jnp.asarray(y), 0.5)
    _close(g.numpy(), np.asarray(g0))
    _close(bv.numpy(), np.asarray(b0))


def test_batched_gram_blocked_padding_chunks_are_inert():
    """chunk_tall_n pads a ragged tail with w == 0 rows: poison them."""
    xs, w, y, _, _ = _inputs(4, 90, 6, seed=9)
    xc, wc, yc = ops.chunk_tall_n(*_t(xs, w, y), 32)
    assert tuple(xc.shape) == (4, 3, 32, 6)
    g0, b0 = ops.batched_gram_blocked(xc, wc, yc)
    poisoned = xc.clone()
    poisoned.view(4, 96, 6)[:, 90:] = 1e6
    g1, b1 = ops.batched_gram_blocked(poisoned, wc, yc)
    assert torch.equal(g0, g1) and torch.equal(b0, b1)
    g2, b2 = _pallas_gram_blocked(poisoned.numpy(), wc.numpy(), yc.numpy())
    _close(g1.numpy(), g2)
    _close(b1.numpy(), b2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "ndim"])
def test_blocked_wrapper_refuses_what_the_kernel_does_not_take(bad):
    xc, w, y = _t(*_blocked_inputs(2, 2, 8, 4, seed=2))
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.batched_gram_blocked(xc, w.double(), y)
    elif bad == "shape":
        with pytest.raises(ValueError):
            ops.batched_gram_blocked(xc, w[:, :, :-1], y)
    elif bad == "strides":
        with pytest.raises(ValueError):
            ops.batched_gram_blocked(
                xc.transpose(2, 3).contiguous().transpose(2, 3), w, y)
    else:
        with pytest.raises(ValueError):
            ops.batched_gram_blocked(xc[0], w, y)


def test_blocked_cuda_wrapper_raises_on_cpu_tensors():
    xc, w, y = _t(*_blocked_inputs(2, 2, 8, 4, seed=3))
    with pytest.raises(ValueError, match="card"):
        megabatch.batched_gram_blocked_cuda(xc, w, y)
