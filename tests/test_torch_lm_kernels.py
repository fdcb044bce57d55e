"""The port's attention (K5) and SSD-scan (K6) kernel wrappers against the
JAX package's.

On the CPU the port's ``ops`` wrappers run each kernel's plain PyTorch
version; the reference side runs the Pallas kernels in interpret mode and
the jnp oracles of ``repro.kernels.ref``, on the reference's own sweeps.
Inputs come from numpy with a seed; bf16 inputs are rounded from the same
float32 arrays on both sides.  Tolerances are the reference's own
(``tests/test_kernels.py``): max abs error 2e-4 in float32 and 2e-2 in
bf16 for attention; 2e-4 of max|y| for the scan (and of max|state| for its
final state).  The card's routes — heads folded into the kernels' lanes,
bm/cm shared by the heads of a batch row — are exercised here too: on CPU
tensors ``ops`` hands the folded operands to the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch import runtime
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

TOL = {"f32": 2e-4, "bf16": 2e-2}
JT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a, dtype):
    """The same float32 numpy array as a jax and a torch array of
    ``dtype`` (both round to nearest even)."""
    return (jnp.asarray(a).astype(JT[dtype]),
            torch.from_numpy(a).to(TT[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash_attention (K5)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,skv,d,bq,bk", [
    (128, 128, 32, 64, 64), (256, 256, 64, 64, 128),
    (64, 256, 32, 32, 64),                       # chunked-prefill shape
])
@pytest.mark.parametrize("causal,window", [
    (True, None), (True, 48), (False, None),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_plain_matches_reference(sq, skv, d, bq, bk, causal,
                                                 window, dtype):
    rng = np.random.default_rng(sq + skv + d)
    jq, tq = _pair(rng.standard_normal((3, sq, d), dtype=np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((3, skv, d), dtype=np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((3, skv, d), dtype=np.float32), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TT[dtype] and got.shape == (3, sq, d)
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=bq, block_k=bk, interpret=True)
    assert np.abs(_f32(got) - _f32(want)).max() < TOL[dtype]
    assert np.abs(_f32(got) - _f32(pallas)).max() < TOL[dtype]
    plain = fa_mod.flash_attention_plain(tq, tk, tv, causal=causal,
                                         window=window)
    assert torch.equal(got, plain)


def test_flash_attention_uniform_values():
    """With identical V rows the output equals V regardless of scores."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 64, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 16), dtype=np.float32))
    v = torch.arange(16, dtype=torch.float32).expand(2, 64, 16).contiguous()
    o = ops.flash_attention(q, k, v, causal=True, window=None)
    torch.testing.assert_close(o, v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None), (False, 16)])
def test_card_attention_route_matches_attention_core(causal, window):
    """The card's route (heads folded into BH, the suffix-aligned kernel
    contract) against the reference's chunked jnp math on the CPU."""
    rng = np.random.default_rng(7)
    b, s, h, d = 2, 100, 4, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                    dtype=np.float32))
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    got = L.flash_attention_heads(q, k, v, None, causal=causal,
                                  window=window)
    for chunk in (32, 1024):
        want = L.attention_core(q, k, v, pos, pos, causal=causal,
                                window=window, chunk=chunk)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_card_attention_route_refuses_other_positions():
    """The route takes only positions=None (arange(S)): a positions tensor
    and keys of another length raise."""
    q = torch.zeros((1, 8, 2, 16))
    shifted = torch.arange(8, dtype=torch.int32)[None] + 3
    with pytest.raises(ValueError, match="arange"):
        L.flash_attention_heads(q, q, q, shifted, causal=True, window=None)
    with pytest.raises(ValueError, match="arange"):
        L.flash_attention_heads(q, torch.zeros((1, 9, 2, 16)),
                                torch.zeros((1, 9, 2, 16)), causal=True,
                                window=None)


def _tc_schedule(q, k, v, *, causal, window, split=True, block_k=64):
    """Plain emulation of the bfloat16 tensor-core kernel's arithmetic
    (``flash_attention_tc_kernel`` in ``csrc/lm.cu``): 64-key tiles in
    order, S from the bf16 operands summed in float32 and then scaled by
    log2(e)/sqrt(D) in float32, online softmax with exp2 (a row that has
    seen no key subtracts 0), l summed from the float32 P, and P V with P
    split into bf16 hi + lo (``split=False``: one bf16 rounding of P)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) \
        * torch.tensor(np.log2(np.e), dtype=torch.float32)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((bh, sq), float("-inf"))
    l = torch.zeros((bh, sq))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, skv, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, skv))[None, :]
        x = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + block_k]) \
            * scale_log2
        ok = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = x.masked_fill(~ok[None], float("-inf"))
        m_new = torch.maximum(m, x.max(dim=-1).values)
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                         m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(x - mu[..., None])
        l = l * corr + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bqk,bkd->bqd", hi, vf[:, k0:k0 + block_k])
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bqk,bkd->bqd", lo,
                                   vf[:, k0:k0 + block_k])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16)


def _bf16_steps(o, o0):
    """Largest |o - o0| in bf16 steps at |o0|, after 1e-4 absolute (the
    per-element measure chip_smoke.py holds the kernel to)."""
    o, o0 = o.astype(np.float32), o0.astype(np.float32)
    _, e = np.frexp(o0)
    step = np.ldexp(np.float32(1.0), e - 8)
    return float(((np.abs(o - o0) - 1e-4) / step).max())


@pytest.mark.parametrize("split,bh,sq,skv,d,causal,window", [
    (True, 4, 128, 128, 32, True, None),
    (True, 4, 200, 200, 120, True, None),         # D 120: padded depth
    (True, 4, 256, 256, 64, True, 48),            # window inside a tile
    (True, 4, 100, 160, 32, True, 64),            # ragged Sq < Skv
    (True, 4, 130, 130, 120, False, None),        # ragged, non-causal
    (True, 2, 64, 300, 112, False, 100),
    (False, 4, 256, 256, 64, True, None),         # one rounding of P
])
def test_tensor_core_schedule_matches_reference_per_element(
        split, bh, sq, skv, d, causal, window):
    """The bf16 kernel's schedule against the JAX reference, per element:
    with P split it stays within one bf16 step (plus 1e-4); one bf16
    rounding of P is more than two steps off, which is why the kernel
    splits it."""
    rng = np.random.default_rng(bh * sq + skv + d)
    jq, tq = _pair(rng.standard_normal((bh, sq, d), dtype=np.float32), "bf16")
    jk, tk = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   "bf16")
    jv, tv = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   "bf16")
    got = _f32(_tc_schedule(tq, tk, tv, causal=causal, window=window,
                            split=split))
    want = _f32(ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < TOL["bf16"]
    steps = _bf16_steps(got, want)
    if split:
        assert steps <= 1.0, steps
    else:
        assert steps > 2.0, steps


def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero: the card's ``cvt.rna.tf32.f32``."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_product(eq, a, b, split):
    """``einsum(eq, a, b)`` from TF32 operands summed in float32: with
    ``split`` the three passes a_lo b_hi + a_hi b_lo + a_hi b_hi of the
    float32 kernel, else one TF32 rounding of each operand."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _tf32_schedule(q, k, v, *, causal, window, split=True, block_k=64):
    """Plain emulation of the float32 kernel's arithmetic
    (``flash_attention_tf32_kernel`` in ``csrc/lm.cu``): 64-key tiles in
    order, S from TF32 parts of q and k summed in float32 and then scaled by
    log2(e)/sqrt(D) in float32, online softmax with exp2 (a row that has
    seen no key subtracts 0), l summed from the float32 P, and P V from TF32
    parts of P and v (``split=False``: one TF32 rounding of each)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale_log2 = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) \
        * torch.tensor(np.log2(np.e), dtype=torch.float32)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((bh, sq), float("-inf"))
    l = torch.zeros((bh, sq))
    acc = torch.zeros((bh, sq, d))
    for k0 in range(0, skv, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, skv))[None, :]
        x = _tf32_product("bqd,bkd->bqk", q, k[:, k0:k0 + block_k],
                          split) * scale_log2
        ok = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = x.masked_fill(~ok[None], float("-inf"))
        m_new = torch.maximum(m, x.max(dim=-1).values)
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                         m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(x - mu[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _tf32_product(
            "bqk,bkd->bqd", p, v[:, k0:k0 + block_k], split)
        m = m_new
    return acc / l[..., None]


@pytest.mark.parametrize("split,bh,sq,skv,d,causal,window", [
    (True, 4, 128, 128, 32, True, None),
    (True, 4, 200, 200, 120, True, None),         # D 120: padded depth
    (True, 4, 96, 96, 20, True, None),            # D not a multiple of 8
    (True, 4, 256, 256, 64, True, 48),            # window inside a tile
    (True, 4, 100, 160, 36, True, 64),            # ragged Sq < Skv
    (True, 4, 130, 130, 120, False, None),        # ragged, non-causal
    (True, 2, 64, 300, 112, False, 100),
    (False, 4, 256, 256, 64, True, None),         # one TF32 rounding
])
def test_split_tf32_schedule_matches_reference(split, bh, sq, skv, d,
                                               causal, window):
    """The float32 kernel's schedule against the JAX reference: with every
    operand split into TF32 hi + lo it stays within 2e-5 (the tier
    chip_smoke.py holds the kernel to on the card); one TF32 rounding of
    each operand does not, which is why the kernel splits them."""
    rng = np.random.default_rng(bh * sq + skv + d + 1)
    jq, tq = _pair(rng.standard_normal((bh, sq, d), dtype=np.float32), "f32")
    jk, tk = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   "f32")
    jv, tv = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   "f32")
    got = _f32(_tf32_schedule(tq, tk, tv, causal=causal, window=window,
                              split=split))
    want = _f32(ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window))
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    if split:
        assert err <= 2e-5, err
    else:
        assert err > 2e-5, err


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -11 + 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      3.0e-30, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         float(np.float32(3.0e-30)), 0.0])
    got = _tf32(x)
    assert torch.equal(got[[0, 1, 2, 3, 4, 6]], want[[0, 1, 2, 3, 4, 6]])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = _split(x)
    assert ((hi + lo) - x).abs().max() <= 2.0 ** -21


@pytest.mark.parametrize("d,sq,skv,dtype,ok", [
    (112, 2048, 2048, "bf16", True), (120, 64, 256, "bf16", True),
    (8, 5, 5, "bf16", True), (128, 1, 1, "bf16", True),
    (12, 8, 8, "bf16", False),                    # D % 8 != 0
    (136, 8, 8, "bf16", False),                   # D > 128
    (64, 9, 8, "bf16", False),                    # Sq > Skv
    (12, 9, 8, "f32", True),                      # the float32 kernel
    (136, 8, 8, "f32", False),
])
def test_flash_attention_kernel_shape_limits(d, sq, skv, dtype, ok):
    """The shapes each card kernel takes: the bfloat16 tensor-core kernel
    D % 8 == 0, D <= 128, Sq <= Skv; the float32 one any D <= 128."""
    if ok:
        fa_mod.check_kernel_shape(4, sq, skv, d, TT[dtype])
    else:
        with pytest.raises(ValueError, match="D|Sq"):
            fa_mod.check_kernel_shape(4, sq, skv, d, TT[dtype])


# ---------------------------------------------------------------------------
# ssd_scan (K6)
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, bh, s, p, n, groups=None, decay=2.0):
    g = bh if groups is None else groups
    xb = rng.standard_normal((bh, s, p), dtype=np.float32)
    la = (-rng.random((bh, s)) * decay).astype(np.float32)
    bm = rng.standard_normal((g, s, n), dtype=np.float32)
    cm = rng.standard_normal((g, s, n), dtype=np.float32)
    return xb, la, bm, cm


@pytest.mark.parametrize("s,p,n,chunk", [
    (128, 16, 8, 32), (256, 64, 16, 64), (64, 32, 32, 64),
])
def test_ssd_scan_plain_matches_reference(s, p, n, chunk):
    rng = np.random.default_rng(s + p + n)
    xb, la, bm, cm = _ssd_inputs(rng, 2, s, p, n)
    y, state = ops.ssd_scan(*map(torch.from_numpy, (xb, la, bm, cm)),
                            chunk=chunk)
    assert y.shape == (2, s, p) and state.shape == (2, n, p)
    y0, state0 = ref.ssd_scan_ref(*map(jnp.asarray, (xb, la, bm, cm)))
    y0, state0 = np.asarray(y0), np.asarray(state0)
    scale = max(np.abs(y0).max(), 1.0)
    assert np.abs(y.numpy() - y0).max() / scale < 2e-4
    sscale = max(np.abs(state0).max(), 1.0)
    assert np.abs(state.numpy() - state0).max() / sscale < 2e-4
    yp = np.asarray(ssd_scan_pallas(*map(jnp.asarray, (xb, la, bm, cm)),
                                    chunk=chunk, interpret=True))
    assert np.abs(y.numpy() - yp).max() / scale < 2e-4


@pytest.mark.parametrize("heads", [2, 4])
def test_ssd_scan_shared_bc_matches_broadcast(heads):
    """bm/cm (BH/heads, S, N) shared by a row's heads == the broadcast
    (BH, S, N) form, lane by lane."""
    rng = np.random.default_rng(heads)
    xb, la, bm, cm = _ssd_inputs(rng, 3 * heads, 48, 8, 4, groups=3)
    t = [torch.from_numpy(a) for a in (xb, la, bm, cm)]
    y, state = ops.ssd_scan(*t, chunk=16, heads=heads)
    rep = [a.repeat_interleave(heads, dim=0) for a in t[2:]]
    y1, state1 = ops.ssd_scan(t[0], t[1], *rep, chunk=16)
    torch.testing.assert_close(y, y1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state, state1, rtol=1e-6, atol=1e-6)
    y0, s0 = ref.ssd_scan_ref(jnp.asarray(xb), jnp.asarray(la),
                              *(jnp.asarray(r.numpy()) for r in rep))
    np.testing.assert_allclose(y.numpy(), np.asarray(y0), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(s0), rtol=2e-4,
                               atol=2e-4)


def test_ssd_zero_decay_is_cumulative_outer_product():
    """la = 0 => S_t = sum_j<=t B_j x_j^T: y_t = C_t . cumsum."""
    rng = np.random.default_rng(0)
    xb, _, bm, cm = _ssd_inputs(rng, 1, 32, 4, 3)
    la = np.zeros((1, 32), np.float32)
    y, state = ops.ssd_scan(*map(torch.from_numpy, (xb, la, bm, cm)),
                            chunk=16)
    states = np.cumsum(np.einsum("bsn,bsp->bsnp", bm, xb), axis=1)
    y0 = np.einsum("bsn,bsnp->bsp", cm, states)
    np.testing.assert_allclose(y.numpy(), y0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), states[:, -1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [2, 64, 500])
def test_ssd_strong_decay_forgets(seed):
    """la = -50: the state resets, y_t = C_t.(B_t x_t^T) only."""
    rng = np.random.default_rng(seed)
    xb, _, bm, cm = _ssd_inputs(rng, 1, 64, 8, 4)
    la = np.full((1, 64), -50.0, np.float32)
    y, _ = ops.ssd_scan(*map(torch.from_numpy, (xb, la, bm, cm)), chunk=16)
    y0 = np.einsum("bsn,bsn,bsp->bsp", cm, bm, xb)
    np.testing.assert_allclose(y.numpy(), y0, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("s,chunk", [(100, 16), (64, 64), (37, 256)])
def test_card_ssd_route_matches_chunked(s, chunk):
    """ssd_chunked's card route (heads folded into lanes, B and C shared
    per batch row, one scan call) against its chunked CPU math, ragged S
    included."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 4
    xbar = torch.from_numpy(rng.standard_normal((b, s, h, p),
                                                dtype=np.float32))
    la = torch.from_numpy((-rng.random((b, s, h)) * 2).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n),
                                                   dtype=np.float32))
              for _ in range(2))
    y, st = S._ssd_kernel_route(xbar, la, bm, cm, chunk)
    y0, st0 = S.ssd_chunked(xbar, la, bm, cm, chunk)
    torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)


def _ssd_schedule(xb, la, bm, cm, *, chunk, heads, split=True):
    """Plain emulation of the SSD kernels' passes (``ssd_*_kernel`` in
    ``csrc/lm.cu``), every product from TF32 parts summed in float32
    (``split=False``: one TF32 rounding of each operand): (a) the scores
    C B^T once per (batch row, chunk); (b) each (lane, chunk)'s own state
    (B * exp(cl_Q - cl))^T x and decay exp(cl_Q); (c) the states entering
    the chunks, passed in order; (d) y = exp(cl) * (C S) + W x with W the
    scores decayed by exp(clip(cl_i - cl_j, -60, 0)) and masked in
    float32.  Returns y (BH, S, P) and the final state (BH, N, P)."""
    x, a, b, c = (torch.from_numpy(t) for t in (xb, la, bm, cm))
    bh, s, p = x.shape
    n = b.shape[-1]
    grp = torch.arange(bh) // heads
    q = min(chunk, s)
    chunks = [slice(t0, min(s, t0 + q)) for t0 in range(0, s, q)]
    scores, cls, local, decay = [], [], [], []
    for sl in chunks:
        cl = torch.cumsum(a[:, sl], dim=1)
        cls.append(cl)
        scores.append(_tf32_product("gin,gjn->gij", c[:, sl], b[:, sl],
                                    split))
        tail = torch.exp(cl[:, -1:] - cl)
        local.append(_tf32_product("hjn,hjp->hnp",
                                   b[grp, sl] * tail[..., None], x[:, sl],
                                   split))
        decay.append(torch.exp(cl[:, -1]))
    state = torch.zeros((bh, n, p))
    entering = []
    for dec, loc in zip(decay, local):
        entering.append(state)
        state = dec[:, None, None] * state + loc
    ys = []
    for sl, cl, sc, st in zip(chunks, cls, scores, entering):
        ln = cl.shape[1]
        d = torch.clamp(cl[:, :, None] - cl[:, None, :], -60.0, 0.0)
        w = torch.where(torch.ones((ln, ln), dtype=torch.bool).tril(),
                        sc[grp] * torch.exp(d), torch.zeros(()))
        ys.append(torch.exp(cl)[..., None]
                  * _tf32_product("hin,hnp->hip", c[grp, sl], st, split)
                  + _tf32_product("hij,hjp->hip", w, x[:, sl], split))
    return torch.cat(ys, dim=1), state


def _ssd_reference(xb, la, bm, cm, *, chunk, heads):
    """y and the final state of ``ssd_scan_ref``, and y of
    ``ssd_scan_pallas`` in interpret mode (S padded to a multiple of the
    chunk with rows that leave y and the state as they are), on bm/cm
    broadcast to every head."""
    bmh, cmh = (np.repeat(t, heads, axis=0) for t in (bm, cm))
    y0, st0 = ref.ssd_scan_ref(*map(jnp.asarray, (xb, la, bmh, cmh)))
    s = xb.shape[1]
    q = min(chunk, s)
    pad = -s % q
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (xb, la, bmh, cmh)]
    yp = ssd_scan_pallas(*map(jnp.asarray, padded), chunk=q, interpret=True)
    return np.asarray(y0), np.asarray(st0), np.asarray(yp)[:, :s]


# (BH, heads, S, P, N, chunk, la): S a multiple of Q, ragged S, S < Q (one
# partial chunk), heads sharing bm/cm and heads = 1, strong decay, and the
# serve path's widths (P = N = 64, Q 256) on a few lanes
SSD_SCHEDULE_CASES = [
    (6, 3, 128, 16, 8, 32, "slow"),
    (4, 2, 100, 16, 16, 32, "slow"),
    (3, 3, 40, 8, 16, 64, "slow"),
    (2, 1, 96, 32, 16, 32, "slow"),
    (4, 2, 64, 16, 8, 16, "strong"),
    (4, 2, 300, 64, 64, 256, "slow"),
]


def _schedule_inputs(bh, heads, s, p, n, decay):
    rng = np.random.default_rng(bh * s + p + n)
    xb, _, bm, cm = _ssd_inputs(rng, bh, s, p, n, groups=bh // heads)
    if decay == "strong":
        la = np.full((bh, s), -50.0, np.float32)
    else:
        la = (-0.1 * rng.random((bh, s))).astype(np.float32)
    return xb, la, bm, cm


@pytest.mark.parametrize("bh,heads,s,p,n,chunk,decay", SSD_SCHEDULE_CASES)
def test_ssd_split_tf32_schedule_matches_reference(bh, heads, s, p, n, chunk,
                                                   decay):
    """The redesigned SSD kernels' schedule against the JAX reference
    (the sequential oracle and the Pallas kernel): y within 2e-5 of max|y|
    and the final state within 2e-5 of max|state|, the split-TF32 tier
    chip_smoke.py holds the kernels to on the card."""
    xb, la, bm, cm = _schedule_inputs(bh, heads, s, p, n, decay)
    y, st = _ssd_schedule(xb, la, bm, cm, chunk=chunk, heads=heads)
    y0, st0, yp = _ssd_reference(xb, la, bm, cm, chunk=chunk, heads=heads)
    y, st = y.numpy(), st.numpy()
    assert np.isfinite(y).all() and np.isfinite(st).all()
    scale_y, scale_s = np.abs(y0).max(), np.abs(st0).max()
    assert np.abs(y - y0).max() <= 2e-5 * scale_y
    assert np.abs(y - yp).max() <= 2e-5 * scale_y
    assert np.abs(st - st0).max() <= 2e-5 * scale_s


def test_ssd_one_tf32_rounding_leaves_the_tier():
    """One TF32 rounding of each operand, at the serve path's widths, puts
    y more than 2e-5 of max|y| off the reference: why the kernels split
    every operand into hi and lo."""
    bh, heads, s, p, n, chunk, decay = SSD_SCHEDULE_CASES[-1]
    xb, la, bm, cm = _schedule_inputs(bh, heads, s, p, n, decay)
    y, _ = _ssd_schedule(xb, la, bm, cm, chunk=chunk, heads=heads,
                         split=False)
    y0, _, _ = _ssd_reference(xb, la, bm, cm, chunk=chunk, heads=heads)
    assert np.abs(y.numpy() - y0).max() > 2e-5 * np.abs(y0).max()


@pytest.mark.parametrize("bh,s,p,n,chunk,heads,want", [
    (448, 2048, 64, 64, 256, 112,
     ((4, 8, 256, 256), (448, 8, 64, 64), (448, 8))),
    (112, 200, 64, 64, 256, 112,
     ((1, 1, 256, 256), (112, 1, 64, 64), (112, 1))),
    (16, 100, 16, 16, 16, 8, ((2, 7, 64, 64), (16, 7, 16, 16), (16, 7))),
    (8, 777, 64, 64, 256, 1, ((8, 4, 256, 256), (8, 4, 64, 64), (8, 4))),
])
def test_ssd_scratch_shapes(bh, s, p, n, chunk, heads, want):
    """The wrapper's scratch: scores per (batch row, chunk) with the chunk
    padded to 64 rows, a state and a decay per (lane, chunk)."""
    assert ssd_mod.scratch_shapes(bh, s, p, n, chunk, heads) == want


@pytest.mark.parametrize("bh,s,p,n,chunk,ok", [
    (448, 2048, 64, 64, 256, True),
    # 586 sequences of zamba2's 112 heads: past 65536 lanes
    (586 * 112, 2048, 64, 64, 256, True),
    (2 ** 20, 777, 64, 64, 256, True),
    (8, 777, 65, 64, 256, False),
    (8, 777, 64, 65, 256, False),
    (8, 777, 64, 64, 257, False),
    (8, 200, 64, 64, 257, True),          # the chunk is cut to S
    (1, 2 ** 25, 64, 64, 256, False),     # S * max(N, P) reaches 2**31
    (2 ** 20, 2 ** 12, 1, 1, 1, False),   # 2**32 blocks of the outputs
])
def test_ssd_kernel_shape_limits(bh, s, p, n, chunk, ok):
    """The kernels take any BH while their grids fit: only N, P, the chunk
    and the index ranges are limited."""
    if ok:
        ssd_mod.check_kernel_shape(bh, s, p, n, chunk)
    else:
        with pytest.raises(ValueError, match="limits"):
            ssd_mod.check_kernel_shape(bh, s, p, n, chunk)


# ---------------------------------------------------------------------------
# routing and the wrappers' checks
# ---------------------------------------------------------------------------
def test_cpu_tensors_never_launch_a_kernel():
    runtime.reset_launch_counts()
    q = torch.zeros((2, 8, 16))
    ops.flash_attention(q, q, q, causal=True, window=None)
    x = torch.zeros((2, 8, 4))
    ops.ssd_scan(x, torch.zeros((2, 8)), torch.zeros((1, 8, 3)),
                 torch.zeros((1, 8, 3)), chunk=4, heads=2)
    assert set(runtime.launch_counts.values()) == {0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "window"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros((2, 8, 16))
    k = torch.zeros((2, 8, 16))
    window = None
    if bad == "dtype":
        k = k.to(torch.float64)
    elif bad == "shape":
        k = torch.zeros((2, 8, 8))
    elif bad == "strides":
        k = torch.zeros((2, 16, 8)).transpose(1, 2)
    else:
        window = 0
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, k, causal=True, window=window)


@pytest.mark.parametrize("bad", ["dtype", "la", "heads", "bm", "chunk"])
def test_ssd_scan_refuses_what_the_kernel_does_not_take(bad):
    x, la = torch.zeros((4, 8, 4)), torch.zeros((4, 8))
    bm = torch.zeros((2, 8, 3))
    heads, chunk = 2, 4
    if bad == "dtype":
        x = x.to(torch.bfloat16)
    elif bad == "la":
        la = torch.zeros((4, 7))
    elif bad == "heads":
        heads = 3
    elif bad == "bm":
        bm = torch.zeros((4, 8, 3))
    else:
        chunk = 0
    with pytest.raises((TypeError, ValueError)):
        ops.ssd_scan(x, la, bm, torch.zeros((2, 8, 3)), chunk=chunk,
                     heads=heads)


def test_cuda_wrappers_take_only_card_tensors():
    """The kernels' wrappers refuse CPU tensors before building anything:
    on the card a wrapper launches or raises, it never falls back."""
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="card"):
        fa_mod.flash_attention_cuda(q, q, q, causal=True)
    x = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="card"):
        ssd_mod.ssd_scan_cuda(x, torch.zeros((2, 8)), torch.zeros((2, 8, 3)),
                              torch.zeros((2, 8, 3)), chunk=4)
