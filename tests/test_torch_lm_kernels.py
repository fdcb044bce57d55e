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
tensors ``ops`` hands the folded operands to the plain versions.  K5's
backward: its plain version and both backward kernels' schedules
(emulated) against ``jax.vjp`` of the reference's oracle, its shape
limits, the C entry points against the ctypes signatures they are bound
with, and the refusal of every kernel without a backward to take an
input that needs a gradient.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import runtime
from repro_torch.kernels import build
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
    acc = torch.zeros((bh, sq, v.shape[-1]))
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
    acc = torch.zeros((bh, sq, v.shape[-1]))
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
# flash_attention at Dqk != Dv (MLA's prefill: the rope channel folded into
# the head).  The Pallas kernel takes one depth, so the JAX counterpart is
# the reference's attention_core (src/repro/models/layers.py), which scales
# by 1/sqrt(Dqk) as the kernels do.
# ---------------------------------------------------------------------------
def _attention_core_folded(q, k, v, *, causal, window):
    """The reference's attention_core on folded (BH, S, D) operands (the
    lanes as heads of one batch row), queries aligned to the keys'
    suffix."""
    sq, skv = q.shape[1], k.shape[1]
    heads = [jnp.swapaxes(t, 0, 1)[None] for t in (q, k, v)]
    q_pos = jnp.arange(skv - sq, skv, dtype=jnp.int32)[None]
    k_pos = jnp.arange(skv, dtype=jnp.int32)[None]
    o = JL.attention_core(*heads, q_pos, k_pos, causal=causal,
                          window=window, chunk=64)
    return jnp.swapaxes(o[0], 0, 1)


DQK_DV_CASES = [
    (4, 100, 100, 48, 32, True, None),      # reduced MLA
    (2, 130, 130, 192, 128, True, None),    # deepseek's depths, ragged
    (2, 64, 200, 184, 120, True, 64),       # Sq < Skv, window, padded depths
    (2, 96, 96, 192, 128, False, None),
]


# cross-attention: keys of their own length, nothing masked — more queries
# than keys (the VLM's 2048 against 1601 image tokens) and fewer (whisper's
# prompt against 1500 frames), ragged tiles on both sides
CROSS_CASES = [
    (4, 300, 100, 32, 32, False, None),
    (2, 200, 137, 128, 128, False, None),
    (2, 100, 333, 64, 64, False, None),
]


@pytest.mark.parametrize("bh,sq,skv,d,dv,causal,window", CROSS_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_plain_at_sq_ne_skv_matches_attention_core(
        bh, sq, skv, d, dv, causal, window, dtype):
    rng = np.random.default_rng(bh * sq + skv + d)
    jq, tq = _pair(rng.standard_normal((bh, sq, d), dtype=np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   dtype)
    jv, tv = _pair(rng.standard_normal((bh, skv, dv), dtype=np.float32),
                   dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TT[dtype] and tuple(got.shape) == (bh, sq, dv)
    want = _attention_core_folded(jq, jk, jv, causal=causal, window=window)
    assert np.abs(_f32(got) - _f32(want)).max() < TOL[dtype]


@pytest.mark.parametrize("bh,sq,skv,d,dv,causal,window", CROSS_CASES)
@pytest.mark.parametrize("kernel", ["bf16", "f32"])
def test_kernel_schedules_at_sq_ne_skv_match_attention_core(
        bh, sq, skv, d, dv, causal, window, kernel):
    """Both kernels' schedules with Sq != Skv and no mask (the suffix
    offset Skv - Sq negative where Sq > Skv, and never read): the bf16 one
    within a bf16 step of the reference per element, the split-TF32 one
    within 2e-5."""
    rng = np.random.default_rng(bh * sq + skv + d + 1)
    jq, tq = _pair(rng.standard_normal((bh, sq, d), dtype=np.float32),
                   kernel)
    jk, tk = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   kernel)
    jv, tv = _pair(rng.standard_normal((bh, skv, dv), dtype=np.float32),
                   kernel)
    schedule = _tc_schedule if kernel == "bf16" else _tf32_schedule
    got = _f32(schedule(tq, tk, tv, causal=causal, window=window))
    want = _f32(_attention_core_folded(jq.astype(jnp.float32),
                                       jk.astype(jnp.float32),
                                       jv.astype(jnp.float32),
                                       causal=causal, window=window))
    assert got.shape == (bh, sq, dv) and np.isfinite(got).all()
    if kernel == "bf16":
        assert _bf16_steps(got, want) <= 1.0
    else:
        assert np.abs(got - want).max() <= 2e-5


@pytest.mark.parametrize("sq,skv,causal,window,ok", [
    (2048, 1601, False, None, True),     # the VLM's cross-attention
    (400, 1500, False, None, True),      # whisper's
    (9, 8, True, None, False),           # its first query would see no key
    (9, 8, False, 4, False),
    (9, 8, True, 4, False),
])
def test_flash_attention_bf16_takes_more_queries_only_unmasked(
        sq, skv, causal, window, ok):
    if ok:
        fa_mod.check_kernel_shape(4, sq, skv, 128, torch.bfloat16,
                                  causal=causal, window=window)
    else:
        with pytest.raises(ValueError, match="Sq"):
            fa_mod.check_kernel_shape(4, sq, skv, 128, torch.bfloat16,
                                      causal=causal, window=window)


@pytest.mark.parametrize("bh,sq,skv,d,dv,causal,window", DQK_DV_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_plain_at_dqk_ne_dv_matches_attention_core(
        bh, sq, skv, d, dv, causal, window, dtype):
    rng = np.random.default_rng(bh * sq + d + dv)
    jq, tq = _pair(rng.standard_normal((bh, sq, d), dtype=np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   dtype)
    jv, tv = _pair(rng.standard_normal((bh, skv, dv), dtype=np.float32),
                   dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TT[dtype] and tuple(got.shape) == (bh, sq, dv)
    want = _attention_core_folded(jq, jk, jv, causal=causal, window=window)
    assert np.abs(_f32(got) - _f32(want)).max() < TOL[dtype]


@pytest.mark.parametrize("bh,sq,skv,d,dv,causal,window", DQK_DV_CASES)
@pytest.mark.parametrize("kernel", ["bf16", "f32"])
def test_kernel_schedules_at_dqk_ne_dv_match_attention_core(
        bh, sq, skv, d, dv, causal, window, kernel):
    """Both kernels' schedules with v at its own depth: the bf16 one
    within a bf16 step of the reference per element, the split-TF32 one
    within 2e-5."""
    rng = np.random.default_rng(bh * sq + d + dv + 1)
    jq, tq = _pair(rng.standard_normal((bh, sq, d), dtype=np.float32),
                   kernel)
    jk, tk = _pair(rng.standard_normal((bh, skv, d), dtype=np.float32),
                   kernel)
    jv, tv = _pair(rng.standard_normal((bh, skv, dv), dtype=np.float32),
                   kernel)
    schedule = _tc_schedule if kernel == "bf16" else _tf32_schedule
    got = _f32(schedule(tq, tk, tv, causal=causal, window=window))
    want = _f32(_attention_core_folded(jq.astype(jnp.float32),
                                       jk.astype(jnp.float32),
                                       jv.astype(jnp.float32),
                                       causal=causal, window=window))
    assert got.shape == (bh, sq, dv) and np.isfinite(got).all()
    if kernel == "bf16":
        assert _bf16_steps(got, want) <= 1.0
    else:
        assert np.abs(got - want).max() <= 2e-5


@pytest.mark.parametrize("d,dv,dtype,ok", [
    (192, 128, "bf16", True), (184, 120, "bf16", True),
    (48, 32, "bf16", True), (44, 32, "f32", True), (190, 128, "f32", True),
    (200, 128, "bf16", False),                    # Dqk past 192
    (192, 136, "f32", False),                     # Dv past 128
    (176, 128, "bf16", False),                    # a pair not built
    (192, 124, "bf16", False),                    # Dv % 8 != 0 in bf16
    (120, 128, "f32", False),                     # an equal pair, D != Dv
])
def test_flash_attention_depth_pairs(d, dv, dtype, ok):
    """The (Dqk, Dv) pairs the kernels are built for, rounded up to 16:
    equal depths up to 128 (where Dqk == Dv), deepseek-v2-lite's (192,
    128) and its reduced variant's (48, 32)."""
    if ok:
        fa_mod.check_kernel_shape(4, 64, 64, d, TT[dtype], dv)
    else:
        with pytest.raises(ValueError, match="D"):
            fa_mod.check_kernel_shape(4, 64, 64, d, TT[dtype], dv)


def test_check_qkv_takes_v_at_its_own_depth():
    q, k = torch.zeros((2, 8, 48)), torch.zeros((2, 8, 48))
    assert fa_mod.check_qkv(q, k, torch.zeros((2, 8, 32)), None) == \
        (2, 8, 8, 48, 32)
    with pytest.raises(ValueError, match="Skv"):
        fa_mod.check_qkv(q, torch.zeros((2, 8, 32)), torch.zeros((2, 8, 32)),
                         None)


# ---------------------------------------------------------------------------
# flash_attention's backward (K5's gradient).  The reference differentiates
# its jnp attention (its Pallas kernel has no VJP): jax.vjp of
# ``flash_attention_ref`` is the oracle of the plain backward and of the
# kernels' schedules, emulated here as the CUDA kernels compute them.
# ---------------------------------------------------------------------------
BWD_CASES = [
    (4, 96, 96, 32, 32, True, None),
    (4, 128, 128, 64, 64, True, 48),        # windowed
    (4, 80, 80, 32, 32, False, None),       # not masked
    (2, 100, 160, 32, 32, True, 64),        # Sq < Skv, suffix-aligned
    (2, 150, 70, 32, 32, False, None),      # Sq > Skv, nothing masked
    (2, 60, 130, 64, 64, False, None),      # Sq < Skv, nothing masked
    (2, 96, 96, 48, 32, True, None),        # Dqk != Dv (reduced MLA)
    (2, 70, 70, 120, 120, True, None),      # D 120: padded depth
]


def _bwd_inputs(bh, sq, skv, d, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d), dtype=np.float32),
            rng.standard_normal((bh, skv, d), dtype=np.float32),
            rng.standard_normal((bh, skv, dv), dtype=np.float32),
            rng.standard_normal((bh, sq, dv), dtype=np.float32))


def _jax_grads(q, k, v, do, *, causal, window):
    """(dq, dk, dv) of the reference's attention oracle, by jax.vjp."""
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_ref(
        a, b, c, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _grad_err(got, want):
    """Largest |got - want| over dq, dk, dv, each as a fraction of its
    largest |want|."""
    return max(float(np.abs(_f32(g) - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("bh,sq,skv,d,dv,causal,window", BWD_CASES)
def test_flash_attention_backward_plain_matches_jax_grad(
        bh, sq, skv, d, dv, causal, window):
    """The explicit backward (from the plain o and lse) against jax.vjp of
    the reference's oracle, in float32, within 1e-5 of each gradient's
    largest magnitude; and autograd through the plain forward (the CPU
    route) against it too."""
    q, k, v, do = _bwd_inputs(bh, sq, skv, d, dv, bh * sq + skv + d + dv)
    want = _jax_grads(q, k, v, do, causal=causal, window=window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa_mod.flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window)
    lse = fa_mod.flash_attention_lse_plain(tq, tk, causal=causal,
                                           window=window)
    got = fa_mod.flash_attention_backward_plain(
        tq, tk, tv, o, lse, tdo, causal=causal, window=window)
    assert all(g.dtype == torch.float32 for g in got)
    assert _grad_err(got, want) <= 1e-5
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ops.flash_attention(*leaves, causal=causal, window=window).backward(tdo)
    assert _grad_err([t.grad for t in leaves], want) <= 1e-5


def _bf16_rz(x):
    """float32 to bf16 rounded toward zero (as float32)."""
    return (x.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)


def _bf16_parts(x):
    """float32 x as three bf16 parts (as float32) b0 + b1 + b2, each the
    remainder so far rounded to nearest, b0 toward zero where rounding to
    nearest overflows: the float32 backward's ``ab_split`` in
    ``csrc/attn_bwd.cu``."""
    b0 = x.to(torch.bfloat16).float()
    b0 = torch.where(torch.isinf(b0) & torch.isfinite(x), _bf16_rz(x), b0)
    r = x - b0
    b1 = r.to(torch.bfloat16).float()
    return b0, b1, (r - b1).to(torch.bfloat16).float()


# the float32 backward's passes (parts of A, of B), smallest first
SPLIT_PASSES = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _bf16x3_product(eq, a, b):
    """``einsum(eq, a, b)`` as the float32 backward forms each product: both
    operands split into three bf16 parts, six passes summed in float32 in
    the kernel's order."""
    pa, pb = _bf16_parts(a), _bf16_parts(b)
    out = None
    for i, j in SPLIT_PASSES:
        term = torch.einsum(eq, pa[i], pb[j])
        out = term if out is None else out + term
    return out


def _bwd_schedule(q, k, v, o, lse, do, *, causal, window, kernel):
    """Plain emulation of the backward kernels' arithmetic
    (``csrc/attn_bwd.cu``) — bf16: ``attn_bwd_delta_kernel`` and
    ``attn_bwd_kernel`` (its ``attn_bwd_dkdv`` and ``attn_bwd_dq``
    blocks); float32: ``attn_bwd_split_kernel`` and
    ``attn_bwd_f32_kernel``: delta = rowsum(dO o O) in float32; S from the
    operands summed in float32, P = exp2(S log2(e)/sqrt(D) - lse log2(e))
    where visible; bf16: P' and dS' (the accumulator fragments) rounded
    once to bf16 as the A operands of their products with bf16 dO, Q and K,
    dK and dQ scaled by 1/sqrt(D) in float32, then every gradient rounded
    to bf16; float32: every product of three-part bf16 operands (P' and
    dS' split too) in six passes.  The sums' order over tiles and within
    the tensor cores is not emulated."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    ok = fa_mod.visible(sq, skv, causal, window, "cpu")
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    f = [t.float() for t in (q, k, v, o, do)]
    qf, kf, vf, of, dof = f
    if kernel == "bf16":
        def prod(eq, a, b, round_a=False):
            if round_a:
                a = a.to(torch.bfloat16).float()
            return torch.einsum(eq, a, b)
    else:
        def prod(eq, a, b, round_a=False):
            return _bf16x3_product(eq, a, b)
    s = prod("bqd,bkd->bqk", qf, kf)
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    p = p.masked_fill(~ok[None], 0.0)
    delta = (dof * of).sum(-1)
    dv = prod("bkq,bqd->bkd", p.transpose(1, 2), dof, round_a=True)
    dp = prod("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dk = prod("bkq,bqd->bkd", ds.transpose(1, 2), qf, round_a=True) * scale
    dq = prod("bqk,bkd->bqd", ds, kf, round_a=True) * scale
    out = (dq, dk, dv)
    if kernel == "bf16":
        out = tuple(t.to(torch.bfloat16) for t in out)
    return out


@pytest.mark.parametrize("bh,sq,skv,d,dv,causal,window", BWD_CASES)
@pytest.mark.parametrize("kernel", ["bf16", "f32"])
def test_backward_schedules_match_jax_grad(bh, sq, skv, d, dv, causal,
                                           window, kernel):
    """Both backward kernels' schedules against jax.vjp of the reference:
    bf16 operands (P and dS rounded once to bf16) within ATTN_TOL's 2e-2
    of each gradient's largest magnitude (measured here: 3.6e-3 to 4.7e-3,
    about one bf16 step at that magnitude; per element, near-zero entries
    of dq and dk are many steps off, since dS = P o (dP - delta) cancels);
    float32 (three bf16 parts, six passes) within 2e-5 (measured: 4.9e-7
    to 8.3e-7)."""
    q, k, v, do = _bwd_inputs(bh, sq, skv, d, dv, bh + sq + skv + d + dv)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TT[kernel])
                       for a in (q, k, v, do))
    o = fa_mod.flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window)
    lse = fa_mod.flash_attention_lse_plain(tq, tk, causal=causal,
                                           window=window)
    got = _bwd_schedule(tq, tk, tv, o, lse, tdo, causal=causal,
                        window=window, kernel=kernel)
    want = _jax_grads(*(_f32(t) for t in (tq, tk, tv, tdo)), causal=causal,
                      window=window)
    assert all(np.isfinite(_f32(g)).all() for g in got)
    if kernel == "bf16":
        assert _grad_err(got, want) <= TOL["bf16"]
    else:
        assert _grad_err(got, want) <= 2e-5


@pytest.mark.parametrize("magnitude", ["normal", "tiny", "large"])
def test_bf16_three_part_split_reconstructs_float32(magnitude):
    """The float32 backward's split of an operand into three bf16 parts:
    b0 + b1 + b2 == x exactly wherever |x| >= 2**-110 (24 significant bits
    in three 8-bit parts, the last a multiple of bf16's smallest step),
    within half of that step (2**-134) below it, with |b1| <= 2**-8 |x| and
    |b2| <= 2**-16 |x| where b0 rounds to nearest; at the top of the
    range, where b0 rounded to nearest would overflow, b0 rounds toward
    zero and the parts stay finite and exact."""
    rng = np.random.default_rng({"normal": 0, "tiny": 1, "large": 2}
                                [magnitude])
    base = rng.standard_normal(20000)
    if magnitude == "normal":
        x = base * 10.0 ** rng.uniform(-6, 6, base.shape)
    elif magnitude == "tiny":       # float32's subnormals and the bottom
        x = base * 2.0 ** rng.uniform(-149, -100, base.shape)
    else:                           # past bf16's largest finite 3.39e38
        x = np.concatenate([base * 2.0 ** rng.uniform(100, 124, base.shape),
                            np.sign(base) * rng.uniform(3.38e38, 3.4028e38,
                                                        base.shape)])
    x = torch.from_numpy(x.astype(np.float32))
    b0, b1, b2 = _bf16_parts(x)
    for part in (b0, b1, b2):
        assert torch.isfinite(part).all()
        assert torch.equal(part, part.to(torch.bfloat16).float())
    err = (b0.double() + b1.double() + b2.double() - x.double()).abs()
    big = x.abs() >= 2.0 ** -110
    assert (err[big] == 0).all()
    assert (err[~big] <= 2.0 ** -134).all()
    nearest = torch.isfinite(x.to(torch.bfloat16).float()) & big
    assert (b1.abs() <= 2.0 ** -8 * x.abs())[nearest].all()
    assert (b2.abs() <= 2.0 ** -16 * x.abs())[big].all()
    if magnitude == "large":
        assert (~nearest).sum() > 0


@pytest.mark.parametrize("sq,skv,d,dv,dtype,causal,window,ok", [
    (4096, 4096, 120, 120, "bf16", True, None, True),     # h2o's training
    (2048, 2048, 192, 128, "bf16", True, None, True),     # MLA
    (448, 1500, 64, 64, "f32", False, None, True),        # whisper cross
    (1500, 448, 64, 64, "bf16", False, None, True),       # more queries
    (9, 8, 64, 64, "f32", True, None, False),             # masked Sq > Skv
    (9, 8, 64, 64, "f32", False, 4, False),
    (64, 64, 12, 12, "bf16", True, None, False),          # D % 8 in bf16
    (64, 64, 136, 136, "f32", True, None, False),         # D past 128
    (64 * 65535 + 1, 64 * 65535 + 1, 16, 16, "bf16", False, None, False),
    # float32: the tiles on the grid's x, so past the 65535 64-row tiles
    # of the first float32 backward too; its limit is the forward's S * D
    (64 * 65535 + 1, 64 * 65535 + 1, 16, 16, "f32", False, None, True),
    (64 * 65535, 64 * 65535, 16, 16, "f32", False, None, True),
    (2 ** 27 - 1, 2 ** 27 - 1, 16, 16, "f32", False, None, True),
    (2 ** 27, 2 ** 27, 16, 16, "f32", False, None, False),
    # bf16: 128-row tiles of Sq and of Skv on one grid's y
    (128 * 32767, 128 * 32768, 16, 16, "bf16", False, None, True),
    (128 * 32767 + 1, 128 * 32768, 16, 16, "bf16", False, None, False),
    (300, 700, 120, 120, "bf16", True, 128, True),        # ragged, windowed
    (128, 128, 48, 32, "bf16", True, None, True),         # reduced MLA
    # float32 at the shapes the first float32 backward took: any D (17:
    # rows of 68 bytes, which the prologue's parts make 16-byte rows),
    # Sq % 4 != 0, MLA's (192, 128), a ragged window
    (13, 301, 17, 17, "f32", True, 32, True),
    (13, 301, 64, 64, "f32", True, 32, True),
    (2048, 2048, 192, 128, "f32", True, None, True),
    (300, 700, 64, 64, "f32", True, 128, True),
    (448, 448, 64, 64, "f32", True, None, True),
    (14, 13, 17, 17, "f32", True, None, False),           # masked Sq > Skv
    (64, 64, 200, 128, "f32", True, None, False),         # no depth class
])
def test_flash_attention_backward_shape_limits(sq, skv, d, dv, dtype, causal,
                                               window, ok):
    """The backward takes the forward's depth pairs, in both types the bf16
    kernel's mask rule (Sq <= Skv unless nothing is masked), and its grid's
    limits (``csrc/attn_bwd.cu``): in bf16 at most 65535 128-row tiles of
    Sq and of Skv together; in float32 none past the forward's (the tiles
    on the grid's x), and every shape the first float32 backward took."""
    if ok:
        fa_mod.check_backward_shape(4, sq, skv, d, TT[dtype], dv,
                                    causal=causal, window=window)
    else:
        with pytest.raises(ValueError, match="D|Sq|S <="):
            fa_mod.check_backward_shape(4, sq, skv, d, TT[dtype], dv,
                                        causal=causal, window=window)


@pytest.mark.parametrize("bh,sq,dtype,ok", [
    (2 ** 31 - 1, 8, "bf16", True), (2 ** 31 - 1, 9, "bf16", False),
    (2 ** 16, 8, "f32", False),    # float32: its grid's y takes 65535 lanes
    (2 ** 16 - 1, 8, "f32", True),
])
def test_flash_attention_backward_lane_rows_limit(bh, sq, dtype, ok):
    """The bf16 backward's delta launch takes a warp a row, eight rows a
    block, on a grid's x of at most 2**31 - 1 blocks; the float32 kernels
    put the lanes on a grid's y of at most 65535 (the forward's limit)."""
    if ok:
        fa_mod.check_backward_shape(bh, sq, sq, 64, TT[dtype])
    else:
        with pytest.raises(ValueError, match="BH"):
            fa_mod.check_backward_shape(bh, sq, sq, 64, TT[dtype])


_CTYPE = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float}


def _c_entry_points(source: str):
    """{name: [kind of each argument]} of the ``extern "C" int`` functions
    of a CUDA source: pointer (any ``*``), int or float."""
    out = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        kinds = []
        for arg in args.split(","):
            words = arg.replace("*", " * ").split()
            if "*" in words:
                kinds.append("ptr")
            else:
                assert words[0] in ("int", "float"), (name, arg)
                kinds.append(words[0])
        out[name] = kinds
    return out


@pytest.mark.parametrize("library", sorted(build.SIGNATURES))
def test_entry_points_match_their_ctypes_signatures(library):
    """Every ``extern "C"`` entry point of ``csrc/<library>.cu`` is bound by
    ``build.SIGNATURES`` with its arguments' number and kinds: a pointer
    bound as an int would be cut to 32 bits, silently."""
    source = (build.CSRC / f"{library}.cu").read_text()
    entries = _c_entry_points(source)
    assert 'extern "C" const char* repro_error_string(int code)' in source
    assert set(entries) == set(build.SIGNATURES[library])
    for name, kinds in entries.items():
        assert list(build.SIGNATURES[library][name]) == \
            [_CTYPE[kind] for kind in kinds], name


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
    (16, 2048, 513, 512, 256, 1,
     ((16, 8, 256, 256), (16, 8, 512, 513), (16, 8))),
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
    (8, 777, 65, 64, 256, True),          # P past 64: a second column tile
    (8, 777, 64, 65, 256, True),          # N past 64: a second row tile
    (16, 2048, 513, 512, 256, True),      # xlstm-350m's mLSTM
    (1, 64, 2 ** 20, 64, 256, False),     # N * P past 65535 * 256 entries
    (1, 64, 2 ** 22, 1, 256, False),      # 65536 tiles of the state
    (8, 777, 64, 64, 257, False),
    (8, 200, 64, 64, 257, True),          # the chunk is cut to S
    (1, 2 ** 25, 64, 64, 256, False),     # S * max(N, P) reaches 2**31
    (2 ** 20, 2 ** 12, 1, 1, 1, False),   # 2**32 blocks of the outputs
])
def test_ssd_kernel_shape_limits(bh, s, p, n, chunk, ok):
    """The kernels take any BH while their grids fit: only the chunk, the
    state's tiles and entries (N, P tile by 64 on the grid) and the index
    ranges are limited."""
    if ok:
        ssd_mod.check_kernel_shape(bh, s, p, n, chunk)
    else:
        with pytest.raises(ValueError, match="limits"):
            ssd_mod.check_kernel_shape(bh, s, p, n, chunk)


# ---------------------------------------------------------------------------
# the scan past N, P 64 (xlstm's mLSTM: N 512, P 513).  The Pallas kernel's
# blocks are the whole state, so the JAX counterpart there is the
# reference's ssd_chunked (src/repro/models/ssm.py), what its models call.
# ---------------------------------------------------------------------------
def _ssd_chunked_lanes(xb, la, bm, cm, *, chunk, heads):
    """The reference's ssd_chunked on the kernel's lanes: (BH, S, P) as
    (BH / heads, S, heads, P), bm and cm shared by a row's heads.  Returns
    y (BH, S, P) and the final state (BH, N, P) as numpy."""
    g = xb.shape[0] // heads
    s, p = xb.shape[1:]
    x4 = jnp.asarray(xb.reshape(g, heads, s, p)).transpose(0, 2, 1, 3)
    l3 = jnp.asarray(la.reshape(g, heads, s)).transpose(0, 2, 1)
    y, st = JS.ssd_chunked(x4, l3, jnp.asarray(bm), jnp.asarray(cm), chunk)
    y = np.asarray(y).transpose(0, 2, 1, 3).reshape(g * heads, s, p)
    return y, np.asarray(st).reshape(g * heads, *st.shape[2:])


# (BH, heads, S, P, N, chunk): N != P past 64 with heads sharing bm/cm and
# a ragged S, P not a multiple of 64 with N a multiple, and the odd P of
# the mLSTM's value channels plus its normalizer
SSD_WIDE_CASES = [
    (4, 2, 300, 129, 96, 256),
    (2, 1, 200, 72, 128, 64),
    (2, 1, 160, 97, 80, 64),
]


@pytest.mark.parametrize("bh,heads,s,p,n,chunk", SSD_WIDE_CASES)
def test_ssd_scan_plain_past_64_matches_ssd_chunked(bh, heads, s, p, n,
                                                    chunk):
    rng = np.random.default_rng(bh * s + p + n)
    xb, _, bm, cm = _ssd_inputs(rng, bh, s, p, n, groups=bh // heads)
    la = (-0.1 * rng.random((bh, s))).astype(np.float32)
    y, st = ops.ssd_scan(*map(torch.from_numpy, (xb, la, bm, cm)),
                         chunk=chunk, heads=heads)
    assert y.shape == (bh, s, p) and st.shape == (bh, n, p)
    y0, st0 = _ssd_chunked_lanes(xb, la, bm, cm, chunk=chunk, heads=heads)
    assert np.abs(y.numpy() - y0).max() <= 2e-4 * np.abs(y0).max()
    assert np.abs(st.numpy() - st0).max() <= 2e-4 * np.abs(st0).max()


@pytest.mark.parametrize("bh,heads,s,p,n,chunk", SSD_WIDE_CASES)
def test_ssd_split_tf32_schedule_past_64_matches_ssd_chunked(bh, heads, s, p,
                                                             n, chunk):
    """The kernels' schedule at N, P past 64 (the tiles change no sum: (a)
    walks N's slices in order, (b) and (d) split the state's rows and
    columns, which are independent) within the split-TF32 tier of the
    reference's chunked math."""
    rng = np.random.default_rng(bh * s + p + n + 1)
    xb, _, bm, cm = _ssd_inputs(rng, bh, s, p, n, groups=bh // heads)
    la = (-0.1 * rng.random((bh, s))).astype(np.float32)
    y, st = _ssd_schedule(xb, la, bm, cm, chunk=chunk, heads=heads)
    y0, st0 = _ssd_chunked_lanes(xb, la, bm, cm, chunk=chunk, heads=heads)
    assert np.isfinite(y.numpy()).all()
    assert np.abs(y.numpy() - y0).max() <= 2e-5 * np.abs(y0).max()
    assert np.abs(st.numpy() - st0).max() <= 2e-5 * np.abs(st0).max()


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


# ---------------------------------------------------------------------------
# the grad refusal: a CUDA launch fills its outputs through a raw pointer,
# so a kernel without a backward refuses an input that needs a gradient
# (before its device check, which a CPU tensor reaches otherwise)
# ---------------------------------------------------------------------------
def _refusal_cases():
    from repro_torch.kernels import crossfit_gram as xg_mod
    from repro_torch.kernels import megabatch as mb_mod
    xs, w = torch.zeros((2, 8, 3)), torch.ones((2, 8))
    return {
        "batched_gram": lambda t: mb_mod.batched_gram_cuda(t(xs), w, w),
        "batched_gram_blocked": lambda t: mb_mod.batched_gram_blocked_cuda(
            t(xs.reshape(2, 2, 4, 3)), w.reshape(2, 2, 4),
            w.reshape(2, 2, 4)),
        "batched_predict": lambda t: mb_mod.batched_predict_cuda(
            t(xs), torch.zeros((2, 3)), w),
        "crossfit_gram": lambda t: xg_mod.crossfit_gram_cuda(
            t(xs[0]), w, w),
    }


@pytest.mark.parametrize("name", ["batched_gram", "batched_gram_blocked",
                                  "batched_predict", "crossfit_gram"])
def test_kernels_without_a_backward_refuse_inputs_that_need_one(name):
    call = _refusal_cases()[name]
    grad = lambda t: t.clone().requires_grad_(True)      # noqa: E731
    with pytest.raises(RuntimeError, match=f"{name}.*backward"):
        call(grad)
    # under no_grad the same input reaches the device check
    with torch.no_grad():
        with pytest.raises(ValueError, match="card"):
            call(grad)
    with pytest.raises(ValueError, match="card"):
        call(lambda t: t)


def test_flash_attention_needing_a_gradient_takes_the_backward_route():
    """On the card an input that needs a gradient goes through
    ``FlashAttentionFunction`` (whose shape check is the backward's); on
    the CPU autograd differentiates the plain version."""
    q = torch.zeros((2, 9, 16), requires_grad=True)
    k = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="backward"):
        fa_mod.flash_attention_cuda(q, k, k, causal=True)
    q = torch.zeros((2, 8, 16), requires_grad=True)
    with pytest.raises(ValueError, match="card"):
        fa_mod.flash_attention_cuda(q, k, k, causal=True)
    runtime.reset_launch_counts()
    ops.flash_attention(q, k, k, causal=True).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert set(runtime.launch_counts.values()) == {0}
