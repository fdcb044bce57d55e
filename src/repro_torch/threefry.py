"""JAX's Threefry-2x32 random stream, in PyTorch.

The JAX package draws every random number of an estimate — kernel_ridge's
landmarks, mlp's initial weights, the bootstrap's multipliers — from
``jax.random`` keys: the request seed's key, folded with the flat task id.
This module computes the same bits, so the port's learners and bootstrap
start from the reference's numbers and are held to it at the float tier.

It reproduces ``jax.random``'s default implementation, Threefry-2x32
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011:
20 rounds of the Threefish mix with rotations 13/15/26/6 and 17/29/16/24,
a key injection every 4 rounds, key-schedule parity 0x1BD11BDA), in the
mode ``jax_threefry_partitionable=True`` (JAX's default):

  * ``key(seed)`` is the words ``(seed >> 32, seed & 0xffffffff)``;
  * ``fold_in(k, d)`` is ``threefry(k, (0, d))``;
  * ``split(k, n)[i]`` is ``threefry(k, (i >> 32, i & 0xffffffff))``;
  * ``bits(k, shape)`` hashes the flat index i of each element as the
    counter ``(i >> 32, i & 0xffffffff)`` and returns the XOR of the two
    output words.

A key is a tensor of two uint32 words, held in int64 (``(..., 2)``; leading
dimensions batch independent keys).  All arithmetic is on int64 tensors
masked to 32 bits — an add, then a mask; a rotation as a left shift and a
mask, OR a right shift of the non-negative value — so the CPU and the card
give the same bits.  The floats are made as ``jax.random`` makes them: the
23 high bits as a float32 mantissa in [1, 2), minus 1 (``uniform``);
``normal`` is ``sqrt(2) erfinv(u)`` on ``(nextafter(-1, 0), 1)``, ``gumbel``
``-log(-log(u))`` on ``(tiny, 1)`` and ``exponential`` ``-log1p(-u)``.
The uniforms are bit for bit JAX's; what follows them is PyTorch's
``log``, ``log1p`` and ``sqrt`` (``erf_inv`` is the polynomial XLA
evaluates), within a few float32 ulps of XLA's.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
I64 = torch.int64
F32 = torch.float32

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words (x0, x1) under the key
    words (k0, k1): int64 tensors holding uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed, ``jax.random.key(seed)``'s words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=I64, device=device)


def key_data(k) -> torch.Tensor:
    """The (..., 2) int64 words of a key (or of a batch of keys): a tensor,
    or an array of uint32 words such as ``jax.random.key_data`` gives."""
    if not isinstance(k, torch.Tensor):
        k = torch.from_numpy(np.asarray(k).astype(np.int64))
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) words, got shape {tuple(k.shape)}")
    return k.to(I64)


def fold_in(k, data) -> torch.Tensor:
    """``jax.random.fold_in``: the keys (..., 2) of ``k`` folded with
    ``data`` (an int or an integer tensor, taken mod 2^32), broadcast
    against k's leading dimensions."""
    k = key_data(k)
    d = torch.as_tensor(data, dtype=I64, device=k.device) & MASK
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def _counters(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    i = torch.arange(int(np.prod(shape)), dtype=I64,
                     device=device).reshape(shape)
    return i >> 32, i & MASK


def split(k, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., *num, 2), the i-th (flat index) the
    hash of the counter i under ``k``."""
    k = key_data(k)
    shape = _shape(num)
    hi, lo = _counters(shape, k.device)
    lead = k.shape[:-1]
    kk = k.reshape(lead + (1,) * len(shape) + (2,))
    o0, o1 = threefry2x32(kk[..., 0], kk[..., 1], hi, lo)
    return torch.stack([o0, o1], dim=-1)


def bits(k, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits`` (32 bits): int64 values in [0, 2^32) of shape
    ``k.shape[:-1] + shape``."""
    k = key_data(k)
    shape = _shape(shape)
    hi, lo = _counters(shape, k.device)
    kk = k.reshape(k.shape[:-1] + (1,) * len(shape) + (2,))
    o0, o1 = threefry2x32(kk[..., 0], kk[..., 1], hi, lo)
    return o0 ^ o1


def mantissa(b: torch.Tensor) -> torch.Tensor:
    """The 23 bits of ``b`` that become a uniform's mantissa, as int64:
    ``uniform`` is increasing in them."""
    return b >> 9


def _unit(b: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from 32-bit values: the mantissa of 1.m, minus 1."""
    one_m = (mantissa(b) | 0x3F800000).to(torch.int32).view(F32)
    return one_m - 1.0


def uniform(k, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32, on [minval, maxval).  The unit
    float is scaled with one rounding, as XLA's fused multiply-add does it:
    the product is exact in float64, and the sum rounds to float32 once
    more (equal but for a double rounding at a tie)."""
    k = key_data(k)
    lo = torch.tensor(minval, dtype=F32, device=k.device)
    hi = torch.tensor(maxval, dtype=F32, device=k.device)
    f64 = torch.float64
    scaled = (_unit(bits(k, shape)).to(f64) * (hi - lo).to(f64)
              + lo.to(f64)).to(F32)
    return torch.maximum(lo, scaled)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_TINY = float(np.finfo(np.float32).tiny)
# the float32 polynomial JAX's erf_inv lowers to (Giles, "Approximating
# the erfinv function", 2010): Horner in w - 2.5 where w = -log1p(-x^2)
# < 5, else in sqrt(w) - 3
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = coeffs[1] + coeffs[0] * w
    for c in coeffs[2:]:
        p = c + p * w
    return p


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function as JAX computes it in float32: within
    2 ulps of ``jax.lax.erf_inv`` (``torch.erfinv``, a more accurate
    algorithm, is up to 6e-6 relative away from it)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    p = torch.where(lt, _horner(_ERFINV_LT5, w - 2.5),
                    _horner(_ERFINV_GE5, torch.sqrt(w) - 3.0))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(k, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return erf_inv(u) * _SQRT2


def gumbel(k, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (its default mode, "low") in float32."""
    return -torch.log(-torch.log(uniform(k, shape, _TINY, 1.0)))


def exponential(k, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential`` in float32."""
    return -torch.log1p(-uniform(k, shape))
