"""Phred transforms, XLA's float32 ``exp``/``log``/``log1p``/sigmoid and guarded division.

Counterpart of ``variantcalling_tpu/ops/math.py``. The reference's phred
math runs in float32 through XLA, whose CPU backend computes ``exp`` and
``log`` with its own polynomials (the Cephes and Eigen approximations,
their multiply-adds fused), not with the C library's. The genotype tools
truncate or round those values to integer PLs, and a float32 PL of 70
lies within a few ulps of its integer, so the port computes both functions
as XLA does, step for step: every multiply-add is one fused operation,
emulated in float64 (exact product, one rounding of the sum, one rounding
to float32), and every other step is one IEEE float32 operation. No
library ``exp``/``log`` (the CPU's or CUDA's) is called, so the card, the
CPU and the reference give the same bits (a float64 emulation of a fused
multiply-add could round twice where the exact sum lies on a float32
midpoint; none was met in 28 M inputs checked against XLA).

:func:`phred` is ``log(p) * -4.3429451`` and :func:`unphred` is
``exp(q * -0.23025851)``, the constants XLA folds ``-10 * log10(p)`` and
``10 ** (-q / 10)`` into.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: ``-10 * (1 / ln(10))`` and ``ln(10) / 10`` as XLA folds them, in float32
PHRED_SCALE = float(np.float32(-10.0) * np.float32(1.0 / math.log(10.0)))
UNPHRED_SCALE = float(np.float32(math.log(10.0) / 10.0))

_FLT_MIN = float(np.float32(2.0 ** -126))

# exp: Cephes' polynomial for e^a, a in (-ln2/2, ln2/2), after n = floor(x / ln2 + 1/2)
_LOG2E = float(np.float32(1.44269504088896341))
_EXP_C1, _EXP_C2 = float(np.float32(0.693359375)), float(np.float32(-2.12194440e-4))
_EXP_P = tuple(float(np.float32(c)) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
                                              1.6666665459e-1, 5.0000001201e-1))

# log: Eigen's (Cephes') polynomial for log(1 + x), x in [sqrt(1/2) - 1, sqrt(2) - 1]
_SQRTHF = float(np.float32(0.707106781186547524))
_LOG_P = tuple(float(np.float32(c)) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                                              1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                                              3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), float(np.float32(0.693359375))

# log1p: XLA's rational approximation (Cephes') for |x| < sqrt(2) - 1, highest degree first
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = tuple(float(np.float32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(float(np.float32(c)) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding of the sum: the product is
    exact in float64, the sum rounds there, then once more to float32."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else v for v in (a, b, c))
    return (a * b + c).float()


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``e^x`` of a float32 tensor, bit for bit as XLA's CPU
    backend computes it (results below the smallest normal float flush to 0,
    as XLA flushes denormals)."""
    x = torch.clamp(x.float(), -87.8, 88.8)
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = fma_f32(n, -_EXP_C1, x)
    a = fma_f32(n, -_EXP_C2, a)
    z = fma_f32(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = fma_f32(z, a, c)
    z = fma_f32(z, a * a, a)
    z = z + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out < _FLT_MIN, torch.zeros_like(out), out)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise natural log of a positive float32 tensor, bit for bit as
    XLA's CPU backend computes it (0 gives -inf, +inf gives +inf, a negative
    or NaN input NaN)."""
    x = x.float()
    m = torch.clamp(x, min=_FLT_MIN)
    bits = m.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    f = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # the significand in [0.5, 1)
    low = f < _SQRTHF
    tmp = torch.where(low, f, torch.zeros_like(f))
    f = f - 1.0
    e = e - low.float()
    f = f + tmp
    f2 = f * f
    f3 = f2 * f
    y = fma_f32(_LOG_P[0], f, _LOG_P[1])
    y1 = fma_f32(_LOG_P[3], f, _LOG_P[4])
    y2 = fma_f32(_LOG_P[6], f, _LOG_P[7])
    y = fma_f32(y, f, _LOG_P[2])
    y1 = fma_f32(y1, f, _LOG_P[5])
    y2 = fma_f32(y2, f, _LOG_P[8])
    y = fma_f32(y, f3, y1)
    y = fma_f32(y, f3, y2)
    y = fma_f32(y, f3, e * _LOG_Q1)
    f = fma_f32(f2, -0.5, f)
    f = f + y
    out = fma_f32(e, _LOG_Q2, f)
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    out = torch.where(x == math.inf, torch.full_like(out, math.inf), out)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(out, math.nan), out)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``log(1 + x)`` of a float32 tensor, bit for bit as XLA's
    CPU backend computes it: for ``|x| < sqrt(2) - 1`` the rational
    approximation ``x - x^2/2 + x^3 * P(x) / Q(x)`` (each polynomial by
    Horner's rule with fused multiply-adds), else :func:`log_f32` of
    ``1 + x``."""
    x = x.float()
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = fma_f32(num, x, cn)
        den = fma_f32(den, x, cd)
    x2 = x * x
    small = x + fma_f32(-0.5, x2, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log_f32(x + 1.0))


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``1 / (1 + e^-x)`` of a float32 tensor, bit for bit as
    XLA's CPU backend computes ``jax.nn.sigmoid`` (its logistic expanded to
    these three operations, the ``exp`` :func:`exp_f32`'s; a result below
    the smallest normal float flushes to 0, as XLA flushes denormals)."""
    out = 1.0 / (1.0 + exp_f32(-x.float()))
    return torch.where(out < _FLT_MIN, torch.zeros_like(out), out)


def phred(p: torch.Tensor) -> torch.Tensor:
    """Probabilities -> Phred scores, elementwise: ``-10 * log10(p)`` in float32."""
    return log_f32(p) * PHRED_SCALE


def unphred(q: torch.Tensor) -> torch.Tensor:
    """Phred scores -> probabilities, elementwise: ``10 ** (-q / 10)`` in float32."""
    return exp_f32(-q.float() * UNPHRED_SCALE)


def safe_divide(numerator: torch.Tensor, denominator: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Elementwise division, ``fill`` where the denominator is 0."""
    numerator, denominator = torch.as_tensor(numerator), torch.as_tensor(denominator)
    ok = denominator != 0
    safe = torch.where(ok, denominator, torch.ones_like(denominator))
    return torch.where(ok, numerator / safe, torch.as_tensor(fill, dtype=torch.get_default_dtype(),
                                                            device=numerator.device))
