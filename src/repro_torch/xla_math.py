"""float32 ``log1p`` and ``erf_inv`` as XLA:CPU computes them, bit for bit.

``jax.random.normal`` is ``sqrt(2) * erf_inv(u)`` on a uniform ``u``, and
XLA expands ``erf_inv`` into Giles' single-precision polynomial around a
``log1p``, which XLA:CPU in turn inlines as a polynomial (Cephes' rational
form for small arguments, a range-reduced ``log`` for the rest).  Neither
is what ``torch.erfinv`` or ``torch.log1p`` computes, so a parameter drawn
with them differs from JAX's in ~60% of its lanes.  Here both are spelled
op for op from the optimised LLVM IR and object code of the fused
``jax.random.normal`` (``XLA_FLAGS=--xla_dump_to=DIR``, jax 0.9.0 on x86-64
with FMA), with the same constants, the same operation order and an FMA
exactly where the compiled code has one.

Every step is a correctly rounded float32 operation (add, mul, div,
compare, select, bit masks), so the CPU and the card agree.  Two are not
left to torch: the FMAs are :func:`fma` (exact in float64, rounded once to
float32), so nothing depends on how a torch build compiles ``addcmul``;
and the square root is :func:`sqrt`, because ``torch.sqrt`` of float32 on
the CPU is off by an ulp in some lanes (its vector path is not correctly
rounded; XLA's ``vsqrtps`` is).

Constants are Python floats holding float32 values, so an op between a
float32 tensor and one of them computes in float32 with the constant
exact, and no constant tensor is made per call.
"""
from __future__ import annotations

import math
import struct

import torch

__all__ = ["erf_inv", "f32", "fma", "log1p", "sqrt"]

_F32, _F64 = torch.float32, torch.float64


def f32(v: float) -> float:
    """``v`` rounded to the nearest float32 (a Python float)."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _f32s(*vs: float) -> tuple:
    return tuple(f32(v) for v in vs)


# log(m), m in [sqrt(1/2), sqrt(2)): Cephes logf's polynomial, split in
# three interleaved Horner chains as the IR evaluates it
_LOG_A = _f32s(0.0703768358, -0.115146101, 0.116769984)
_LOG_B = _f32s(-0.12420141, 0.142493233, -0.166680574)
_LOG_C = _f32s(0.200007141, -0.24999994, 0.333333313)
_LOG_E_LO, _LOG_E_HI = _f32s(-0.000212194442, 0.693359375)  # sum: ln 2
_SQRT_HALF, _FLT_MIN = _f32s(0.707106769, 1.17549435e-38)

# log1p(y), |y| < sqrt(2) - 1: y - y^2/2 + y^3 * P(y) / Q(y) (Cephes)
_LOG1P_SMALL = f32(0.414213568)
_LOG1P_NUM = _f32s(4.52700006e-05, 0.498541027, 6.57873249, 29.9119186,
                   60.9496689, 57.1129646, 20.0395527)
_LOG1P_DEN = _f32s(15.0629091, 83.0475693, 221.762405, 309.098724,
                   216.427887, 60.11866)

# erf_inv: Giles (2010), "Approximating the erfinv function", single
# precision; the first set for w < 5, the second for w >= 5
_ERFINV_LT5 = _f32s(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                    -4.39150654e-06, 0.00021858087, -0.00125372503,
                    -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32s(-0.000200214257, 0.000100950558, 0.00134934322,
                    -0.00367342844, 0.00573950773, -0.0076224613,
                    0.00943887047, 1.00167406, 2.83297682)


def _f64(v):
    return v.to(_F64) if torch.is_tensor(v) else v


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as an FMA unit computes it
    (``b``, ``c``: float32 tensors, or float32 values as Python floats).

    The float32 product is exact in float64.  The float64 sum is rounded
    to odd: two-sum gives its error, the sum is truncated toward zero and
    its last bit set where it was inexact; a float64 rounded to odd rounds
    to the correct float32 (Boldo and Melquiond, 2008)."""
    p = a.to(_F64) * _f64(b)
    cd = _f64(c)
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    inexact = err != 0
    rounded_away = inexact & ((err < 0) != (s < 0))
    odd = (s.view(torch.int64) - rounded_away.to(torch.int64)) \
        | inexact.to(torch.int64)
    return odd.view(_F64).to(_F32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of x >= 0.

    The float64 root rounded to float32 is at most one float32 step off;
    the squares of the two midpoints around it are exact in float64 and
    say which side of each the true root lies on."""
    xd = x.to(_F64)
    r = torch.sqrt(xd).to(_F32)
    rd = r.to(_F64)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    mid_up = (rd + up.to(_F64)) * 0.5
    mid_down = (rd + down.to(_F64)) * 0.5
    r = torch.where(mid_up * mid_up < xd, up, r)
    return torch.where(mid_down * mid_down > xd, down, r)


def _log(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log`` (Cephes logf) for the argument of
    ``log1p``'s large branch; the special values are kept as the IR keeps
    them (x < 0 -> NaN, 0 -> -inf, inf -> inf)."""
    bits = torch.clamp_min(a, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)      # in [0.5, 1)
    small = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = torch.where(small, e - 1.0, e)
    z = x * x
    x3 = x * z
    pa = fma(x, fma(x, _LOG_A[0], _LOG_A[1]), _LOG_A[2])
    pb = fma(x, fma(x, _LOG_B[0], _LOG_B[1]), _LOG_B[2])
    pc = fma(x, fma(x, _LOG_C[0], _LOG_C[1]), _LOG_C[2])
    t = fma(x3, fma(pa, x3, pb), pc)
    t = fma(t, x3, e * _LOG_E_LO)
    out = fma(e, _LOG_E_HI, t + fma(z, -0.5, x))
    out = torch.where(a == math.inf, math.inf, out)
    out = torch.where(a > 0, out, math.nan)
    return torch.where(a == 0, -math.inf, out)


def log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p`` (HLO ``log-plus-one``): Cephes' rational
    form below |y| = sqrt(2) - 1, ``log(1 + y)`` above."""
    y2 = y * y
    num = torch.full_like(y, _LOG1P_NUM[0])
    for coef in _LOG1P_NUM[1:]:
        num = fma(y, num, coef)
    den = torch.ones_like(y)
    for coef in _LOG1P_DEN:
        den = fma(y, den, coef)
    small = y + fma(y2, -0.5, (y * y2) * (num / den))
    return torch.where(torch.abs(y) < _LOG1P_SMALL, small, _log(y + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``lax.erf_inv``): w = -log1p(-x*x), then
    Horner on w - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5), times x; +-inf at
    |x| = 1."""
    lp = log1p(x * -x)
    lt5 = lp > -5.0                          # w < 5, with w = -lp exactly
    t = torch.where(lt5, -2.5 - lp, sqrt(-lp) - 3.0)
    p = torch.where(lt5, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(_F32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, t, torch.where(lt5, lo, hi).to(_F64))
    p = torch.where(torch.abs(x) == 1.0, math.inf, p)
    return x * p
