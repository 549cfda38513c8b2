"""float32 ``exp``, ``log``, ``log1p``, ``erf_inv``, ``sin`` and ``pow`` as
XLA:CPU computes them, bit for bit.

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

``exp`` and ``log`` are XLA's own inlined polynomials (Cephes ``expf`` and
``logf``), read the same way.  ``sin`` and ``pow`` are not inlined: they
stay ``llvm.sin``/``llvm.pow`` in the IR and the object code calls the
host's ``sinf``/``powf``, glibc's (2.36 on x86-64, its FMA variants:
double-precision polynomials over tables, rounded once to float32).  They
are spelled here in float64 from that object code, with its tables and an
exact float64 FMA (:func:`_fma64`) wherever it has one.  XLA runs with
denormals flushed: a subnormal argument of ``log`` counts as 0.

Constants are Python floats holding float32 (or, for the glibc routines,
float64) values, so an op between a tensor and one of them computes in the
tensor's type with the constant exact, and no constant tensor is made per
call.
"""
from __future__ import annotations

import functools
import math
import struct

import torch

__all__ = ["erf_inv", "exp", "f32", "fma", "log", "log1p", "pow", "recip",
           "sin", "sqrt", "two_pi_over"]

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


def recip(c: float) -> float:
    """1/c rounded to float32, for ``x / c`` with a constant c: XLA
    rewrites the division as ``x * (1/c)`` and folds the reciprocal in
    float32 (a Python float holding a float32 value)."""
    one = torch.ones((), dtype=_F32)
    return float(one / f32(c))


def two_pi_over(period) -> float:
    """2π / period as XLA folds it: ``2π · x / period`` becomes
    ``x · (2π · (1/period))``, each constant rounded to float32."""
    two_pi = torch.tensor(f32(2.0 * math.pi), dtype=torch.float32)
    return float(two_pi * recip(period))


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


def log(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log`` (Cephes logf, as ``jnp.log`` jitted); the
    special values are kept as the IR keeps them (x < 0 -> NaN, 0 and
    subnormals -> -inf, inf -> inf)."""
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
    return torch.where(torch.abs(a) < _FLT_MIN, -math.inf, out)


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
    return torch.where(torch.abs(y) < _LOG1P_SMALL, small, log(y + 1.0))


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


# exp(x): Cephes expf as XLA inlines it; x = n ln2 + r, 2^n built from bits
_EXP_LO, _EXP_HI = _f32s(-87.8, 88.8)
_LOG2E = f32(1.44269502)
_EXP_C1, _EXP_C2 = _f32s(0.693359375, -2.12194440e-4)     # sum: ln 2
_EXP_P = _f32s(1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
               4.1665795894e-2, 1.6666665459e-1, 0.5)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``exp`` (``jnp.exp`` jitted): clamp to
    [-87.8, 88.8], n = floor(x log2 e + 1/2) in [-127, 127], r = x - n ln 2
    in two FMAs, a degree-5 polynomial and 2^n from the exponent bits
    (n = -127 gives 0, as the compiled code does)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(-n, _EXP_C1, x)
    r = fma(-n, _EXP_C2, r)
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for coef in _EXP_P[2:]:
        p = fma(p, r, coef)
    y = fma(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(_F32)
    return _ftz(y * scale)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal results flushed to zero, as XLA:CPU runs (FTZ/DAZ)."""
    return torch.where(torch.abs(x) < _FLT_MIN, x * 0.0, x)


# ---------------------------------------------------------------------------
# glibc's sinf and powf, in float64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _table(values: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A constant table on ``device``, made once (no copy per call)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _two_sum(a, b: torch.Tensor):
    """s + e == a + b exactly, s = RN(a + b) (Knuth); ``a`` a tensor or a
    Python float."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


_SPLIT = 134217729.0        # 2^27 + 1 (Veltkamp)


def _split(v):
    """Veltkamp's split: hi + lo == v, each with at most 26 bits."""
    t = v * _SPLIT
    hi = t - (t - v)
    return hi, v - hi


def _two_prod(a: torch.Tensor, b):
    """p + e == a * b exactly, p = RN(a * b) (Dekker); b a tensor or a
    Python float (split once, in Python)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 ``a * b + c`` rounded once (the ``vfmadd…sd`` of the glibc
    routines), from error-free transforms: with a*b = ph + pl and
    c + ph = sh + sl exactly, RN(sh + RO(sl + pl)) is the correctly rounded
    FMA, RO being rounding to odd (Boldo and Melquiond, 2008)."""
    ph, pl = _two_prod(a, b)
    sh, sl = _two_sum(c, ph)
    v, err = _two_sum(sl, pl)
    inexact = err != 0
    rounded_away = inexact & ((err < 0) != (v < 0))
    odd = (v.view(torch.int64) - rounded_away.to(torch.int64)) \
        | inexact.to(torch.int64)
    return sh + odd.view(_F64)


def _f64s(*hexes: str) -> tuple:
    return tuple(float.fromhex(h) for h in hexes)


# sinf (glibc sysdeps/ieee754/flt-32/s_sinf.c): __sincosf_table, the
# second entry with the cosine polynomial negated (quadrants 2 and 3)
_SIN_HPI_INV, _SIN_HPI = _f64s("0x1.45f306dc9c883p+23", "0x1.921fb54442d18p+0")
_SIN_C = _f64s("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
               "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")
_SIN_S = _f64s("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
               "-0x1.994eb3774cf24p-13")
_SIN_PI63 = float.fromhex("0x1.921fb54442d18p-62")
# 4/pi in 8-bit steps (__inv_pio4), for |x| >= 120
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_M32 = 0xFFFFFFFF


def _sinf_poly(x: torch.Tensor, odd: torch.Tensor,
               neg_cos: torch.Tensor) -> torch.Tensor:
    """sinf_poly of the reduced x: the sine polynomial (x carries its
    quadrant's sign), or for odd quadrants the cosine one, negated where
    ``neg_cos`` (glibc's second table negates every coefficient, which
    rounding to nearest makes the same as negating the result)."""
    x2 = x * x
    x3 = x2 * x
    s = _fma64(x2, _SIN_S[2], _SIN_S[1])
    sine = _fma64(s, x2 * x3, _fma64(x3, _SIN_S[0], x))
    x4 = x2 * x2
    c_lo = _fma64(x2, _SIN_C[1], _SIN_C[0])
    c_hi = _fma64(x2, _SIN_C[4], _SIN_C[3])
    cosine = _fma64(c_hi, x2 * x4, _fma64(x4, _SIN_C[2], c_lo))
    return torch.where(odd, torch.where(neg_cos, -cosine, cosine), sine)


def _mul32(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of two uint32 values
    held in int64, without an int64 overflow."""
    lo = a * (b & 0xFFFF)                  # < 2^48
    mid = a * (b >> 16)                    # < 2^48
    low = lo + ((mid & 0xFFFF) << 16)
    return (mid >> 16) + (low >> 32), low & _M32


def _reduce_large(bits: torch.Tensor):
    """glibc's reduce_large: x mod pi/2 through 4/pi to 96 bits, for
    |x| >= 120; returns (reduced x without the sign, quadrant n)."""
    arr = _table(_INV_PIO4, torch.int64, bits.device)
    idx = (bits >> 26) & 15
    xi = ((bits & 0x7FFFFF) | 0x800000) << ((bits >> 23) & 7)
    r0 = _mul32(xi, arr[idx])[1]
    h1, l1 = _mul32(xi, arr[idx + 4])
    h2, _ = _mul32(xi, arr[idx + 8])
    # res0 = ((res2 >> 32) | (res0 << 32)) + res1, mod 2^64, in two words
    low = h2 + l1
    hi = (r0 + h1 + (low >> 32)) & _M32
    lo = low & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30
    hi = (hi - (n << 30)) & _M32
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    x = hi.to(_F64) * 4294967296.0 + lo.to(_F64)
    return x * _SIN_PI63, n


def sin(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``sin`` (``jnp.sin`` jitted): glibc's ``sinf``.
    |x| < pi/4: the sine polynomial in float64; |x| < 120: n = round(x
    2/pi) through a 2^24-scaled product, x - n pi/2 in one FMA; above:
    the 96-bit reduction.  The float64 result is rounded once."""
    xd = x.to(_F64)
    bits = x.view(torch.int32).to(torch.int64) & _M32
    top = (bits >> 20) & 0x7FF
    neg = bits >> 31
    # |x| < 120
    n = (torch.trunc(xd * _SIN_HPI_INV).to(torch.int64) + 0x800000) >> 24
    r = _fma64(n.to(_F64) * -1.0, _SIN_HPI, xd)
    # |x| >= 120 (finite): the reduction drops the sign, which then shifts
    # the quadrant of the sign and of the table (not of the polynomial)
    r_big, n_big = _reduce_large(bits)
    big = top > 0x42E
    r = torch.where(big, r_big, r)
    quad = torch.where(big, n_big + neg, n)
    n = torch.where(big, n_big, n)
    small = top < 0x3F4
    r = torch.where(small, xd, r)
    quad = torch.where(small, torch.zeros_like(quad), quad)
    n = torch.where(small, torch.zeros_like(n), n)
    q3 = quad & 3
    r = torch.where((q3 == 1) | (q3 == 2), -r, r)     # sign[quad & 3]
    out = _sinf_poly(r, (n & 1) != 0, (quad & 2) != 0).to(_F32)
    out = torch.where(top <= 0x397, x, out)       # |x| < 2^-12: x
    return torch.where(top > 0x7F7, math.nan, out)


# powf (glibc sysdeps/ieee754/flt-32/e_powf.c): log2 over 16 table
# intervals, exp2 over 32; __powf_log2_data and __exp2f_data
_POW_LOG2_TAB = tuple(_f64s(a, b) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")))
_POW_A = _f64s("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
               "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
               "0x1.71547652ab82bp+0")
_EXP2_SHIFT = float.fromhex("0x1.8p+47")
_EXP2_C = _f64s("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                "0x1.62e42ff0c52d6p-1")
# asuint64(2^(i/32)) - (i << 47)
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_POW_UFLOW = -150.0
_POW_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def _powf(x: torch.Tensor, y) -> torch.Tensor:
    """glibc's ``powf(x, y)`` for a float32 tensor x >= 0 and a finite,
    nonzero float32 exponent y (a Python float, or a float32 tensor that
    broadcasts against x): log2(x) in float64 over the interval table,
    times y, then exp2 over its table; subnormal arguments and results as
    under XLA's flushed denormals."""
    dev = x.device
    ix = x.view(torch.int32).to(torch.int64) & _M32
    # a subnormal x is normalised as bits(x * 2^23) - (23 << 23), and the
    # flushed product makes that 0xF4800000 (log2 x = -150)
    ix = torch.where((x > 0) & (x < _FLT_MIN), 0xF4800000, ix)
    tmp = (ix - 0x3F330000) & _M32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    z = ((ix - top) & _M32).to(torch.int32).view(_F32).to(_F64)
    tab = _table(_POW_LOG2_TAB, _F64, dev)[i]
    r = _fma64(z, tab[..., 0], -1.0)
    y0 = k.to(_F64) + tab[..., 1]
    yy = _fma64(r, _POW_A[0], _POW_A[1])
    p = _fma64(r, _POW_A[2], _POW_A[3])
    r2 = r * r
    q = _fma64(r, _POW_A[4], y0)
    q = _fma64(r2, p, q)
    logx = _fma64(yy, r2 * r2, q)
    ylogx = logx * (y.to(_F64) if torch.is_tensor(y) else f32(y))
    # exp2: ylogx = m/32 + r, 2^(m/32) from the table and the exponent
    kd = (ylogx + _EXP2_SHIFT) - _EXP2_SHIFT
    r = ylogx - kd
    m = (kd * 32.0).to(torch.int64)
    tab2 = _table(_EXP2_TAB, torch.int64, dev)
    s = (tab2[m & 31] + ((m & 31) << 47) + ((m >> 5) << 52)).view(_F64)
    zz = _fma64(r, _EXP2_C[0], _EXP2_C[1])
    out = _fma64(zz, r * r, _fma64(r, _EXP2_C[2], 1.0)) * s
    out = out.to(_F32)
    out = torch.where(out < _FLT_MIN, 0.0, out)     # flushed to zero
    zero = x == 0
    big = ylogx > _POW_OFLOW
    out = torch.where(ylogx <= _POW_UFLOW, 0.0, out)
    out = torch.where(big, math.inf, out)
    pos = y > 0
    if torch.is_tensor(y):
        out = torch.where(zero & pos, 0.0, torch.where(zero, math.inf, out))
        out = torch.where((x == math.inf) & pos, math.inf,
                          torch.where(x == math.inf, 0.0, out))
    else:
        out = torch.where(zero, 0.0 if pos else math.inf, out)
        out = torch.where(x == math.inf, math.inf if pos else 0.0, out)
    return torch.where(torch.isnan(x) | (x < 0), math.nan, out)


def pow(x: torch.Tensor, y) -> torch.Tensor:
    """XLA:CPU's float32 ``x ** y`` for a float32 tensor x >= 0 and a
    Python float y, as ``jnp`` traces it (``pow`` with a constant
    exponent).  XLA's simplifier rewrites y = 0, 1, 2, 3, -1 and 0.5 into
    1, x, x·x, x·x·x, 1/x and sqrt(x); every other y calls glibc's
    ``powf``.  A float32 tensor y (an exponent computed at run time,
    finite and nonzero) always calls ``powf``."""
    if torch.is_tensor(y):
        return _powf(x, y)
    y = f32(y)
    if y == 0.0:
        return torch.ones_like(x)
    if y == 1.0:
        return x.clone()
    if not math.isfinite(y):
        raise ValueError(f"pow: exponent {y} is not finite")
    if y not in (2.0, 3.0, -1.0, 0.5):
        return _powf(x, y)
    x = _ftz(x)                        # subnormal arguments count as 0
    if y == 2.0:
        return _ftz(x * x)
    if y == 3.0:
        return _ftz(x * x * x)
    if y == -1.0:
        return _ftz(1.0 / x)
    return sqrt(x)
