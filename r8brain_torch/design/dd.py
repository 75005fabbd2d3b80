"""Deterministic double-double (df64) arithmetic for the cepstral transform.

Purpose: make minimum-phase designs reproducible on ABIs where
``long double`` is plain binary64 (MSVC x64, AArch64 MSVC, older ARM
EABIs) — there design/ldfft.py's extended-precision path is unavailable
and the f64 fallback inherits the reference's documented high-atten
randomness (CDSPFIRFilter.h:40-46).  A double-double value is an
unevaluated pair ``hi + lo`` of binary64 numbers (~106-bit significand,
eps ~ 4.9e-32 — 1e13x below the 80-bit long double the primary path
uses), built from nothing but IEEE-754 binary64 add/sub/mul/div/sqrt,
all of which are correctly rounded and therefore BIT-IDENTICAL on every
conforming platform.  The transcendentals (log, sin/cos) are evaluated
by fixed-length polynomial schemes in df64 itself — libm is never
called — so two implementations that mirror these exact operation
sequences produce bit-identical designs.  native/r8bt_dd.cpp is that
mirror (compiled with -ffp-contract=off so GCC cannot fuse the
cross-product sums into FMAs numpy does not perform; the ONE deliberate
FMA, two_prod's exact error term, is computed here by Dekker splitting,
which yields the same exact value as std::fma).

Range envelope: operands must stay within ~[1e-290, 1e154] in magnitude
(Dekker splitting overflows above; exact product-error terms flush to
subnormals below) — the transform's value path spans ~[2e-308 only as
the log(0) guard, which log() handles via exact ldexp rescaling, up to
~1e6], comfortably inside.  Property-tested across the envelope in
tests/test_dd_properties.py.

Error-free primitives: Knuth two_sum, Dekker split two_prod
(Shewchuk, "Adaptive precision floating-point arithmetic", 1997);
add/mul/div/sqrt follow the QD library's accurate variants (Hida, Li,
Bailey, "Algorithms for quad-double precision floating point
arithmetic", 2001).  All functions are vectorized over numpy arrays;
scalars work too.

Reference role: CDSPRealFFT.h:681-785 runs this transform in f64 and
documents the resulting randomness; this module is the precision
foundation that removes it everywhere (see design/minphase.py for
backend selection).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "DD", "dd_from", "two_sum", "quick_two_sum", "two_prod",
    "add", "sub", "neg", "mul", "sqr", "mul_f64", "mul_pow2",
    "div", "div_f64", "sqrt", "log", "sincos",
    "TWO_PI", "LN2", "ONE", "to_f64",
]


class DD(NamedTuple):
    hi: np.ndarray
    lo: np.ndarray


# hi = f64-nearest(x), lo = f64-nearest(x - hi); pair residual vs the real
# constant < 6e-33 (generated with mpmath at 200-bit precision).
TWO_PI = DD(np.float64(6.283185307179586), np.float64(2.4492935982947064e-16))
LN2 = DD(np.float64(0.6931471805599453), np.float64(2.3190468138462996e-17))
ONE = DD(np.float64(1.0), np.float64(0.0))

_SQRT_HALF = np.float64(0.7071067811865476)  # f64-nearest(sqrt(1/2))
_SPLITTER = np.float64(134217729.0)  # 2^27 + 1 (Dekker)


def dd_from(x) -> DD:
    x = np.asarray(x, dtype=np.float64)
    return DD(x, np.zeros_like(x))


def to_f64(a: DD) -> np.ndarray:
    """Round the pair to one binary64 (hi+lo is correctly rounded since
    the pair is normalized)."""
    return np.asarray(a.hi + a.lo, dtype=np.float64)


# ---- error-free transforms ------------------------------------------------

def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def two_prod(a, b):
    """Exact product: p + err == a*b.  Dekker splitting; the C++ mirror
    uses std::fma(a, b, -p), which produces the identical exact err."""
    p = a * b
    ca = _SPLITTER * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = _SPLITTER * b
    bhi = cb - (cb - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# ---- double-double ring ops (QD accurate variants) ------------------------

def add(a: DD, b: DD) -> DD:
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = quick_two_sum(s1, s2)
    return DD(s1, s2)


def neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def sub(a: DD, b: DD) -> DD:
    return add(a, neg(b))


def mul(a: DD, b: DD) -> DD:
    p1, p2 = two_prod(a.hi, b.hi)
    p2 = p2 + a.hi * b.lo
    p2 = p2 + a.lo * b.hi
    p1, p2 = quick_two_sum(p1, p2)
    return DD(p1, p2)


def sqr(a: DD) -> DD:
    p1, p2 = two_prod(a.hi, a.hi)
    p2 = p2 + (2.0 * a.hi) * a.lo
    p1, p2 = quick_two_sum(p1, p2)
    return DD(p1, p2)


def mul_f64(a: DD, b) -> DD:
    """a * b with b a plain binary64."""
    p1, p2 = two_prod(a.hi, b)
    p2 = p2 + a.lo * b
    p1, p2 = quick_two_sum(p1, p2)
    return DD(p1, p2)


def mul_pow2(a: DD, s) -> DD:
    """Exact scaling by a power of two."""
    return DD(a.hi * s, a.lo * s)


def div(a: DD, b: DD) -> DD:
    q1 = a.hi / b.hi
    r = sub(a, mul_f64(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f64(b, q2))
    q3 = r.hi / b.hi
    q1, q2 = quick_two_sum(q1, q2)
    return add(DD(q1, q2), DD(np.asarray(q3), np.zeros_like(np.asarray(q3))))


def div_f64(a: DD, b) -> DD:
    """a / b with b a plain binary64."""
    q1 = a.hi / b
    p1, p2 = two_prod(q1, b)
    r = sub(a, DD(p1, p2))
    q2 = (r.hi + r.lo) / b
    s1, s2 = quick_two_sum(q1, q2)
    return DD(s1, s2)


def sqrt(a: DD) -> DD:
    """QD sqrt (one Karp-Markstein refinement of the correctly rounded
    binary64 seed).  a >= 0; a == 0 maps to 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        x = 1.0 / np.sqrt(a.hi)
        ax = a.hi * x
        e = sub(a, DD(*two_prod(ax, ax)))
        corr = e.hi * (x * np.float64(0.5))
        s1, s2 = quick_two_sum(ax, corr)
    zero = a.hi == 0.0
    return DD(np.where(zero, 0.0, s1), np.where(zero, 0.0, s2))


# ---- fixed-sequence transcendentals (no libm in the value path) -----------

def _build_inv_fact(n: int):
    """[1/0!, 1/1!, ..., 1/(n-1)!] computed IN df64 (deterministic —
    the C++ mirror builds its table with the same op sequence)."""
    out = [ONE]
    f = ONE
    for k in range(1, n):
        f = mul_f64(f, np.float64(k))
        out.append(div(ONE, f))
    return out


def _build_inv_odd(n: int):
    """[1/1, 1/3, 1/5, ...] in df64."""
    return [div(ONE, DD(np.float64(2 * k + 1), np.float64(0.0)))
            for k in range(n)]


_INV_FACT = _build_inv_fact(51)
_INV_ODD = _build_inv_odd(25)

_K_LOG = 24   # atanh series x + x^3/3 + ...; |z| <= 0.1716 -> tail < 1e-35
_K_TRIG = 24  # Taylor to r^48/48!; |r| <= pi -> tail < 1e-34


def log(a: DD) -> DD:
    """Natural log, a > 0.  Reduction a = m * 2^e with m in
    [sqrt(1/2), sqrt(2)), then log m = 2 atanh((m-1)/(m+1)) by a
    fixed-length odd series in df64."""
    m0, e32 = np.frexp(a.hi)       # m0 in [0.5, 1)
    e = e32.astype(np.float64)
    shift = np.where(m0 < _SQRT_HALF, 1.0, 0.0)
    e = e - shift
    ei = (-e).astype(np.int32)
    m = DD(np.ldexp(a.hi, ei), np.ldexp(a.lo, ei))  # exact scaling
    z = div(sub(m, ONE), add(m, ONE))
    z2 = sqr(z)
    acc = _INV_ODD[_K_LOG]
    for k in range(_K_LOG - 1, -1, -1):
        acc = add(_INV_ODD[k], mul(acc, z2))
    return add(mul_f64(LN2, e), mul_pow2(mul(z, acc), 2.0))


def sincos(theta: DD):
    """(sin, cos) of theta, any magnitude the reduction's ~1e-28*|k|
    residual tolerates (cepstral phases are O(1e2..1e4)).  One round of
    2*pi reduction (round-to-nearest-even quotient — np.rint here,
    std::nearbyint in the mirror), then fixed-length Taylor in df64 on
    |r| <= pi + eps."""
    k = np.rint(theta.hi / TWO_PI.hi)
    r = sub(theta, mul_f64(TWO_PI, k))
    z = sqr(r)
    # cos: sum (-1)^j z^j / (2j)!
    acc_c = _signed(_INV_FACT[2 * _K_TRIG], _K_TRIG)
    for j in range(_K_TRIG - 1, -1, -1):
        acc_c = add(_signed(_INV_FACT[2 * j], j), mul(acc_c, z))
    # sin: r * sum (-1)^j z^j / (2j+1)!
    acc_s = _signed(_INV_FACT[2 * _K_TRIG + 1], _K_TRIG)
    for j in range(_K_TRIG - 1, -1, -1):
        acc_s = add(_signed(_INV_FACT[2 * j + 1], j), mul(acc_s, z))
    return mul(r, acc_s), acc_c


def _signed(c: DD, j: int) -> DD:
    return c if j % 2 == 0 else neg(c)
