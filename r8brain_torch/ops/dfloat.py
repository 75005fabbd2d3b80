"""Error-free transformation of two-float ("df32") arithmetic.

Counterpart of the reference package's ``ops/dfloat.py``: a value is the
unevaluated sum (hi, lo) of two float32 tensors.  The port needs ``two_sum``
(the ozaki engine's compensated chunk fold and the df32 inter-stage carry)
and the exact product and sums of the sharded polynomial gather-dot under
``precision="high"`` (parallel/sharding.py).  Every step is its own
PyTorch op, so no FMA contracts a product and its error term.
"""

from __future__ import annotations

__all__ = ["two_sum", "quick_two_sum", "two_prod", "df_add", "df_add_f"]

#: Veltkamp's splitting constant for float32 (2^12 + 1): splits a 24-bit
#: mantissa into two 12-bit halves whose products are exact.
_SPLIT = 4097.0


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth), 6 flops, no FMA."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e for |a| >= |b|, 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker, no FMA), 17 flops."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(a, b):
    """(hi, lo) + (hi, lo), the accurate form."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def df_add_f(a, b):
    """(hi, lo) + a float32 tensor."""
    s, e = two_sum(a[0], b)
    e = e + a[1]
    return quick_two_sum(s, e)
