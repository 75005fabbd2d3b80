"""Error-free transformation of two-float ("df32") arithmetic.

Counterpart of the reference package's ``ops/dfloat.py``; the port needs
only ``two_sum`` so far (the ozaki engine's compensated chunk fold and the
df32 inter-stage carry).
"""

from __future__ import annotations

__all__ = ["two_sum"]


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth), 6 flops, no FMA."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e
