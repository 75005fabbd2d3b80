"""Rational-ratio (whole-number stepping) detection.

Host-side counterpart of findGCD / getWholeStepping
(CDSPFracInterpolator.h:609-673).  The floating-point Euclid iteration is
reproduced exactly — planner decisions (and hence stage plans and goldens)
depend on its precise convergence behavior for near-rational double ratios.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["find_gcd", "get_whole_stepping"]


def find_gcd(l: float, s: float) -> Optional[float]:
    """Euclid on doubles, at most 150 iterations
    (CDSPFracInterpolator.h:609-628).  Returns the GCD or None.
    """
    it = 0
    while it < 150:
        it += 1
        r = l - s
        if r == 0.0:
            return s if s > 0.0 else None
        l = s
        s = abs(r)
    return None


def get_whole_stepping(src_rate: float, dst_rate: float
                       ) -> Optional[Tuple[int, int]]:
    """(InStep, OutStep) if the ratio is exactly rational with
    OutStep <= 1500, else None (CDSPFracInterpolator.h:644-673).
    """
    gcd = find_gcd(src_rate, dst_rate)
    if gcd is None:
        return None
    in_step0 = src_rate / gcd
    in_step = int(in_step0)
    out_step0 = dst_rate / gcd
    out_step = int(out_step0)
    if in_step0 != in_step or out_step0 != out_step:
        return None
    if out_step > 1500:
        # Large filter banks have poor cache behavior in the reference;
        # we keep the same planner decision for plan parity.
        return None
    return in_step, out_step
