"""Frequency-response scanning utilities (host-side, float64).

Host-side counterpart of r8butil.h (reference lines 33-311): helpers used
by the offline design-validation tools and the test-suite to locate response
extrema and level-crossing points of designed FIR filters.  The reference
uses adaptive-step scanners with embedded binary searches
(findFIRFilterResponseMinLtoR / MaxLtoR, r8butil.h:147-259, and
findFIRFilterResponseLevelRtoL, r8butil.h:279-311); we use dense vectorized
scans with local bisection refinement, which give the same answers to the
tolerance used by the tests and tools.
"""

from __future__ import annotations

import numpy as np

from .fir import calc_fir_response

__all__ = [
    "response_mag",
    "convert_response_to_log",
    "find_response_max",
    "find_response_min",
    "find_level_rtol",
]


def response_mag(flt: np.ndarray, th) -> np.ndarray:
    """|H(e^{j th})| for frequency array ``th``."""
    re, im = calc_fir_response(flt, th)
    return np.sqrt(np.asarray(re) ** 2 + np.asarray(im) ** 2)


def convert_response_to_log(mag: np.ndarray) -> np.ndarray:
    """Magnitude -> dB (20*log10), guarding zeros (r8butil.h:33-57)."""
    return 20.0 * np.log10(np.maximum(np.asarray(mag), 1e-300))


def _refine_extremum(flt, lo, hi, sign, iters=60):
    """Golden-section search for extremum of sign*|H| on [lo, hi]."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc = sign * response_mag(flt, c)
    fd = sign * response_mag(flt, d)
    for _ in range(iters):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = sign * response_mag(flt, c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = sign * response_mag(flt, d)
    x = 0.5 * (a + b)
    return x, response_mag(flt, x)


def find_response_max(flt, th_lo=0.0, th_hi=np.pi, n=4096):
    """(frequency, magnitude) of the response maximum on [th_lo, th_hi].

    Equivalent in role to findFIRFilterResponseMaxLtoR (r8butil.h:211-259).
    """
    th = np.linspace(th_lo, th_hi, n)
    mag = response_mag(flt, th)
    i = int(np.argmax(mag))
    lo = th[max(i - 1, 0)]
    hi = th[min(i + 1, n - 1)]
    return _refine_extremum(flt, lo, hi, +1.0)


def find_response_min(flt, th_lo=0.0, th_hi=np.pi, n=4096):
    """(frequency, magnitude) of the response minimum on [th_lo, th_hi].

    Equivalent in role to findFIRFilterResponseMinLtoR (r8butil.h:147-203).
    """
    th = np.linspace(th_lo, th_hi, n)
    mag = response_mag(flt, th)
    i = int(np.argmin(mag))
    lo = th[max(i - 1, 0)]
    hi = th[min(i + 1, n - 1)]
    return _refine_extremum(flt, lo, hi, -1.0)


def find_level_rtol(flt, level: float, th_hi: float, th_lo: float = 0.0, iters=80):
    """Rightmost frequency <= th_hi where |H| crosses ``level``, scanning
    right-to-left; bisection-refined.  Counterpart of
    findFIRFilterResponseLevelRtoL (r8butil.h:279-311).

    Assumes |H(th_lo)| >= level (pass-band) and |H(th_hi)| < level.
    Returns the crossing frequency in radians.
    """
    n = 8192
    th = np.linspace(th_lo, th_hi, n)
    mag = response_mag(flt, th)
    above = mag >= level
    idx = np.nonzero(above)[0]
    if idx.size == 0:
        return th_lo
    i = int(idx[-1])
    if i == n - 1:
        return th_hi
    lo, hi = th[i], th[i + 1]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if response_mag(flt, mid) >= level:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
