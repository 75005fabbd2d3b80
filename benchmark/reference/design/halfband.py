"""Half-band (and one-third-band) filter tap selection.

Host-side counterpart of CDSPHBUpsampler::getHBFilter
(CDSPHBUpsampler.h:47-316) and getHBFilterThird (:331-552).  The taps are
baked data produced by the reference's offline BiteOptDeep optimizer
(other/hbopt.cpp); extracted to _tables.py.

A half-band stage's equivalent FIR (at the higher of its two rates) is

    h[0] = 1,   h[+-(2i+1)] = flt[i],   h[even != 0] = 0

which is center-aligned (zero latency) and has DC gain 2.  The upsampler
emits y[2n] = x[n], y[2n+1] = sum_i flt[i]*(x[n+1+i] + x[n-i])
(CDSPHBUpsampler.inc:5-7); the downsampler emits
y[n] = x[2n] + sum_i flt[i]*(x[2n+1+2i] + x[2n-1-2i])
(CDSPHBDownsampler.inc:5-7), i.e. the same FIR sampled at even phase,
with gain 2 compensated downstream by the planner's FinGain
(CDSPResampler.h:339-346).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from . import _tables

__all__ = ["HBFilter", "get_hb_filter"]


@dataclass(frozen=True)
class HBFilter:
    """Selected half-band filter: sparse odd-tap coefficients."""

    taps: np.ndarray  # flt[0..n-1], coefficient of x[n +- (i+... )]
    atten: float  # actual attenuation of the selected filter, dB
    steep_index: int
    is_third: bool

    @property
    def num_taps(self) -> int:
        return int(self.taps.shape[0])

    def dense_kernel(self) -> np.ndarray:
        """Equivalent dense FIR at the 2x rate, centered, length 4*n-1."""
        n = self.num_taps
        h = np.zeros(4 * n - 1, dtype=np.float64)
        c = 2 * n - 1
        h[c] = 1.0
        for i in range(n):
            h[c + 2 * i + 1] = self.taps[i]
            h[c - 2 * i - 1] = self.taps[i]
        return h


def get_hb_filter(req_atten: float, steep_index: int, is_third: bool) -> HBFilter:
    """Select the first filter with attenuation >= req_atten in the
    steepness class (CDSPHBUpsampler.h:232-315, :468-552).

    steep_index 0 is the steepest class (used at 4x overall ratio); higher
    indices correspond to shallower transition requirements (8x, 16x, ...).
    Indices above the last class clamp to the last class.
    """
    tables = _tables.HB3_TABLES if is_third else _tables.HB_TABLES
    cls = min(max(steep_index, 0), 6)
    attens, kernels = tables[cls]
    k = 0
    while k != len(attens) - 1 and attens[k] < req_atten:
        k += 1
    return HBFilter(
        taps=np.asarray(kernels[k], dtype=np.float64),
        atten=float(attens[k]),
        steep_index=steep_index,
        is_third=is_third,
    )
