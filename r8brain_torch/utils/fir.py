"""FIR filter analysis helpers (host-side, float64).

Reference parity:
  * calc_fir_response     — r8bbase.h:819-861 (calcFIRFilterResponse)
  * calc_fir_group_delay  — r8bbase.h:876-920 (calcFIRFilterGroupDelay)
  * normalize_fir         — r8bbase.h:934-961 (normalizeFIRFilter)
"""

from __future__ import annotations

import numpy as np

__all__ = ["calc_fir_response", "calc_fir_group_delay", "normalize_fir"]


def calc_fir_response(flt: np.ndarray, th, fltlat: int = 0):
    """Complex frequency response of FIR ``flt`` at circular frequency ``th``.

    ``th`` may be a scalar or an array of frequencies in [0, pi].
    Returns (re, im) with the same shape as ``th``.
    Matches calcFIRFilterResponse (r8bbase.h:819-861): the response is
    evaluated with phase reference at ``-fltlat``.
    """
    flt = np.asarray(flt, dtype=np.float64)
    th = np.asarray(th, dtype=np.float64)
    n = np.arange(flt.shape[0], dtype=np.float64)
    # Phase of tap k is +(k - fltlat)*th: the reference's recurrence
    # (r8bbase.h:837-857) advances cos/sin from -(fltlat)*th in the +th
    # direction, so a causal delay yields a *positive* group delay.
    ang = np.multiply.outer(th, n - fltlat)
    re = np.sum(np.cos(ang) * flt, axis=-1)
    im = np.sum(np.sin(ang) * flt, axis=-1)
    if th.ndim == 0:
        return float(re), float(im)
    return re, im


def calc_fir_group_delay(flt: np.ndarray, th: float) -> float:
    """Group delay (in samples) of ``flt`` at frequency ``th``.

    Finite-difference of the phase at th +/- 1e-9, matching
    calcFIRFilterGroupDelay (r8bbase.h:876-920).
    """
    thd2 = 1e-9
    ths = [max(th - thd2, 0.0), min(th + thd2, np.pi)]
    ph = []
    for t in ths:
        re, im = calc_fir_response(flt, t)
        ph.append(np.arctan2(im, re))
    if abs(ph[1] - ph[0]) > np.pi:
        if ph[1] > ph[0]:
            ph[1] -= 2.0 * np.pi
        else:
            ph[1] += 2.0 * np.pi
    return (ph[1] - ph[0]) / (ths[1] - ths[0])


def normalize_fir(p: np.ndarray, dc_gain: float = 1.0) -> np.ndarray:
    """Scale ``p`` so its DC response equals ``dc_gain`` (r8bbase.h:934-961).

    Returns a new array (functional style; the reference mutates in place).
    """
    p = np.asarray(p, dtype=np.float64)
    s = dc_gain / np.sum(p)
    return p * s
