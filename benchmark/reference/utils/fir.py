"""FIR filter helpers (host-side, float64).

Reference parity:
  * normalize_fir         — r8bbase.h:934-961 (normalizeFIRFilter)
"""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_fir"]


def normalize_fir(p: np.ndarray, dc_gain: float = 1.0) -> np.ndarray:
    """Scale ``p`` so its DC response equals ``dc_gain`` (r8bbase.h:934-961).

    Returns a new array (functional style; the reference mutates in place).
    """
    p = np.asarray(p, dtype=np.float64)
    s = dc_gain / np.sum(p)
    return p * s
