"""Windowed-sinc FIR kernel generation (host-side, float64, vectorized).

Host-side counterpart of CDSPSincFilterGen (reference:
CDSPSincFilterGen.h:32-698).  The reference generates kernels sample-serially
with recurrence oscillators; we evaluate the same closed forms vectorized in
numpy.  Agreement with the reference is at the ~1 ulp level (the recurrence
vs. direct trig evaluation), far below every acceptance threshold in the
test-suite.

Kernel types (reference function -> ours):
  * generateWindow  (CDSPSincFilterGen.h:264-302)  -> generate_window
  * generateBand    (CDSPSincFilterGen.h:312-395)  -> generate_band_kernel
  * generateHilbert (CDSPSincFilterGen.h:404-442)  -> generate_hilbert_kernel
  * generateFrac    (CDSPSincFilterGen.h:452-552)  -> generate_frac_kernel

Window functions (CDSPSincFilterGen.h:183-255, 586-697): generalized
cosine-sum (Hann/Hamming/Blackman/Nuttall/Blackman-Nuttall), Kaiser with an
optional power raise, and Gaussian.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.math import besselI0, pow_a

__all__ = [
    "KAISER_DEFAULT_BETA",
    "KAISER_DEFAULT_POWER",
    "window_values",
    "generate_window",
    "generate_band_kernel",
    "generate_hilbert_kernel",
    "generate_frac_kernel",
]

# Defaults of setWindowKaiser (CDSPSincFilterGen.h:591-594).
KAISER_DEFAULT_BETA = 9.5945013206755156
KAISER_DEFAULT_POWER = 1.9718457932433306

_COSINE_SUM = {
    # name -> cosine-sum coefficients (a0, a1, a2, a3); reference lines:
    "hann": (0.5, 0.5),  # CDSPSincFilterGen.h:183-186
    "hamming": (0.54, 0.46),  # :192-195
    "blackman": (0.42, 0.5, 0.08),  # :201-204
    "nuttall": (0.355768, 0.487396, 0.144232, 0.012604),  # :210-214
    "blackman_nuttall": (0.3635819, 0.4891775, 0.1365995, 0.0106411),  # :220-224
}


def _apply_power(w: np.ndarray, power: float) -> np.ndarray:
    """Raise window by ``power`` when power >= 0 (pow_a semantics)."""
    if power < 0.0:
        return w
    return pow_a(w, power)


def window_values(
    pos: np.ndarray,
    len2: float,
    window: str = "blackman",
    params: Optional[Sequence[float]] = None,
    use_power: bool = False,
) -> np.ndarray:
    """Window function evaluated at (possibly fractional) tap offsets ``pos``.

    ``pos`` is the distance from the window center in samples (the reference
    consumes window values serially; positions here replicate the serial
    call order exactly).  ``len2`` is the half-length of the window.

    For Kaiser: params = (beta, power); defaults per the reference
    (CDSPSincFilterGen.h:591-594).  For Gaussian: params = (sigma, power).
    For cosine-sum windows: params = (power,) if use_power.
    """
    pos = np.asarray(pos, dtype=np.float64)

    if window == "kaiser":
        if params is None:
            beta = KAISER_DEFAULT_BETA
            power = KAISER_DEFAULT_POWER if use_power else -1.0
        else:
            beta = float(np.clip(params[0], 1.0, 350.0))
            power = abs(params[1]) if use_power else -1.0
        n = 1.0 - (pos / len2) ** 2
        w = np.where(
            n <= 0.0, 0.0, besselI0(beta * np.sqrt(np.maximum(n, 0.0)))
        ) / besselI0(beta)
        return _apply_power(w, power)

    if window == "gaussian":
        if params is None:
            sigma = 1.0
            power = -1.0
        else:
            sigma = float(np.clip(abs(params[0]), 1e-1, 100.0))
            power = abs(params[1]) if use_power else -1.0
        # GaussianSigmaI = 1 / (sigma * Len2) (CDSPSincFilterGen.h:622-641)
        w = np.exp(-0.5 * (pos / (sigma * len2)) ** 2)
        return _apply_power(w, power)

    if window in _COSINE_SUM:
        coeffs = _COSINE_SUM[window]
        power = (
            params[0] if (use_power and params is not None) else -1.0
        )
        w = np.zeros_like(pos) + coeffs[0]
        for k, a in enumerate(coeffs[1:], start=1):
            w = w + a * np.cos(k * np.pi * pos / len2)
        return _apply_power(w, power)

    raise ValueError(f"unknown window type: {window}")


def generate_window(
    len2: float,
    window: str = "blackman",
    params: Optional[Sequence[float]] = None,
    use_power: bool = False,
) -> np.ndarray:
    """Symmetric window, odd length 2*floor(len2)+1 (initWindow semantics)."""
    fl2 = int(math.floor(len2))
    t = np.abs(np.arange(-fl2, fl2 + 1, dtype=np.float64))
    return window_values(t, len2, window, params, use_power)


def generate_band_kernel(
    len2: float,
    freq1: float,
    freq2: float,
    window: str = "kaiser",
    params: Optional[Sequence[float]] = None,
    use_power: bool = False,
) -> Tuple[np.ndarray, int]:
    """Band-pass windowed-sinc kernel (generateBand,
    CDSPSincFilterGen.h:312-395).

    Returns (kernel, fl2); kernel has odd length 2*fl2+1 with fl2 =
    floor(len2); the pass band is [freq1, freq2] in circular frequency.
    """
    fl2 = int(math.floor(len2))
    t_abs = np.arange(0, fl2 + 1, dtype=np.float64)
    w = window_values(t_abs, len2, window, params, use_power)

    with np.errstate(divide="ignore", invalid="ignore"):
        if freq1 < 2.3e-13:
            vals = np.sin(freq2 * t_abs) / (np.pi * t_abs)
        else:
            vals = (np.sin(freq2 * t_abs) - np.sin(freq1 * t_abs)) / (np.pi * t_abs)
    vals[0] = (freq2 - freq1) / np.pi
    half = vals * w

    kernel = np.empty(2 * fl2 + 1, dtype=np.float64)
    kernel[fl2:] = half
    kernel[:fl2] = half[1:][::-1]
    return kernel, fl2


def generate_hilbert_kernel(
    len2: float,
    window: str = "blackman",
    params: Optional[Sequence[float]] = None,
    use_power: bool = False,
) -> Tuple[np.ndarray, int]:
    """Windowed Hilbert-transformer kernel (generateHilbert,
    CDSPSincFilterGen.h:404-442).  Antisymmetric, odd length 2*fl2+1.
    """
    fl2 = int(math.floor(len2))
    t_abs = np.arange(0, fl2 + 1, dtype=np.float64)
    w = window_values(t_abs, len2, window, params, use_power)

    half = np.zeros(fl2 + 1, dtype=np.float64)
    odd = (np.arange(fl2 + 1) % 2) == 1
    with np.errstate(divide="ignore", invalid="ignore"):
        hv = (2.0 / np.pi) / t_abs
    half[odd] = hv[odd] * w[odd]

    kernel = np.empty(2 * fl2 + 1, dtype=np.float64)
    kernel[fl2:] = half
    kernel[:fl2] = -half[1:][::-1]
    kernel[fl2] = 0.0
    return kernel, fl2


def generate_frac_kernel(
    len2: float,
    frac_delay: float,
    window: str = "kaiser",
    params: Optional[Sequence[float]] = None,
    use_power: bool = True,
) -> Tuple[np.ndarray, int]:
    """Fractional-delay windowed-sinc kernel (generateFrac,
    CDSPSincFilterGen.h:452-552; initFrac :168-177).

    Even kernel length 2*fl2 with fl2 = ceil(len2).  ``frac_delay`` in
    [0, 1]; 0 produces a 1-sample delay (latency fl2), 1 produces a 0-sample
    delay (latency fl2-1) — see the FracDelay doc at
    CDSPSincFilterGen.h:52-56.

    Returns (kernel, fl2).
    """
    fl2 = int(math.ceil(len2))
    fd = float(frac_delay)
    t = np.arange(-fl2, fl2, dtype=np.float64)
    u = t + fd

    # Window at fractional positions u (non-centered window,
    # setWindowKaiser / setWindow with IsCentered=false).
    w = window_values(u, len2, window, params, use_power)

    # sin((t + fd) * pi) == (-1)^t * sin(fd * pi), evaluated exactly.
    sign = np.where(((np.arange(-fl2, fl2) % 2) + 2) % 2 == 0, 1.0, -1.0)
    f = math.sin(fd * math.pi) / math.pi

    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = sign * f * w / u

    # Special integer-sample point (t + fd == 0): sinc value is 1.
    is_zero_x = abs(fd - 1.0) < 2.3e-13 or abs(fd) < 2.3e-13
    if is_zero_x:
        zidx = (fl2 - 1) if abs(fd - 1.0) < 2.3e-13 else fl2
        kernel[zidx] = w[zidx]
    else:
        # t == 0 generic value f * w / fd (reference line 497).
        kernel[fl2] = f * w[fl2] / fd

    # Out-of-support edge taps (reference lines 462-468 and 510-514).
    kernel = np.where(u < -len2, 0.0, kernel)
    kernel[-1] = 0.0 if u[-1] > len2 else kernel[-1]
    kernel = np.where(np.isfinite(kernel), kernel, 0.0)
    return kernel, fl2
