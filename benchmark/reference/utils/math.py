"""Scalar/vector math primitives used by the filter-design layer.

Reimplementation of the math utilities of r8brain-free-src
(reference: r8bbase.h).  Everything here runs host-side in float64 numpy —
filter design happens once at plan time (mirroring the reference's
design-once-and-cache pattern) and the resulting kernels are shipped to the
device as constants.

Reference parity:
  * besselI0        — r8bbase.h:1192-1212 (Abramowitz-Stegun polynomial)
  * pow_a           — r8bbase.h:1154-1157
  * gauss           — r8bbase.h:1166-1169
  * asinh           — r8bbase.h:1178-1181
  * clampr          — r8bbase.h:1117-1131
  * sine_recurrence — r8bbase.h:666-755 (CSineGen; closed-form vector eval)
  * spline coeffs   — r8bbase.h:980-1065
  * bit_occupancy   — r8bbase.h:766-803
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "besselI0",
    "pow_a",
    "gauss",
    "asinh",
    "clampr",
    "bit_occupancy",
    "sine_sequence",
    "spline3p8_coeffs",
    "spline2p8_coeffs",
    "spline3p4_coeffs",
    "spline3p6_coeffs",
]


def besselI0(x):
    """Zeroth-order modified Bessel function of the first kind.

    Uses the same Abramowitz-Stegun polynomial approximation as the
    reference (r8bbase.h:1192-1212) so that Kaiser windows match the
    reference bit-for-bit at the formula level.  Vectorized.
    """
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    small = ax < 3.75

    y_s = np.where(small, x / 3.75, 0.0)
    y_s = y_s * y_s
    r_small = 1.0 + y_s * (
        3.5156229
        + y_s
        * (
            3.0899424
            + y_s
            * (1.2067492 + y_s * (0.2659732 + y_s * (0.360768e-1 + y_s * 0.45813e-2)))
        )
    )

    ax_safe = np.where(small, 3.75, ax)
    y_l = 3.75 / ax_safe
    r_large = (
        np.exp(ax_safe)
        / np.sqrt(ax_safe)
        * (
            0.39894228
            + y_l
            * (
                0.1328592e-1
                + y_l
                * (
                    0.225319e-2
                    + y_l
                    * (
                        -0.157565e-2
                        + y_l
                        * (
                            0.916281e-2
                            + y_l
                            * (
                                -0.2057706e-1
                                + y_l
                                * (
                                    0.2635537e-1
                                    + y_l * (-0.1647633e-1 + y_l * 0.392377e-2)
                                )
                            )
                        )
                    )
                )
            )
        )
    )

    out = np.where(small, r_small, r_large)
    if out.ndim == 0:
        return float(out)
    return out


def pow_a(v, p):
    """exp(p * log(|v| + 1e-300)) — power of absolute value (r8bbase.h:1154)."""
    return np.exp(p * np.log(np.abs(v) + 1e-300))


def gauss(v):
    """exp(-v^2) (r8bbase.h:1166)."""
    return np.exp(-(v * v))


def asinh(v):
    """log(v + sqrt(v^2 + 1)) (r8bbase.h:1178)."""
    return np.log(v + np.sqrt(v * v + 1.0))


def clampr(value, minv, maxv):
    """Clamp to [minv, maxv] (r8bbase.h:1117)."""
    return np.minimum(np.maximum(value, minv), maxv)


def bit_occupancy(v: int) -> int:
    """Number of significant bits needed to represent ``v`` (r8bbase.h:766).

    bit_occupancy(0) == 1, bit_occupancy(1) == 1, bit_occupancy(2) == 2, ...
    """
    if v < 0:
        raise ValueError("bit_occupancy expects a non-negative value")
    if v == 0:
        return 1
    return int(v).bit_length()


def sine_sequence(si: float, ph: float, n: int, g: float = 1.0) -> np.ndarray:
    """First ``n`` values of the reference's CSineGen oscillator.

    CSineGen (r8bbase.h:666-755) produces sin(ph + k*si)*g for k = 0..n-1
    via a 2-term recurrence.  We evaluate the closed form directly in f64;
    the recurrence and the closed form agree to ~1 ulp for the short
    sequences used in filter design.
    """
    k = np.arange(n, dtype=np.float64)
    return np.sin(ph + k * si) * g


# -- Spline (polynomial) coefficient calculators -----------------------------
# These convert equidistant samples of a fractional-delay filter tap into
# polynomial-in-x coefficients; used by the fractional-delay filter bank
# (CDSPFracInterpolator.h:128-184).


def spline3p8_coeffs(xm3, xm2, xm1, x0, x1, x2, x3, x4):
    """3rd-order spline over 8 equidistant points (r8bbase.h:980-993).

    Returns (c0, c1, c2, c3); inputs may be arrays (vectorized over taps).
    """
    s = 1.31578947368421052e-2
    c0 = x0
    c1 = (61.0 * (x1 - xm1) + 16.0 * (xm2 - x2) + 3.0 * (x3 - xm3)) * s
    c2 = (
        106.0 * (xm1 + x1)
        + 10.0 * x3
        + 6.0 * xm3
        - 3.0 * x4
        - 29.0 * (xm2 + x2)
        - 167.0 * x0
    ) * s
    c3 = (
        91.0 * (x0 - x1) + 45.0 * (x2 - xm1) + 13.0 * (xm2 - x3) + 3.0 * (x4 - xm3)
    ) * s
    return c0, c1, c2, c3


def spline2p8_coeffs(xm3, xm2, xm1, x0, x1, x2, x3, x4):
    """2nd-order spline over 8 equidistant points (r8bbase.h:1014-1024)."""
    s = 1.31578947368421052e-2
    c0 = x0
    c1 = (61.0 * (x1 - xm1) + 16.0 * (xm2 - x2) + 3.0 * (x3 - xm3)) * s
    c2 = (
        106.0 * (xm1 + x1)
        + 10.0 * x3
        + 6.0 * xm3
        - 3.0 * x4
        - 29.0 * (xm2 + x2)
        - 167.0 * x0
    ) * s
    return c0, c1, c2


def spline3p4_coeffs(y):
    """3rd-order segment polynomial over 4 points (r8bbase.h:1037-1043).

    ``y`` is indexable with y[1] corresponding to x=0.
    """
    c0 = y[1]
    c1 = 0.5 * (y[2] - y[0])
    c2 = y[0] - 2.5 * y[1] + y[2] + y[2] - 0.5 * y[3]
    c3 = 0.5 * (y[3] - y[0]) + 1.5 * (y[1] - y[2])
    return c0, c1, c2, c3


def spline3p6_coeffs(y):
    """3rd-order segment polynomial over 6 points (r8bbase.h:1056-1065)."""
    c0 = y[2]
    c1 = (11.0 * (y[3] - y[1]) + 2.0 * (y[0] - y[4])) / 14.0
    c2 = (20.0 * (y[1] + y[3]) + 2.0 * y[5] - 4.0 * y[0] - 7.0 * y[4] - 31.0 * y[2]) / 14.0
    c3 = (17.0 * (y[2] - y[3]) + 9.0 * (y[4] - y[1]) + 2.0 * (y[0] - y[5])) / 14.0
    return c0, c1, c2, c3
