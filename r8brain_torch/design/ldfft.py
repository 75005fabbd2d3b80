"""Extended-precision (long double) complex FFT for the cepstral transform.

The min-phase transform takes log() of stop-band magnitudes that sit only
~100x above the float64 FFT noise floor at high attenuation, so any two f64
FFT implementations disagree there and the resulting phase/taps/latency skew
"purely at random" — the reference documents this as an intrinsic limit
(CDSPFIRFilter.h:40-46).  Running the transform's FFTs in 80-bit extended
precision (numpy longdouble on x86: eps 1.08e-19, ~1000x below f64) drops
the noise floor far under the deepest supported stop-band (atten 218 =
1.26e-11 of peak), making min-phase designs reproducible across
implementations instead of random.  The native designer
(native/r8bt_design.cpp) mirrors this with std::complex<long double>.

On platforms where long double IS double (Windows, ARM), HAVE_LONGDOUBLE is
False and callers fall back to the f64 numpy FFT — reference-equivalent
behavior, including its documented high-atten randomness.

Plain iterative radix-2 Cooley-Tukey, vectorized over numpy longdouble
(design-time only: 4 FFTs of <= 2^17 points per min-phase design).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HAVE_LONGDOUBLE", "fft_ld", "PI_LD"]

HAVE_LONGDOUBLE = np.finfo(np.longdouble).eps < 1e-18

# numpy parses longdouble strings at full precision; np.pi is only f64.
PI_LD = np.longdouble("3.14159265358979323846264338327950288")

_rev_cache: dict = {}


def _bit_reverse_idx(n: int) -> np.ndarray:
    idx = _rev_cache.get(n)
    if idx is None:
        bits = n.bit_length() - 1
        idx = np.zeros(n, dtype=np.intp)
        for b in range(bits):
            idx[1 << b : 2 << b] = idx[: 1 << b] + (n >> (b + 1))
        _rev_cache[n] = idx
    return idx


def fft_ld(a: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Complex FFT in long double.  a: any complex/real array of pow2 size;
    returns clongdouble.  Forward unnormalized; inverse scaled by 1/n."""
    a = np.asarray(a, dtype=np.clongdouble)
    n = a.size
    if n & (n - 1) or n == 0:
        raise ValueError(f"size must be a power of two, got {n}")
    a = a[_bit_reverse_idx(n)]  # fancy indexing already yields a fresh array
    sign = 1.0 if inverse else -1.0
    m = 1
    while m < n:
        theta = (sign * PI_LD / m) * np.arange(m, dtype=np.longdouble)
        w = np.cos(theta) + 1j * np.sin(theta)  # cosl/sinl
        a = a.reshape(-1, 2 * m)
        t = a[:, m:] * w
        hi = a[:, :m] - t
        a[:, :m] += t
        a[:, m:] = hi
        a = a.reshape(-1)
        m *= 2
    if inverse:
        a /= np.longdouble(n)
    return a
