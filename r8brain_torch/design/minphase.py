"""Minimum-phase transform via cepstral discrete Hilbert transform.

Host-side counterpart of calcMinPhaseTransform (reference:
CDSPRealFFT.h:681-785; algorithm per Damera-Venkata et al., cited at
CDSPRealFFT.h:663).  Runs host-side once at plan time.

Precision: the reference runs this in float64 and documents that the result
then skews "purely at random" (CDSPFIRFilter.h:40-46) — at high attenuation
the stop-band magnitude sits only ~100x above the f64 FFT noise floor, so
log() of those bins is implementation-dependent noise that the Hilbert step
spreads into every tap (measured: two f64 FFT backends give taps apart 8e-3
and LATENCY estimates apart 18 samples at atten 218).  This implementation
removes the randomness entirely: the default backend evaluates all four
FFTs (and the log/sqrt/sincos between them) in deterministic double-double
arithmetic built from IEEE-754 binary64 primitives only (design/dd.py,
design/ddfft.py; eps ~4.9e-32, FFT noise ~1e18x below the deepest supported
stop-band), with NO libm in the value path — so the transform produces the
SAME BITS on every conforming platform, and the native designer's mirror
(native/r8bt_dd.cpp) is bit-identical to it (tests/test_minphase_dd.py).
The 80-bit long-double backend (design/ldfft.py, the earlier default,
~1e-7 taps from dd at atten 218 — its own noise) and the
reference-equivalent f64 backend remain available via
R8B_MINPHASE_BACKEND for comparison.

Algorithm:
  1. zero-pad kernel to Len = 2^ceil(log2(kernel_len * len_mult)),
  2. log-magnitude spectrum (biased by the dtype's smallest normal
     against log(0)),
  3. inverse FFT -> real cepstrum,
  4. causal fold: c[0]=0, c[1..N/2-1] kept, c[N/2]=0, c[N/2+1..] negated
     (the discrete Hilbert window, CDSPRealFFT.h:737-749),
  5. forward FFT -> i*theta(w) (pure imaginary): the minimum phase,
  6. H_min = |H| * exp(i*theta), with DC and Nyquist bins keeping their
     original signed values (CDSPRealFFT.h:757-758),
  7. inverse FFT -> minimum-phase kernel (first kernel_len taps).
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np

from ..utils.fir import calc_fir_group_delay

__all__ = ["min_phase_transform"]


def _backend() -> str:
    """auto = dd: the deterministic double-double transform
    (design/dd.py), built from IEEE-754 binary64 primitives only — the
    SAME bits on every platform and bit-identical to the native
    designer's mirror (native/r8bt_dd.cpp; pinned in
    tests/test_minphase_dd.py).  It is also the most accurate backend
    (~1e-29 FFT noise floor vs the 80-bit path's ~1e-16 of the atten-218
    stop-band).  R8B_MINPHASE_BACKEND in {auto, dd, ld, f64} overrides:
    ld = the 80-bit long-double path (x86 only; the earlier default),
    f64 = reference-equivalent behavior with its documented high-atten
    randomness (CDSPFIRFilter.h:40-46) — both kept for comparison
    tests."""
    b = os.environ.get("R8B_MINPHASE_BACKEND", "auto")
    if b == "auto":
        return "dd"
    if b not in ("ld", "dd", "f64"):
        raise ValueError(f"R8B_MINPHASE_BACKEND={b!r}")
    return b


def _min_phase_dd(kernel: np.ndarray, n: int, n2: int) -> np.ndarray:
    """Deterministic double-double cepstral transform (design/dd.py,
    design/ddfft.py; mirrored bit-for-bit by native/r8bt_dd.cpp).  Used
    where long double is plain binary64 — there this is the only way to
    keep min-phase designs reproducible across implementations; its
    ~1e-29 FFT noise floor is in fact ~1e10x below the 80-bit path's."""
    from . import dd
    from .ddfft import CDD, cfft_dd

    kernel_len = kernel.shape[0]
    tiny = np.float64(np.finfo(np.float64).tiny)  # log(0) guard

    buf = CDD.zeros(n)
    buf.re.hi[:kernel_len] = kernel
    spec = cfft_dd(buf)

    re = dd.DD(spec.re.hi[: n2 + 1], spec.re.lo[: n2 + 1])
    im = dd.DD(spec.im.hi[: n2 + 1], spec.im.lo[: n2 + 1])
    mag = dd.sqrt(dd.add(dd.sqr(re), dd.sqr(im)))
    dc_val = dd.DD(spec.re.hi[0], spec.re.lo[0])
    nyq_val = dd.DD(spec.re.hi[n2], spec.re.lo[n2])

    logmag = dd.log(dd.add(mag, dd.dd_from(np.full(n2 + 1, tiny))))
    dc_abs = dd.DD(np.abs(dc_val.hi), np.where(dc_val.hi < 0,
                                               -dc_val.lo, dc_val.lo))
    nyq_abs = dd.DD(np.abs(nyq_val.hi), np.where(nyq_val.hi < 0,
                                                 -nyq_val.lo, nyq_val.lo))
    l0 = dd.log(dd.add(dc_abs, dd.dd_from(tiny)))
    ln = dd.log(dd.add(nyq_abs, dd.dd_from(tiny)))
    logmag.hi[0], logmag.lo[0] = l0.hi, l0.lo
    logmag.hi[n2], logmag.lo[n2] = ln.hi, ln.lo

    # cep = irfft(logmag): even-symmetric real spectrum -> real cepstrum
    full = CDD.zeros(n)
    full.re.hi[: n2 + 1] = logmag.hi
    full.re.lo[: n2 + 1] = logmag.lo
    full.re.hi[n2 + 1 :] = logmag.hi[1:n2][::-1]
    full.re.lo[n2 + 1 :] = logmag.lo[1:n2][::-1]
    cep_c = cfft_dd(full, inverse=True)

    # discrete Hilbert window (CDSPRealFFT.h:737-749) on the real part
    cep = CDD.zeros(n)
    cep.re.hi[1:n2] = cep_c.re.hi[1:n2]
    cep.re.lo[1:n2] = cep_c.re.lo[1:n2]
    cep.re.hi[n2 + 1 :] = -cep_c.re.hi[n2 + 1 :]
    cep.re.lo[n2 + 1 :] = -cep_c.re.lo[n2 + 1 :]
    theta_c = cfft_dd(cep)
    theta = dd.DD(theta_c.im.hi[: n2 + 1], theta_c.im.lo[: n2 + 1])

    s, c = dd.sincos(theta)
    out_re = dd.mul(mag, c)
    out_im = dd.mul(mag, s)
    out_re.hi[0], out_re.lo[0] = dc_val.hi, dc_val.lo
    out_im.hi[0], out_im.lo[0] = 0.0, 0.0
    out_re.hi[n2], out_re.lo[n2] = nyq_val.hi, nyq_val.lo
    out_im.hi[n2], out_im.lo[n2] = 0.0, 0.0

    full = CDD.zeros(n)
    full.re.hi[: n2 + 1] = out_re.hi
    full.re.lo[: n2 + 1] = out_re.lo
    full.im.hi[: n2 + 1] = out_im.hi
    full.im.lo[: n2 + 1] = out_im.lo
    full.re.hi[n2 + 1 :] = out_re.hi[1:n2][::-1]
    full.re.lo[n2 + 1 :] = out_re.lo[1:n2][::-1]
    full.im.hi[n2 + 1 :] = -out_im.hi[1:n2][::-1]
    full.im.lo[n2 + 1 :] = -out_im.lo[1:n2][::-1]
    res = cfft_dd(full, inverse=True)
    return dd.to_f64(dd.DD(res.re.hi[:kernel_len], res.re.lo[:kernel_len]))


def min_phase_transform(
    kernel: np.ndarray,
    len_mult: int = 2,
    do_final_mul: bool = True,
) -> Tuple[np.ndarray, float]:
    """Return (min-phase kernel of the same length, DC group delay).

    ``len_mult`` is the frequency-domain oversampling factor; the LP filter
    designer uses 16 (CDSPFIRFilter.h:479).  ``do_final_mul`` is accepted for
    interface parity; scaling is exact here either way since we use unitary-
    normalized numpy FFTs.
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    kernel_len = kernel.shape[0]
    if kernel_len <= 0:
        raise ValueError("empty kernel")
    if len_mult < 2:
        raise ValueError("len_mult must be >= 2")

    len_bits = max(1, int(math.ceil(math.log2(kernel_len * len_mult))))
    n = 1 << len_bits
    n2 = n >> 1

    backend = _backend()
    if backend == "dd":
        out = _min_phase_dd(kernel, n, n2)
        return out, calc_fir_group_delay(out, 0.0)

    from .ldfft import HAVE_LONGDOUBLE, fft_ld

    if backend == "ld" and not HAVE_LONGDOUBLE:
        # an explicit ld request must not silently degrade to the f64
        # reference-randomness path (it would poison dd-vs-ld comparisons,
        # the env var's documented purpose)
        raise RuntimeError(
            "R8B_MINPHASE_BACKEND=ld requested but this ABI's long double "
            "is plain binary64; use the default dd backend (or f64 for the "
            "reference-equivalent comparison)")

    if backend == "ld":
        # log(0) guard: the smallest normal of the platform's long double
        # (x86 80-bit: ~3.36e-4932; double-double: ~f64 tiny).  A literal
        # like 1e-4000 would silently underflow to 0 where long double has
        # only f64 exponent range, losing the guard.  The native designer
        # uses std::numeric_limits<long double>::min() — bit-identical on
        # matching ABIs.
        real_t, tiny = np.longdouble, np.finfo(np.longdouble).tiny

        def rfft(x):
            return fft_ld(x)[: n2 + 1]

        def irfft_half(X_half):
            full = np.zeros(n, dtype=np.clongdouble)
            full[: n2 + 1] = X_half
            full[n2 + 1 :] = np.conj(X_half[1:n2][::-1])
            return fft_ld(full, inverse=True).real
    else:  # f64 fallback (np.longdouble == float64 on this ABI)
        # Match the native designer, which biases with
        # numeric_limits<long double>::min() == DBL_MIN on 64-bit long
        # double ABIs — so both designers stay bit-identical there.  The
        # reference's literal is 1e-300 (CDSPRealFFT.h:716); the two
        # differ only for exact-zero magnitude bins, which windowed-sinc
        # spectra do not produce.
        real_t, tiny = np.float64, np.finfo(np.float64).tiny
        rfft = np.fft.rfft

        def irfft_half(X_half):
            return np.fft.irfft(X_half, n)

    buf = np.zeros(n, dtype=real_t)
    buf[:kernel_len] = kernel

    spec = rfft(buf)  # length n2+1
    mag = np.abs(spec)

    # Save signed DC / Nyquist values (CDSPRealFFT.h:716-719).
    dc_val = spec[0].real
    nyq_val = spec[n2].real

    logmag = np.log(mag + tiny)
    logmag[0] = np.log(np.abs(dc_val) + tiny)
    logmag[n2] = np.log(np.abs(nyq_val) + tiny)

    # Real cepstrum of the log-magnitude (even) spectrum.
    cep = irfft_half(logmag)

    # Discrete Hilbert windowing (CDSPRealFFT.h:737-749).
    cep[0] = 0.0
    cep[n2] = 0.0
    cep[n2 + 1 :] = -cep[n2 + 1 :]

    # Forward transform gives i*theta at each bin (odd real input ->
    # pure imaginary spectrum).
    theta = rfft(cep).imag

    out_spec = mag * (np.cos(theta) + 1j * np.sin(theta))
    out_spec[0] = dc_val
    out_spec[n2] = nyq_val

    out = np.asarray(irfft_half(out_spec)[:kernel_len], dtype=np.float64)
    dc_group_delay = calc_fir_group_delay(out, 0.0)
    return out, dc_group_delay
