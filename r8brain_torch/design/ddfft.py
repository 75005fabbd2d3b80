"""Double-double complex FFT for the cepstral min-phase transform.

Same iterative radix-2 structure as design/ldfft.py, with every
arithmetic step in deterministic df64 (design/dd.py) so the transform is
bit-identical across platforms and across the Python/native designers
(mirror: native/r8bt_dd.cpp).  Twiddles are built without libm: the
primitive root exp(sign*2*pi*i/n) comes from the fixed-sequence df64
sin/cos (its angle 2*pi/n is an EXACT power-of-two scaling of the df64
2*pi constant), the power-of-two roots by repeated complex squaring, and
w^j by binary decomposition of j — every element's product chain is the
same fixed op sequence on every platform.

Accuracy: twiddle error ~ (log2 n)^2 * eps_dd ~ 1e-29 at n = 2^17; FFT
noise floor ~ 1e-29 of peak — 1e18x below the deepest supported
stop-band (atten 218 = 1.26e-11), vs the 80-bit path's ~1e-8x margin.

Design-time only (4 FFTs of <= 2^17 points per min-phase design; results
cached by the LP-filter cache).
"""

from __future__ import annotations

import numpy as np

from . import dd
from .dd import DD
from .ldfft import _bit_reverse_idx

__all__ = ["CDD", "cfft_dd"]


class CDD:
    """Complex df64 array: re and im are dd.DD pairs."""

    __slots__ = ("re", "im")

    def __init__(self, re: DD, im: DD):
        self.re = re
        self.im = im

    @staticmethod
    def zeros(n: int) -> "CDD":
        z = np.zeros(n, dtype=np.float64)
        return CDD(DD(z.copy(), z.copy()), DD(z.copy(), z.copy()))


def _cmul(ar: DD, ai: DD, br: DD, bi: DD):
    re = dd.sub(dd.mul(ar, br), dd.mul(ai, bi))
    im = dd.add(dd.mul(ar, bi), dd.mul(ai, br))
    return re, im


def _csqr(ar: DD, ai: DD):
    re = dd.sub(dd.sqr(ar), dd.sqr(ai))
    im = dd.mul_pow2(dd.mul(ar, ai), 2.0)
    return re, im


def _twiddle_table(n: int, inverse: bool):
    """w[j] = exp(sign * 2*pi*i * j / n), j in [0, n/2)."""
    half = n // 2
    sign = 1.0 if inverse else -1.0
    # exact power-of-two angle: (sign/n) * df64(2*pi)
    theta = dd.mul_pow2(dd.TWO_PI, np.float64(sign / n))
    s, c = dd.sincos(theta)
    # roots r^(2^b) by repeated squaring
    bits = max(0, half.bit_length() - 1)
    sq = [(c, s)]
    for _ in range(1, bits):
        sq.append(_csqr(*sq[-1]))
    j = np.arange(half)
    re = DD(np.ones(half), np.zeros(half))
    im = DD(np.zeros(half), np.zeros(half))
    for b in range(bits):
        m = (j >> b) & 1 == 1
        if not m.any():
            continue
        br, bi = sq[b]
        nre, nim = _cmul(DD(re.hi[m], re.lo[m]), DD(im.hi[m], im.lo[m]),
                         br, bi)
        re.hi[m], re.lo[m] = nre.hi, nre.lo
        im.hi[m], im.lo[m] = nim.hi, nim.lo
    return re, im


def cfft_dd(x: CDD, inverse: bool = False) -> CDD:
    """In-order complex FFT, power-of-two size.  Forward unnormalized;
    inverse scaled by 1/n (exact power-of-two scaling)."""
    n = x.re.hi.size
    if n & (n - 1) or n == 0:
        raise ValueError(f"size must be a power of two, got {n}")
    idx = _bit_reverse_idx(n)
    re = DD(x.re.hi[idx], x.re.lo[idx])
    im = DD(x.im.hi[idx], x.im.lo[idx])
    wre, wim = _twiddle_table(n, inverse)
    m = 1
    while m < n:
        stride = (n // 2) // m
        twr = DD(wre.hi[::stride][:m], wre.lo[::stride][:m])
        twi = DD(wim.hi[::stride][:m], wim.lo[::stride][:m])
        r2 = lambda a: DD(a.hi.reshape(-1, 2 * m), a.lo.reshape(-1, 2 * m))
        re2, im2 = r2(re), r2(im)
        ur = DD(re2.hi[:, :m], re2.lo[:, :m])
        ui = DD(im2.hi[:, :m], im2.lo[:, :m])
        vr0 = DD(re2.hi[:, m:], re2.lo[:, m:])
        vi0 = DD(im2.hi[:, m:], im2.lo[:, m:])
        vr, vi = _cmul(vr0, vi0, twr, twi)
        hr, hi_ = dd.sub(ur, vr), dd.sub(ui, vi)
        lr, li = dd.add(ur, vr), dd.add(ui, vi)
        re2.hi[:, :m], re2.lo[:, :m] = lr.hi, lr.lo
        im2.hi[:, :m], im2.lo[:, :m] = li.hi, li.lo
        re2.hi[:, m:], re2.lo[:, m:] = hr.hi, hr.lo
        im2.hi[:, m:], im2.lo[:, m:] = hi_.hi, hi_.lo
        m *= 2
    if inverse:
        s = np.float64(1.0 / n)  # n is a power of two: exact
        re = dd.mul_pow2(re, s)
        im = dd.mul_pow2(im, s)
    return CDD(re, im)
