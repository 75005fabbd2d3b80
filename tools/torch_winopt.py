"""Kaiser (beta, power) table regeneration on the r8brain_torch port
(other/winopt.cpp:13-137 parity; tools/winopt.py's counterpart).

The fractional-delay filter bank's per-length Kaiser parameters of
r8brain_torch/design/_tables.py (FRAC_COEFFS2 / FRAC_COEFFS3, consumed by
design/fracbank.py) were produced by the reference's BiteOptDeep
optimizer.  This tool regenerates them so the shipped constants are
verified design output:

  Problem (winopt.cpp:46-95): for filter length fl (8..30 step 2) build a
  20x-oversampled windowed-sinc prototype — generateBand with Freq1=0,
  Freq2=pi/20, Len2=fl*10, Kaiser window with power raise — normalized to
  DC gain 1, and minimize

      cost = 180 * max |20 log10 |H||  over [0, LinFraction/20 * pi]
                 + max  20 log10 |H|   over [StopFraction/20 * pi, 4/20 * pi]

  with LinFraction = 1.25/bw and StopFraction = 2 - 1/bw (bw = 2 for
  Coeffs2, 3 for Coeffs3) over (beta, power) in [1, 50] x [1, 3].
  The published rows are (beta, power, -stopband-max).

Host only (numpy; tools/torch_optim.py's optimisers).

Usage:
  python tools/torch_winopt.py --bw 2 --fl 8    # one row
  python tools/torch_winopt.py --bw 2           # whole Coeffs2 table
  python tools/torch_winopt.py --verify         # spot-check vs shipped
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from r8brain_torch.design._tables import (FRAC_COEFFS2,  # noqa: E402
                                          FRAC_COEFFS2_BASE, FRAC_COEFFS3,
                                          FRAC_COEFFS3_BASE)
from tools.torch_optim import (differential_evolution,  # noqa: E402
                               pattern_polish)

OVERSAMPLE = 20
LIN_COUNT = 500
STOP_COUNT = 2000
_10LN10 = 10.0 / np.log(10.0)


class _Problem:
    """Vectorized cost for one (bandwidth, filter length)."""

    def __init__(self, bw: int, fl: int):
        assert fl % 2 == 0
        self.len2 = fl * 0.5 * OVERSAMPLE
        fl2 = int(np.floor(self.len2))
        self.t = np.arange(0, fl2 + 1, dtype=np.float64)  # half kernel
        freq2 = np.pi / OVERSAMPLE
        with np.errstate(divide="ignore", invalid="ignore"):
            sinc = np.sin(freq2 * self.t) / (np.pi * self.t)
        sinc[0] = freq2 / np.pi
        self.sinc = sinc
        lin_frac = 1.25 / bw
        stop_frac = 2.0 - 1.0 / bw
        th_lin = (np.pi * lin_frac / OVERSAMPLE
                  * np.arange(LIN_COUNT + 1) / LIN_COUNT)
        th1 = np.pi * stop_frac / OVERSAMPLE
        th2 = np.pi * 4.0 / OVERSAMPLE
        th_stop = th1 + (th2 - th1) * np.arange(STOP_COUNT + 1) / STOP_COUNT
        # symmetric kernel: H(th) = h0 + 2 sum_{t>=1} h_t cos(th t)
        self.Cl = np.cos(np.multiply.outer(self.t, th_lin))
        self.Cl[1:] *= 2.0
        self.Cs = np.cos(np.multiply.outer(self.t, th_stop))
        self.Cs[1:] *= 2.0

    def cost_split(self, P: np.ndarray):
        beta = P[:, 0:1]
        power = P[:, 1:2]
        x = self.t[None, :] / self.len2
        arg = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
        w = _i0(beta * arg) / _i0(beta)
        w = w**power
        h = self.sinc[None, :] * w
        dc = h[:, 0] + 2.0 * np.sum(h[:, 1:], axis=1)
        h = h / dc[:, None]
        Al = h @ self.Cl
        As = h @ self.Cs
        c1 = np.max(np.abs(_10LN10 * np.log(Al * Al + 1e-300)), axis=-1)
        c2 = np.max(_10LN10 * np.log(As * As + 1e-300), axis=-1)
        return c1, c2

    def cost(self, P: np.ndarray) -> np.ndarray:
        c1, c2 = self.cost_split(P)
        return c1 * 180.0 + c2


def _i0(x):
    """Vectorized Abramowitz-Stegun I0 (same polynomial as the design
    layer's bessel_i0, r8bbase.h:1117-1177)."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    small = x < 3.75
    t = np.where(small, x / 3.75, 1.0)
    t2 = t * t
    p_small = 1.0 + t2 * (3.5156229 + t2 * (3.0899424 + t2 * (
        1.2067492 + t2 * (0.2659732 + t2 * (0.0360768 + t2 * 0.0045813)))))
    inv = np.where(small, 1.0, 3.75 / np.where(x > 0, x, 1.0))
    p_big = (np.exp(np.where(small, 0.0, x)) / np.sqrt(np.where(x > 0, x, 1.0))
             * (0.39894228 + inv * (0.01328592 + inv * (0.00225319 + inv * (
                 -0.00157565 + inv * (0.00916281 + inv * (-0.02057706 + inv * (
                     0.02635537 + inv * (-0.01647633 + inv * 0.00392377)))))))))
    return np.where(small, p_small, p_big)


def optimize_win(bw: int, fl: int, *, seed: int = 1, gens: int = 1200,
                 x0=None) -> Tuple[float, float, float, float]:
    """Returns (beta, power, stop atten dB, passband linearity dB)."""
    prob = _Problem(bw, fl)
    lo = np.array([1.0, 1.0])
    hi = np.array([50.0, 3.0])
    best = None
    for s in range(seed, seed + 2):
        x, c = differential_evolution(prob.cost, lo, hi, pop=32, gens=gens,
                                      seed=s, x0=x0)
        x, c = pattern_polish(prob.cost, x, lo, hi)
        if best is None or c < best[1]:
            best = (x, c)
    x = best[0]
    c1, c2 = prob.cost_split(x[None])
    return float(x[0]), float(x[1]), float(-c2[0]), float(c1[0])


def shipped(bw: int):
    return ((FRAC_COEFFS2_BASE, FRAC_COEFFS2) if bw == 2
            else (FRAC_COEFFS3_BASE, FRAC_COEFFS3))


def verify(tol_db: float = 0.5, lens=(0, -1)) -> int:
    """Re-derive the first and last row of each table; compare achieved
    stopband attenuation with shipped."""
    fails = 0
    for bw in (2, 3):
        base, table = shipped(bw)
        for idx in lens:
            row = table[idx]
            i = idx % len(table)
            fl = base + 2 * i
            beta, power, att, lin = optimize_win(bw, fl)
            d = att - row[2]
            ok = abs(d) <= tol_db
            fails += 0 if ok else 1
            print(f"bw {bw} fl {fl:2d}: beta {beta:8.4f} power {power:6.4f} "
                  f"atten {att:9.4f} dB (shipped {row[2]:9.4f}, "
                  f"diff {d:+7.4f}) lin {lin:.2e} "
                  f"{'ok' if ok else 'FAIL'}")
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bw", type=int, choices=(2, 3))
    ap.add_argument("--fl", type=int)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--tol", type=float, default=0.5)
    args = ap.parse_args(argv)
    if args.verify:
        return 1 if verify(tol_db=args.tol) else 0
    if args.bw and args.fl:
        beta, power, att, lin = optimize_win(args.bw, args.fl)
        print(f"{{ {beta:.16f}, {power:.16f}, {att:.4f} }}, // {lin:.4f}")
        return 0
    if args.bw:
        base, table = shipped(args.bw)
        for i, row in enumerate(table):
            fl = base + 2 * i
            beta, power, att, lin = optimize_win(args.bw, fl)
            print(f"fl {fl:2d}: {{ {beta:.16f}, {power:.16f}, "
                  f"{att:.4f} }} (shipped {row[2]:.4f})")
        return 0
    ap.error("need --verify or --bw [--fl]")


if __name__ == "__main__":
    sys.exit(main())
