"""Half-band tap-table regeneration on the r8brain_torch port
(other/hbopt.cpp:12-230 parity; tools/hbopt.py's counterpart).

The half-band coefficient tables of r8brain_torch/design/_tables.py
(HB_TABLES / HB3_TABLES, consumed by the half-band stages) were produced
by the reference's BiteOptDeep optimizer.  This tool regenerates them
from scratch so the shipped constants are *verified design output*, not
copied data:

  Problem (hbopt.cpp:46-90): a half-band lowpass has fixed center tap 0.5
  and zero even taps; the free parameters are per-tap gains p_i in [0, 1]
  applied to the ideal half-band sinc taps Sinc_i = sin(pi(2i+1)/2) /
  (pi(2i+1)).  Zero-phase amplitude:

      A(theta) = 0.5 + sum_i p_i * Sinc_i * 2 * cos((2i+1) * theta)

  cost = 3600 * max |20 log10 |A||  over the passband  [0, 1.25/frac * pi]
              + max  20 log10 |A|   over the stopband  [(1 - 1/frac) pi, pi]

  The published tap values are Sinc_i * p_i * 2 (TapMult), and the
  published attenuation is -stopband-max.

Steepness classes: frac in {4, 8, ..., 256} (classes A..G, HB_TABLES
keys 0..6) and {6, 12, ..., 384} for the 1/3-band tables (HB3_TABLES).

Host only (numpy; tools/torch_optim.py's optimisers).

Usage:
  python tools/torch_hbopt.py --frac 4 --taps 7     # one filter
  python tools/torch_hbopt.py --cls 0 --third       # one whole class
  python tools/torch_hbopt.py --verify              # spot-check vs shipped
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Tuple

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from r8brain_torch.design._tables import HB3_TABLES, HB_TABLES  # noqa: E402
from tools.torch_optim import (differential_evolution,  # noqa: E402
                               pattern_polish)

PASS_COUNT = 250
STOP_COUNT = 500
_10LN10 = 10.0 / np.log(10.0)


def _grids(frac: float) -> Tuple[np.ndarray, np.ndarray]:
    th_pass = np.pi * (1.25 / frac) * np.arange(PASS_COUNT + 1) / PASS_COUNT
    th_stop = np.pi * (1.0 - (1.0 / frac) * np.arange(STOP_COUNT + 1)
                       / STOP_COUNT)
    return th_pass, th_stop


def _bases(taps: int, frac: float):
    sinc = np.array([np.sin((2 * i + 1) * np.pi * 0.5) / ((2 * i + 1)
                                                          * np.pi)
                     for i in range(taps)])
    th_pass, th_stop = _grids(frac)
    k = 2 * np.arange(taps) + 1
    # A = 0.5 + P @ B with B[i, f] = sinc_i * 2 * cos(k_i * th_f)
    Bp = sinc[:, None] * 2.0 * np.cos(np.multiply.outer(k, th_pass))
    Bs = sinc[:, None] * 2.0 * np.cos(np.multiply.outer(k, th_stop))
    return sinc, Bp, Bs


def hb_cost_split(P: np.ndarray, Bp: np.ndarray, Bs: np.ndarray):
    """Vectorized (passband-ripple-max, stopband-max) in dB for a
    population P[pop, taps] of tap gains."""
    Ap = 0.5 + P @ Bp
    As = 0.5 + P @ Bs
    c1 = np.max(np.abs(_10LN10 * np.log(Ap * Ap + 1e-300)), axis=-1)
    c2 = np.max(_10LN10 * np.log(As * As + 1e-300), axis=-1)
    return c1, c2


def optimize_hb(taps: int, frac: float, *, seed: int = 1, gens: int = 4000
                ) -> Tuple[np.ndarray, float, float]:
    """Returns (tap values ready for the HB stages, passband ripple dB,
    stopband attenuation dB)."""
    sinc, Bp, Bs = _bases(taps, frac)

    def fn(P):
        c1, c2 = hb_cost_split(P, Bp, Bs)
        return c1 * 3600.0 + c2

    lo = np.zeros(taps)
    hi = np.ones(taps)
    best = None
    for s in range(seed, seed + 3):  # restarts guard against local optima
        x, c = differential_evolution(fn, lo, hi, pop=16 * taps,
                                      gens=gens, seed=s)
        x, c = pattern_polish(fn, x, lo, hi)
        if best is None or c < best[1]:
            best = (x, c)
    x = best[0]
    c1, c2 = hb_cost_split(x[None], Bp, Bs)
    return sinc * x * 2.0, float(c1[0]), float(-c2[0])


def shipped_row(cls: int, taps: int, third: bool):
    """(shipped taps, shipped atten) for a class + tap count, or None."""
    tables = HB3_TABLES if third else HB_TABLES
    attens, rows = tables[cls]
    for a, r in zip(attens, rows):
        if len(r) == taps:
            return np.asarray(r), float(a)
    return None


def class_frac(cls: int, third: bool) -> float:
    return (6.0 if third else 4.0) * (2.0 ** cls)


def verify(max_taps: int = 4, tol_db: float = 0.5) -> int:
    """Re-derive one small filter per steepness class and compare the
    achieved stopband attenuation (and taps) with the shipped tables."""
    fails = 0
    for third in (False, True):
        tables = HB3_TABLES if third else HB_TABLES
        for cls in sorted(tables):
            attens, rows = tables[cls]
            cand = [r for r in rows if len(r) <= max_taps]
            if not cand:
                cand = [min(rows, key=len)]
            taps = len(cand[0])
            ship = shipped_row(cls, taps, third)
            frac = class_frac(cls, third)
            got, rip, att = optimize_hb(taps, frac)
            ship_taps, ship_att = ship
            d_att = att - ship_att
            d_tap = np.max(np.abs(got - ship_taps))
            ok = abs(d_att) <= tol_db
            fails += 0 if ok else 1
            print(f"{'third' if third else 'half '} cls {cls} frac "
                  f"{frac:6.0f} taps {taps}: atten {att:9.4f} dB "
                  f"(shipped {ship_att:9.4f}, diff {d_att:+7.4f}) "
                  f"tapdiff {d_tap:.2e} ripple {rip:.2e} dB "
                  f"{'ok' if ok else 'FAIL'}")
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frac", type=float, help="steepness fraction")
    ap.add_argument("--taps", type=int, help="tap count")
    ap.add_argument("--cls", type=int, help="regenerate a whole class")
    ap.add_argument("--third", action="store_true",
                    help="1/3-band tables (HB3)")
    ap.add_argument("--verify", action="store_true",
                    help="spot-check one row per class vs shipped tables")
    ap.add_argument("--tol", type=float, default=0.5)
    args = ap.parse_args(argv)
    if args.verify:
        return 1 if verify(tol_db=args.tol) else 0
    if args.cls is not None:
        tables = HB3_TABLES if args.third else HB_TABLES
        attens, rows = tables[args.cls]
        frac = class_frac(args.cls, args.third)
        for a, r in zip(attens, rows):
            t, rip, att = optimize_hb(len(r), frac)
            print(f"taps {len(r)}: {att:.4f} dB (shipped {a:.4f})")
            print("  " + ", ".join(f"{v:.16e}" for v in t))
        return 0
    if args.frac and args.taps:
        t, rip, att = optimize_hb(args.taps, args.frac)
        print(f"// {att:.4f} dB, frac {args.frac:.0f}, ripple {rip:.2e} dB")
        print(", ".join(f"{v:.16e}" for v in t))
        return 0
    ap.error("need --verify, --cls, or --frac with --taps")


if __name__ == "__main__":
    sys.exit(main())
