#!/usr/bin/env python3
"""Error of a float32 port chain on the card against its float64 path, by
stage and by summation variant.

    python tools/torch_chain_error.py [--src 44100] [--dst 352800.3 ...]
        [--channels 8] [--seconds 1]

For each ``--dst``, on full-scale uniform float32 input (seed 0):

* by stage: each float32 executor of ``Resampler(src, dst, 2, 180.15)``
  (precision "fast") on the card and on the CPU (its plain model) is fed
  the float64 chain's own input to that stage, rounded to float32, and
  held against the float64 executor's output: dB re full scale, and the
  error's mean (its DC part) beside its RMS;
* the whole oneshot as built (the conv stages' fold by
  ``models/resampler.py`` LONG_CHAIN) and under variants: the conv
  stages' ``frac_whole`` folds at 32 or 16 terms (``conv32``,
  ``conv16``), the half-band stages' at 16 (``hb16``), the polynomial
  stage's main sum in float64 (``poly64``).

Every line carries the card's name and power limit.  Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TB, ATTEN = 2.0, 180.15   # chip_smoke.py's filter
EDGE_S = 0.05             # edge skip, seconds of the output rate
VARIANTS = ((), ("conv32",), ("conv32", "hb16"), ("conv32", "poly64"),
            ("conv16",), ("conv16", "hb16"), ("conv16", "hb16", "poly64"))


def db(d, skip: int) -> tuple:
    """(RMS dB, mean dB) of the error d [C, n] past ``skip`` at each end."""
    import numpy as np

    d = d[:, skip : d.shape[1] - skip]
    rms = float(np.sqrt(np.mean(d * d)))
    mean = float(np.sqrt(np.mean(d.mean(axis=1) ** 2)))
    return (20 * np.log10(max(rms, 1e-300)),
            20 * np.log10(max(mean, 1e-300)))


def apply_variant(rs, variant, stages):
    """Patch rs's executors in place for ``variant``; returns an undo."""
    from r8brain_torch.ops.pallas_frac import KC, KC_LO

    undo = []
    for ex in rs.execs:
        for kc, name in ((KC, "conv32"), (KC_LO, "conv16")):
            if name in variant and isinstance(ex, stages.ConvExec):
                undo.append((ex, "kc", ex.kc))
                ex.kc = kc
        if "hb16" in variant and isinstance(ex, stages.HBUpExec):
            undo.append((ex, "kc", ex.kc))
            ex.kc = KC_LO
        if "poly64" in variant and isinstance(ex, stages.FracPolyExec):
            undo.append((ex, "precision", ex.precision))
            ex.precision = "high"
            ex._state.clear()
    orig_ops = stages.poly_operators
    if "poly64" in variant:  # the float64 sum alone: no spline residual
        stages.poly_operators = lambda *a, **k: {**orig_ops(*a, **k),
                                                 "R_lo": None}

    def restore():
        for ex, name, v in undo:
            setattr(ex, name, v)
            if isinstance(ex, stages.FracPolyExec):
                ex._state.clear()
        stages.poly_operators = orig_ops
    return restore


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=float, default=44100)
    ap.add_argument("--dst", type=float, nargs="+", default=[352800.3])
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_chain_error: CUDA is not available", file=sys.stderr)
        return 2
    from r8brain_torch import Resampler
    from r8brain_torch.ops import stages

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    n = int(round(args.src * args.seconds))
    x = torch.rand((args.channels, n), generator=g, dtype=torch.float64) \
        * 2 - 1
    x = x.float().double()  # a float32 signal
    for dst in args.dst:
        sk = int(EDGE_S * dst)
        r64 = Resampler(args.src, dst, TB, ATTEN, dtype=torch.float64,
                        device="cpu")
        r32 = Resampler(args.src, dst, TB, ATTEN, device=dev)
        rcpu = Resampler(args.src, dst, TB, ATTEN, device="cpu")
        print(f"{card} | {args.src:g}->{dst} executors "
              f"{[type(e).__name__ for e in r32.execs]}, conv fold "
              f"{r32.conv_kc}")
        own = all(type(e).apply is not torch.nn.Module.apply
                  for e in (*r32.execs, *r64.execs))
        if own and len(r32.execs) == len(r64.execs):
            u = x
            for i, (e64, e32, ec) in enumerate(zip(r64.execs, r32.execs,
                                                   rcpu.execs)):
                v = e64.apply(u)
                uf = u.float()
                yc = e32.apply(uf.to(dev)).cpu().double()
                ym = ec.apply(uf).double()
                check = yc.shape == v.shape == ym.shape
                sks = int(EDGE_S * v.shape[1] / args.seconds)
                (a, am), (b, bm) = (db((y - v).numpy(), sks)
                                    for y in (yc, ym))
                print(f"{card} | {args.src:g}->{dst} stage {i} "
                      f"{type(e32).__name__}/{getattr(e32, 'engine', '')}: "
                      f"card {a:.2f} dB (mean {am:.2f}), CPU model "
                      f"{b:.2f} dB (mean {bm:.2f})"
                      f"{'' if check else ' SHAPES DIFFER'}")
                u = v
        ref = r64.oneshot(x).numpy()
        for variant in VARIANTS:
            restore = apply_variant(r32, variant, stages)
            try:
                y = r32.oneshot(x.float().to(dev)).cpu().double().numpy()
            finally:
                restore()
            a, am = db(y - ref, sk)
            print(f"{card} | {args.src:g}->{dst} oneshot "
                  f"{'+'.join(variant) or 'as built'}: {a:.2f} dB re full "
                  f"scale (mean {am:.2f})")
        del r32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
