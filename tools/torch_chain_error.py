#!/usr/bin/env python3
"""Error of a float32 port chain on the card against its float64 path, by
stage and by summation variant, with each variant's oneshot time.

    python tools/torch_chain_error.py [--src 44100] [--dst 352800.3 ...]
        [--tb 2] [--atten 180.15] [--phase 0] [--precision fast]
        [--fused auto] [--conv-engine auto] [--channels 8] [--cmp 8]
        [--seconds 1] [--reps 0] [--variants built conv16 ...]

For each ``--dst``, on full-scale uniform float32 input (seed 0) of
``--channels`` rows, the first ``--cmp`` of them held against the float64
path:

* by stage: each float32 executor of ``Resampler(src, dst, tb, atten,
  phase)`` (``--tb``, ``--atten``, ``--phase``; by default chip_smoke.py's
  filter, 2 and 180.15, linear phase; ``--conv-engine`` for the stage
  chains) on the card and on the CPU (its plain model) is fed the float64
  chain's own input to the stages it covers, rounded to float32, and held
  against those stages' float64 executors: dB re full scale, and the
  error's mean (its DC part) beside its RMS;
* the whole oneshot as built (``built``: each executor's own fold) and
  under variants, tokens joined by ``+``: an executor class's
  ``frac_whole`` folds at 16
  or 32 terms (``conv16``, ``conv32``, ``hb16``, ``hb32``, ``fused16``,
  ``fused32``, ``casc16``, ``casc32``, ``frac16``, ``frac32``; ``all16``
  / ``all32`` every executor that has a fold), the ``toeplitz_sym`` conv
  stages of a "fast" chain in their "high" form (``symhigh``: the fold
  adds' errors and the operators' residual rows), the polynomial stage's
  main sum in float64 (``poly64``), ``FusedPolyExec``'s composite in the
  reference's form, the float32 operator summed in float32
  (``polyf32``); with ``--reps N`` each variant's oneshot over all rows
  timed with CUDA events (mean of N after one warm-up call).

Every line carries the card's name and power limit.  Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TB, ATTEN = 2.0, 180.15   # chip_smoke.py's filter, the defaults
EDGE_S = 0.05             # edge skip, seconds of the output rate
VARIANTS = ("built", "conv32", "conv32+hb16", "conv32+poly64", "conv16",
            "conv16+hb16", "conv16+hb16+poly64", "fused16", "casc16",
            "fused16+casc16", "conv16+casc16", "conv16+fused16+casc16")


def db(d, skip: int) -> tuple:
    """(RMS dB, mean dB) of the error d [C, n] past ``skip`` at each end."""
    import numpy as np

    d = d[:, skip : d.shape[1] - skip]
    rms = float(np.sqrt(np.mean(d * d)))
    mean = float(np.sqrt(np.mean(d.mean(axis=1) ** 2)))
    return (20 * np.log10(max(rms, 1e-300)),
            20 * np.log10(max(mean, 1e-300)))


def f32_poly_form(xc, ops, nloc, S, W, precision, **_kw):
    """``poly_contract`` in the reference's form: the float32 operator
    summed in float32, the residual pass beside it."""
    from r8brain_torch.ops.stages import _ieee_fp32, banded_contract

    with _ieee_fp32():
        o = banded_contract(xc, ops["R64"].float(), nloc, S, W)
    lo = ops["R_lo"]
    return o, None if lo is None else banded_contract(xc, lo, nloc, S, W)


def apply_variant(rs, variant: str, stages):
    """Patch rs's executors in place for ``variant``; returns an undo."""
    from r8brain_torch.ops import poly_fused
    from r8brain_torch.ops.fused import FusedUpExec
    from r8brain_torch.ops.hb_cascade import HBUpCascadeExec

    classes = {"conv": stages.ConvExec, "hb": stages.HBUpExec,
               "fused": FusedUpExec, "casc": HBUpCascadeExec,
               "frac": stages.FracWholeExec, "all": object}
    tokens = [] if variant == "built" else variant.split("+")
    undo = []
    for tok in tokens:
        m = re.fullmatch(r"(conv|hb|fused|casc|frac|all)(16|32)", tok)
        if m is None and tok not in ("poly64", "polyf32", "symhigh"):
            raise SystemExit(f"unknown variant token {tok!r}")
        for ex in rs.execs if m else ():
            op = getattr(ex, "op", None)
            if isinstance(ex, classes[m[1]]) and hasattr(op, "kc"):
                undo.append((op, "kc", op.kc))
                op.kc = int(m[2])
    swapped = []
    for i, ex in enumerate(rs.execs):
        if ("symhigh" in tokens and isinstance(ex, stages.ConvExec)
                and ex.engine == "toeplitz_sym" and ex.precision == "fast"):
            hi = stages.ConvExec(ex.spec, ex.dtype, "high",
                                 engine="toeplitz_sym").to(rs.device)
            swapped.append((i, ex))
            rs.execs[i] = hi
    for ex in rs.execs:
        if "poly64" in tokens and isinstance(ex, stages.FracPolyExec):
            undo.append((ex, "precision", ex.precision))
            ex.precision = "high"
        if hasattr(ex, "_state"):  # operators built per input length
            ex._state.clear()
    orig_ops, orig_contract = stages.poly_operators, poly_fused.poly_contract
    if "poly64" in tokens:  # the float64 sum alone: no spline residual
        stages.poly_operators = lambda *a, **k: {**orig_ops(*a, **k),
                                                 "R_lo": None}
    if "polyf32" in tokens:
        poly_fused.poly_contract = f32_poly_form

    def restore():
        for ex, name, v in undo:
            setattr(ex, name, v)
        for i, ex in swapped:
            rs.execs[i] = ex
        for ex in rs.execs:
            if hasattr(ex, "_state"):
                ex._state.clear()
        stages.poly_operators = orig_ops
        poly_fused.poly_contract = orig_contract
    return restore


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms (CUDA events, one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=float, default=44100)
    ap.add_argument("--dst", type=float, nargs="+", default=[352800.3])
    ap.add_argument("--tb", type=float, default=TB)
    ap.add_argument("--atten", type=float, default=ATTEN)
    ap.add_argument("--phase", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", choices=("fast", "high"), default="fast")
    ap.add_argument("--fused", choices=("auto", "true", "poly", "false"),
                    default="auto")
    ap.add_argument("--conv-engine", default="auto")
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--cmp", type=int, default=8,
                    help="rows held against the float64 path")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=0,
                    help="time each variant's oneshot over N calls")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
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
    fused = {"auto": "auto", "true": True, "poly": "poly",
             "false": False}[args.fused]
    kw = dict(precision=args.precision, fused=fused,
              conv_engine=args.conv_engine)
    filt = (args.tb, args.atten, args.phase)
    g = torch.Generator().manual_seed(0)
    n = int(round(args.src * args.seconds))
    x = torch.rand((args.channels, n), generator=g, dtype=torch.float64) \
        * 2 - 1
    x = x.float().double()  # a float32 signal
    xc = x[: args.cmp]
    xd = x.float().to(dev)
    for dst in args.dst:
        sk = int(EDGE_S * dst)
        tag = (f"{card} | {args.src:g}->{dst} tb {args.tb:g} atten "
               f"{args.atten:g} phase {args.phase} {args.precision}")
        r64 = Resampler(args.src, dst, *filt, dtype=torch.float64,
                        device="cpu")
        r32 = Resampler(args.src, dst, *filt, device=dev, **kw)
        rcpu = Resampler(args.src, dst, *filt, device="cpu", **kw)
        print(f"{tag} fused={args.fused} conv_engine={args.conv_engine} "
              f"executors "
              f"{[type(e).__name__ for e in r32.execs]}, folds "
              f"{[getattr(getattr(e, 'op', None), 'kc', None)
                  for e in r32.execs]}")
        # each float32 executor against the float64 executors of the
        # stages it covers (a fused pair or cascade covers several), fed
        # the float64 chain's own input to them
        st64 = [stages.build_exec(s, torch.float64) for s in r64.plan.stages]
        u, i0 = xc, 0
        for i, (e32, ec) in enumerate(zip(r32.execs, rcpu.execs)):
            n_st = len(getattr(e32, "stages", getattr(e32, "specs", (0,))))
            v = u
            for e64 in st64[i0 : i0 + n_st]:
                v = e64(v)
            i0 += n_st
            uf = u.float()
            yc = e32(uf.to(dev)).cpu().double()
            ym = ec(uf).double()
            check = yc.shape == v.shape == ym.shape
            sks = int(EDGE_S * v.shape[1] / args.seconds)
            (a, am), (b, bm) = (db((y - v).numpy(), sks) for y in (yc, ym))
            print(f"{tag} stage {i} "
                  f"{type(e32).__name__}/{getattr(e32, 'engine', '')}: "
                  f"card {a:.2f} dB (mean {am:.2f}), CPU model "
                  f"{b:.2f} dB (mean {bm:.2f})"
                  f"{'' if check else ' SHAPES DIFFER'}")
            u = v
        ref = r64.oneshot(xc).numpy()
        for variant in args.variants:
            restore = apply_variant(r32, variant, stages)
            try:
                y = r32.oneshot(xd)[: args.cmp].cpu().double().numpy()
                ms = (cuda_ms(lambda: r32.oneshot(xd), args.reps)
                      if args.reps else None)
            finally:
                restore()
            a, am = db(y - ref, sk)
            timing = ("" if ms is None else
                      f"; oneshot {args.channels} x {n} {ms:.3f} ms")
            print(f"{tag} oneshot {variant}: {a:.2f} dB re full scale "
                  f"(mean {am:.2f}){timing}")
        del r32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
