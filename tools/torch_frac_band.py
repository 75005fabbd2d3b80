#!/usr/bin/env python3
"""frac_whole's band walk on the card: each column tile walks only the
folds that meet its operator band (``operator_band``), and its output must
be the full walk's bit for bit.

    python tools/torch_frac_band.py [--reps 20] [--only LABEL ...]

For each call in LABELS, taken from the executors that make it (1024
channels of uniform input): the kernel's y with the executor's band
against y with a full band (every fold within D, what the kernel walked
before the band), compared bit for bit; the folds a row tile walks with
the band and in full; and both timed with CUDA events in turns (full,
band, band, full; chip_smoke.cuda_ms).  Prints one line a call and the
card's name; exits non-zero if an output differs.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the calls: the fused flagship fast and "high" (four slices), 44.1k ->
#: 96001's two toeplitz convs, the half-band up (44.1k -> 192k) and down
#: (192k -> 44.1k) stages, the direct conv stage (the 8-column tile) and a
#: steady block of the flagship's stream
LABELS = ("flagship_fast", "flagship_high", "toeplitz_964", "toeplitz_561",
          "hb_up", "hb_down", "direct", "stream_block")
CHANNELS = 1024
SEED = 21


def full_band(parts, D: int):
    """The band of every fold within D in every column tile: the walk the
    kernel made before it read a band."""
    import torch

    from r8brain_torch.ops.pallas_frac import K_STEP, OperatorBand

    steps = torch.tensor([[0, -(-D // K_STEP)]] * parts.shape[0],
                         dtype=torch.int32, device=parts.device)
    return OperatorBand(steps)


def _record(fn):
    """fn() with the executors' frac_whole calls recorded as (args, kw)."""
    from r8brain_torch.ops import operators

    calls, real = [], operators.frac_whole

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    try:
        operators.frac_whole = rec
        fn()
    finally:
        operators.frac_whole = real
    return calls


def _stream_call(dev, g, channels):
    """The frac_whole call of a steady block (the fourth) of the flagship's
    stream of ``channels`` streams, blocks of 8192 samples asked (8232
    after the flagship's period)."""
    import torch

    from r8brain_torch import Resampler, StreamResampler

    st = StreamResampler(Resampler(44100, 96000, 2.0, 180.15, device=dev),
                         8192)

    def run():
        for _ in range(4):
            x = torch.rand((channels, st.block), generator=g, device=dev)
            st.process_block_device(x * 2 - 1)

    (xp, parts, I, D, O, n_win), kw = _record(run)[-1]
    return xp.clone(), parts, I, D, O, n_win, kw["kc"], kw["band"]


def call(label: str, dev, channels: int = CHANNELS):
    """(xp, parts, I, D, O, n_win, kc, band) of the call ``label`` on
    ``dev``, band the executor's own, xp ``channels`` rows seeded uniform
    in [-1, 1)."""
    import torch

    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.fused import FusedUpExec
    from r8brain_torch.ops.stages import ConvExec, HBDownExec, HBUpExec

    g = torch.Generator(device=dev).manual_seed(SEED)
    if label == "stream_block":
        return _stream_call(dev, g, channels)
    f32 = torch.float32
    if label.startswith("flagship"):
        ex = FusedUpExec(make_plan(44100, 96000, 2.0, 180.15, 0), f32,
                         label.split("_")[1]).to(dev)
        geo = (ex.p_in, ex.D, ex.p_out, 150, ex.op.parts, ex.op.kc,
               ex.op.band)
    elif label.startswith("toeplitz"):
        p = make_plan(44100, 96001, 2.0, 180.15, 0)
        i, n_blk = (0, 173) if label == "toeplitz_964" else (2, 188)
        ex = ConvExec(p.stages[i], f32, "fast", engine="toeplitz").to(dev)
        geo = (ex.B_toep * ex.spec.down, ex.op.L_f, ex.B_toep * ex.spec.up,
               n_blk, ex.op.parts, ex.op.kc, ex.op.band)
    elif label.startswith("hb"):
        up = label == "hb_up"
        p = make_plan(*((44100, 192000) if up else (192000, 44100)), 2.0,
                      180.15, 0)
        kind = "hb_up" if up else "hb_down"
        spec = next(s for s in p.stages if s.kind == kind)
        ex = (HBUpExec if up else HBDownExec)(spec, f32).to(dev)
        geo = (ex._geometry(ex.op.L_f)[2], ex.op.L_f, ex.op.Kcols,
               750 if up else 757, ex.op.parts, ex.op.kc, ex.op.band)
    elif label == "direct":
        ex = ConvExec(make_plan(44100, 96000, 2.0, 180.15, 0).stages[0], f32,
                      "fast", engine="direct").to(dev)
        geo = (ex.spec.down, ex.D_direct, ex.spec.up, 44106, ex.op.parts,
               ex.op.kc, ex.op.band)
    else:
        raise ValueError(f"unknown call {label!r}")
    I, D, O, n_win, parts, kc, band = geo
    xp = torch.rand((channels, (n_win - 1) * I + D), generator=g,
                    device=dev) * 2 - 1
    return xp, parts, I, D, O, n_win, kc, band


def folds(parts, D: int, kc: int, band):
    """(folds a row tile walks with ``band``, and over all of D)."""
    return band.folds[kc], parts.shape[0] * -(-D // kc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=LABELS, default=LABELS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_frac_band: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms
    from r8brain_torch.ops.pallas_frac import frac_whole

    dev = torch.device("cuda", 0)
    bad = 0
    for label in args.only:
        xp, parts, I, D, O, n_win, kc, band = call(label, dev)
        full = full_band(parts, D)
        run = {name: (lambda b=b: frac_whole(xp, parts, I, D, O, n_win,
                                             kc=kc, band=b))
               for name, b in (("band", band), ("full", full))}
        y, y_full = run["band"](), run["full"]()
        same = torch.equal(y.view(torch.int32), y_full.view(torch.int32))
        bad += not same
        ms = {"full": [], "band": []}
        for name in ("full", "band", "band", "full"):
            ms[name].append(cuda_ms(run[name], reps=args.reps))
        walked, all_d = folds(parts, D, kc, band)
        t_b, t_f = (sum(ms[k]) / 2 for k in ("band", "full"))
        turns = ", ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in v)
                          for k, v in ms.items())
        print(f"{label} I={I} D={D} O={O} C={xp.shape[0]} n_win={n_win} "
              f"fold {kc} P={parts.shape[2] - (parts.shape[3] == 8)}: "
              f"folds a row tile {walked} / {all_d} "
              f"({walked / all_d:.4f}); y "
              f"{'bit-equal to' if same else 'DIFFERS from'} the full walk; "
              f"band {t_b:.3f} ms, full {t_f:.3f} ms ({t_b / t_f:.4f}; "
              f"{turns})")
        del xp, y, y_full
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
