#!/usr/bin/env python3
"""Accuracy audit of the port's float32 engines on the card against the
float64 oracle.

    python tools/torch_chip_accuracy.py [--channels 4] [--seconds 0.5]
        [--src 44100] [--dst 96000] [--atten 180.15] [--tb 2]
        [--phase 0] [--configs fast,high,hp_dfft_pallas,...]
        [--device cuda|cpu]

tools/chip_accuracy.py on the port: ``--channels`` rows of
``standard_normal * 0.5`` (seed 7), ``--seconds`` of ``--src``, through
each configuration of ``CONFIGS`` (the reference's labels, each mapped to
the port's options; every label runs the port's own kernels) on
``--device`` (``cuda`` by default, which raises without CUDA), held
against the port's ``OracleResampler`` (float64, host): the RMS of the
difference in dB re full scale past 50 ms at each edge (at most a quarter
of the output), one line per configuration, then one JSON line
``{"metric": "chip_accuracy_db", ..., "results": {label: dB}}``.  A
configuration that raises is printed and reported as ``"ERROR: ..."``,
and the tool then exits 1.  The port compiles nothing at run time but its
kernels, so there is no compilation cache to set up.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONFIGS = {
    # label: (precision, fused, conv_engine, frac_engine)
    "fast": ("fast", "auto", "auto", "auto"),
    "high": ("high", "auto", "auto", "auto"),
    "high_toeplitz": ("high", False, "toeplitz", "auto"),
    "hp_dfft": ("high", False, "fft", "auto"),
    "hp_dfft_pallas": ("high", False, "pallas_fft", "auto"),
    "hp_dfft_pallas4": ("high", False, "pallas_fft4", "auto"),
    "hp_dfft_pallas5": ("high", False, "pallas_fft5", "auto"),
    "fast_pallas_fused": ("fast", True, "pallas", "auto"),
    "high_pallas_fused": ("high", True, "pallas", "auto"),
    # the error-free split-operand guarantee engine (ops/ozaki.py)
    "ozaki": ("high", False, "ozaki", "ozaki"),
}


# the class each configuration is held to, dB re full scale (PERF.md
# section 2): the C++ library's golden class; the float32 stage chain
# under "high" at -143; the guarantee chain, with the df32 carry on, at
# -150
CLASS_DB = {label: -141.0 for label in CONFIGS}
CLASS_DB.update(high_toeplitz=-143.0, ozaki=-150.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--src", type=float, default=44100)
    ap.add_argument("--dst", type=float, default=96000)
    ap.add_argument("--atten", type=float, default=180.15)
    ap.add_argument("--tb", type=float, default=2.0)
    ap.add_argument("--phase", type=int, default=0,
                    help="0=linear, 1=minimum phase")
    ap.add_argument("--configs", default="fast,high,hp_dfft_pallas")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def audit(args, dev, log=print):
    """{label: dB re full scale, or "ERROR: ..."} of each of
    ``args.configs`` on ``dev`` against the float64 oracle; each line
    through ``log``."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.models.oracle import OracleResampler

    n = int(args.src * args.seconds)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((args.channels, n)) * 0.5
    orc = OracleResampler(args.src, args.dst, 4096, args.tb, args.atten,
                          args.phase)
    out_len = int(np.floor(n * args.dst / args.src))
    ref = np.stack([orc.oneshot(c, out_len) for c in x])
    # rmscompare convention: skip 50 ms at each end
    # (bench/rmscompare.cpp:72-86), capped at a quarter of the output so
    # short high-rate signals still measure their middle half
    skip = min(int(0.05 * args.dst), out_len // 4)
    xd = torch.from_numpy(x.astype(np.float32)).to(dev)

    results = {}
    for label in args.configs.split(","):
        precision, fused, conv_engine, frac_engine = CONFIGS[label]
        t0 = time.time()
        try:
            rs = Resampler(args.src, args.dst, args.tb, args.atten,
                           args.phase, dtype=torch.float32,
                           precision=precision, fused=fused,
                           conv_engine=conv_engine, frac_engine=frac_engine,
                           plan=orc.plan, device=dev)
            y = rs.oneshot(xd, out_len).cpu().double().numpy()
        except Exception as e:
            results[label] = f"ERROR: {type(e).__name__}"
            log(f"{label:20s} FAILED: {repr(e)[:300]}")
            continue
        d = (y - ref)[:, skip : max(skip + 1, out_len - skip)]
        rms = 10.0 * np.log10(np.mean(d * d) + 1e-300)
        results[label] = round(float(rms), 2)
        log(f"{label:20s} {rms:8.2f} dB vs f64 oracle "
            f"({time.time() - t0:.1f}s)")
    return results


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch.models.resampler import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bad = [c for c in args.configs.split(",") if c not in CONFIGS]
    if bad:
        ap.error(f"unknown configs {bad}; known: {', '.join(CONFIGS)}")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}", file=sys.stderr)
    results = audit(args, dev,
                    log=lambda line: print(line, file=sys.stderr))
    print(json.dumps({"metric": "chip_accuracy_db", "phase": args.phase,
                      "src": args.src, "dst": args.dst,
                      "atten": args.atten, "tb": args.tb,
                      "device": name, "results": results}))
    return 1 if any(isinstance(v, str) for v in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
