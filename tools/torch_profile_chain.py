#!/usr/bin/env python3
"""Device-time breakdown of one port chain on the card, by kernel.

    python tools/torch_profile_chain.py
        [--engine fast|high|ozaki|pallas_fft5|toeplitz|toeplitz_sym]
        [--carry 1|0]
        [--src 44100] [--dst 96000] [--stream K | --grad]

Runs ``Resampler(src, dst, 2, 180.15).oneshot`` (44.1 kHz -> 96 kHz by
default; 44.1 kHz -> 192 kHz and -> 96001 Hz are the half-band and
polynomial plans) on 1024 channels x 1 s of the source rate of
full-scale uniform float32 input (seed 0) through ``torch.profiler`` and
prints, per device kernel, its time per oneshot and share, then the sum of
kernel time against the oneshot's wall time (CUDA events), whose
difference is the device's idle share.  ``--engine high`` is the
default engines under ``precision="high"``; ``--engine ozaki`` is the
guarantee chain (``precision="high"``, ``conv_engine="ozaki"``,
``frac_engine="ozaki"``); ``--carry 0`` sets ``R8BT_DF_CARRY=0`` for it.
``--engine pallas_fft5`` is the df32-FFT guarantee chain
(``precision="high"``, ``fused=False``, ``conv_engine="pallas_fft5"``);
``--engine toeplitz`` and ``--engine toeplitz_sym`` are the float32 stage
chain (``precision="fast"``, ``fused=False``) with the banded operator on
``frac_whole`` and with the folded operators on ``sym_conv``.
``--stream K`` profiles the push-mode stream instead
(``StreamResampler(rs, 8192)``, 1024 channels): steady calls of K whole
blocks (``process_block_device`` for K = 1, else
``process_blocks_device``) after two warm-up calls, the times per block.
``--grad`` profiles the gradient of the functional transform instead:
``torch.func.grad`` of <w, f(x)> with ``f = resample_fn(rs, n)`` and a
seeded w (forward, ``frac_whole``'s adjoint or a twin's, and the
autograd steps between), the times per gradient.  The first line names
the card and its power limit.  Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CHANNELS = 1024  # the headline size, as chip_smoke.py drives it
REPS = 5         # profiled oneshots (or stream calls), after two warm-ups
STREAM_BLOCK = 8192  # the stream's block_len (tools/bench_stream.py's)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("fast", "high", "ozaki",
                                         "pallas_fft5",
                                         "toeplitz", "toeplitz_sym"),
                    default="ozaki")
    ap.add_argument("--carry", choices=("1", "0"), default="1")
    ap.add_argument("--src", type=float, default=44100)
    ap.add_argument("--dst", type=float, default=96000)
    ap.add_argument("--stream", type=int, default=0)
    ap.add_argument("--grad", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_chain: CUDA is not available", file=sys.stderr)
        return 2
    os.environ["R8BT_DF_CARRY"] = args.carry
    from r8brain_torch import Resampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kw = {"fast": {}, "high": dict(precision="high"),
          "ozaki": dict(precision="high", conv_engine="ozaki",
                        frac_engine="ozaki"),
          "pallas_fft5": dict(precision="high", fused=False,
                              conv_engine="pallas_fft5"),
          "toeplitz": dict(fused=False, conv_engine="toeplitz"),
          "toeplitz_sym": dict(fused=False,
                               conv_engine="toeplitz_sym")}[args.engine]
    rs = Resampler(args.src, args.dst, 2.0, 180.15, device=dev, **kw)
    n = int(round(args.src))
    per, unit = REPS, "oneshot"
    if args.stream:
        from r8brain_torch import StreamResampler

        st = StreamResampler(rs, STREAM_BLOCK)
        n = args.stream * st.block
        call = st.process_block_device if args.stream == 1 else \
            st.process_blocks_device
        per, unit = REPS * args.stream, f"block (k={args.stream})"
    x = torch.rand((CHANNELS, n), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 2 - 1

    if args.grad:
        from r8brain_torch import resample_fn

        f = resample_fn(rs, n)
        w = torch.rand(f(x).shape, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev) * 2 - 1
        gfun = torch.func.grad(lambda v: (w * f(v)).sum())
        unit = "gradient"

    def run():
        if args.stream:
            call(x)
        elif args.grad:
            gfun(x)
        else:
            rs.oneshot(x)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0.record()
        for _ in range(REPS):
            run()
        t1.record()
        torch.cuda.synchronize()
    wall_ms = t0.elapsed_time(t1) / per
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.self_device_time_total / 1e3 / per, e.count
                     // REPS, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    label = f"ozaki carry={args.carry}" if args.engine == "ozaki" else \
        args.engine
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0] if smi else 'not readable'}")
    print(f"{torch.cuda.get_device_name(0)}: {args.src:g} -> {args.dst:g} "
          f"chain {label}, {CHANNELS} x {n}, executors "
          f"{[type(e).__name__ for e in rs.execs]}, per {unit}:")
    for ms, cnt, key in rows:
        print(f"  {ms:9.3f} ms {100 * ms / wall_ms:5.1f} %  x{cnt:<3d} "
              f"{key[:90]}")
    print(f"kernels {busy:.3f} ms of {wall_ms:.3f} ms wall: device idle "
          f"{100 * (1 - busy / wall_ms):.1f} %")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
