#!/usr/bin/env python3
"""Device-time breakdown of one port chain on the card, by kernel.

    python tools/torch_profile_chain.py [--engine fast|ozaki] [--carry 1|0]

Runs ``Resampler(44100, 96000, 2, 180.15).oneshot`` on 1024 x 44100
full-scale uniform float32 input (seed 0) through ``torch.profiler`` and
prints, per device kernel, its time per oneshot and share, then the sum of
kernel time against the oneshot's wall time (CUDA events), whose
difference is the device's idle share.  ``--engine ozaki`` is the
guarantee chain (``precision="high"``, ``conv_engine="ozaki"``,
``frac_engine="ozaki"``); ``--carry 0`` sets ``R8BT_DF_CARRY=0`` for it.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CHANNELS = 1024  # the headline size, as chip_smoke.py drives it
REPS = 5         # profiled oneshots, after two warm-up calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("fast", "ozaki"), default="ozaki")
    ap.add_argument("--carry", choices=("1", "0"), default="1")
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
    kw = {} if args.engine == "fast" else dict(
        precision="high", conv_engine="ozaki", frac_engine="ozaki")
    rs = Resampler(44100, 96000, 2.0, 180.15, device=dev, **kw)
    x = torch.rand((CHANNELS, 44100), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 2 - 1
    for _ in range(2):
        rs.oneshot(x)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0.record()
        for _ in range(REPS):
            rs.oneshot(x)
        t1.record()
        torch.cuda.synchronize()
    wall_ms = t0.elapsed_time(t1) / REPS
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.self_device_time_total / 1e3 / REPS, e.count
                     // REPS, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    label = args.engine if args.engine == "fast" else \
        f"ozaki carry={args.carry}"
    print(f"{torch.cuda.get_device_name(0)}: chain {label}, "
          f"{CHANNELS} x 44100, per oneshot:")
    for ms, n, key in rows:
        print(f"  {ms:9.3f} ms {100 * ms / wall_ms:5.1f} %  x{n:<3d} "
              f"{key[:90]}")
    print(f"kernels {busy:.3f} ms of {wall_ms:.3f} ms wall: device idle "
          f"{100 * (1 - busy / wall_ms):.1f} %")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
