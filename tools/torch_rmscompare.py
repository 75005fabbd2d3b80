#!/usr/bin/env python3
"""Per-channel RMS of the difference of two WAV files, on the port's reader.

    python tools/torch_rmscompare.py a.wav b.wav [--skip-ms 50]
        [--thresh -141] [--device cuda|cpu]

tools/rmscompare.py through ``r8brain_torch.io.read_wav``, with the same
output and verdict (bench/rmscompare.cpp:16-141): the lengths aligned,
``--skip-ms`` skipped at each end (edge transients), each channel's RMS
difference in dB re full scale printed, and the verdict against the
24-bit golden-equality threshold of -141 dB (bench/README.md:9-11).
The files are read on the host and each difference is reduced in
float64 on ``--device`` (``cuda`` by default, which raises without CUDA;
``cpu`` for the plain path).  Exits 0 when the worst channel is at or
below the threshold, 1 when it is above, 2 when the files cannot be
compared.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file_a")
    ap.add_argument("file_b")
    ap.add_argument("--skip-ms", type=float, default=50.0)
    ap.add_argument("--thresh", type=float, default=-141.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch.io import read_wav
    from r8brain_torch.models.resampler import resolve_device

    dev = resolve_device(args.device)

    a = read_wav(args.file_a)
    b = read_wav(args.file_b)
    if a.rate != b.rate:
        print(f"sample-rate mismatch: {a.rate} vs {b.rate}", file=sys.stderr)
        return 2
    if a.channels != b.channels:
        print(f"channel mismatch: {a.channels} vs {b.channels}",
              file=sys.stderr)
        return 2
    n = min(a.frames, b.frames)
    skip = int(a.rate * args.skip_ms / 1000.0)
    if n - 2 * skip <= 0:
        print("files too short for the edge skip", file=sys.stderr)
        return 2
    sl = slice(skip, n - skip)
    worst = -1e30
    da = torch.from_numpy(np.ascontiguousarray(a.data[:, sl])).to(
        dev, torch.float64)
    db = torch.from_numpy(np.ascontiguousarray(b.data[:, sl])).to(
        dev, torch.float64)
    ms = (da - db).square().mean(dim=1).cpu().numpy()
    for c in range(a.channels):
        rms = 10.0 * np.log10(ms[c] + 1e-300)
        worst = max(worst, rms)
        print(f"channel {c}: RMS diff {rms:.2f} dB")
    verdict = "EQUAL" if worst <= args.thresh else "DIFFERENT"
    print(f"{verdict} (worst {worst:.2f} dB, threshold {args.thresh:g} dB)")
    return 0 if worst <= args.thresh else 1


if __name__ == "__main__":
    sys.exit(main())
