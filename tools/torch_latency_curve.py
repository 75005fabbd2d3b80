#!/usr/bin/env python3
"""Serving latency curve of the port: steady ms a block of the
device-resident stream against the block length.

    python tools/torch_latency_curve.py [--device cuda|cpu]

tools/latency_curve.py on the port.  Throughput alone
(tools/torch_bench_stream.py) does not certify real-time serving: a block
must also finish before the next one arrives.  For each requested block
length a ``StreamResampler`` over ``Resampler(src, dst, 2.0, atten)``
(float32) is fed whole blocks of ``standard_normal * 0.5`` (seed 0)
through ``process_block_device``: rational plans run their periodic
block chain, polynomial plans also build the interpolator's operators
from host positions each block (``measure`` and ``measure_poly`` of the
reference share this one call here).  After ``WARMUP`` calls, ``TRIES``
runs of ``iters`` back-to-back calls are timed and the least is kept (the
reference's min discipline), with CUDA events on ``cuda`` (the default;
it raises without CUDA) and the host clock on ``--device cpu`` (for the
smoke test; no number of it is a device figure).  Block lengths that
quantize to the same stream block are measured once.

Prints one JSON line:
  {"metric": "stream_latency_curve", "channels": C, "points": [
     {"requested": l, "block_len": L, "ms_per_block": t, "block_ms": d,
      "realtime": t < d, "streams_per_chip": N}, ...], ...}

Env knobs: R8B_LBENCH_CHANNELS (1024), R8B_LBENCH_BLOCKS (csv of
requested block lengths, default "256,1024,4096,8192"),
R8B_LBENCH_SRC/DST/ATTEN/PRECISION, R8B_LBENCH_ITERS (16).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WARMUP = 10
TRIES = 3  # timed runs a point, the least kept


def measure(st, C: int, iters: int) -> float:
    """Steady ms a block of st.process_block_device on C channels: the
    least of TRIES timed runs of ``iters`` calls (a stall of the host or a
    clock ramp in one run cannot shrink it)."""
    import numpy as np
    import torch

    L = st.block
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((C, L)) * 0.5).astype(
        np.float32)).to(st.device)
    for _ in range(WARMUP):  # history filled, every shape built
        st.process_block_device(x)
    cuda = st.device.type == "cuda"
    runs = []
    for _ in range(TRIES):
        if cuda:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                y = st.process_block_device(x)
            t1.record()
            torch.cuda.synchronize()
            runs.append(t0.elapsed_time(t1) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                y = st.process_block_device(x)
            runs.append((time.perf_counter() - t0) * 1e3 / iters)
    assert bool(torch.isfinite(y).all()), "non-finite stream output"
    return min(runs)


def curve(src: float, dst: float, atten: float, precision: str, C: int,
          blocks, iters: int, device="cuda"):
    """The points of the curve (see the module docstring) and the stream
    mode ("period" or "poly")."""
    import torch

    from r8brain_torch import Resampler, StreamResampler

    rs = Resampler(src, dst, 2.0, atten, 0, dtype=torch.float32,
                   precision=precision, device=device)
    points, seen, mode = [], set(), None
    for blk in blocks:
        st = StreamResampler(rs, block_len=blk)
        mode = st._mode
        if st.block in seen:  # block geometry quantizes: skip duplicates
            continue
        seen.add(st.block)
        ms = measure(st, C, iters)
        L = st.block
        block_ms = 1e3 * L / src
        points.append({
            "requested": blk, "block_len": L, "ms_per_block": ms,
            "block_ms": block_ms, "realtime": bool(ms < block_ms),
            # C channels in this many ms of audio -> streams at 1x
            "streams_per_chip": int(C * block_ms / ms)})
        del st
    return points, mode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    env = os.environ.get
    C = int(env("R8B_LBENCH_CHANNELS", "1024"))
    blocks = [int(b) for b in env("R8B_LBENCH_BLOCKS",
                                  "256,1024,4096,8192").split(",")]
    iters = int(env("R8B_LBENCH_ITERS", "16"))
    src = float(env("R8B_LBENCH_SRC", "44100"))
    dst = float(env("R8B_LBENCH_DST", "96000"))
    atten = float(env("R8B_LBENCH_ATTEN", "180.15"))
    precision = env("R8B_LBENCH_PRECISION", "fast")

    import torch

    from r8brain_torch.models.resampler import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    points, mode = curve(src, dst, atten, precision, C, blocks, iters, dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    for p in points:
        print(f"block {p['block_len']:6d}: {p['ms_per_block']:8.3f} ms/block "
              f"vs {p['block_ms']:8.3f} ms audio -> "
              f"{'REALTIME' if p['realtime'] else 'too slow'} "
              f"({p['streams_per_chip']} streams/chip)", file=sys.stderr)
    print(json.dumps({
        "metric": "stream_latency_curve", "channels": C, "src": src,
        "dst": dst, "precision": precision, "mode": mode, "device": name,
        "points": points}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
