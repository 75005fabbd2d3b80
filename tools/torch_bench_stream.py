#!/usr/bin/env python3
"""Streaming (serving) throughput of the r8brain_torch port:
tools/bench_stream.py's JSON record.

    python tools/torch_bench_stream.py [--device cuda|cpu]

Drives a ``StreamResampler`` over ``Resampler(src, dst, 2.0, atten)`` on
``R8B_SBENCH_CHANNELS`` channels of ``standard_normal * 0.5`` blocks
(seed 0) and times its steady, device-resident blocks: rational plans
one block a call (``process_block_device``), polynomial plans
``R8B_SBENCH_KBATCH`` blocks a call (``process_blocks_device``; one block
at a time with a k-batch of 1).  After six warm-up calls
``R8B_SBENCH_BLOCKS`` calls are timed, with CUDA events on ``cuda`` (the
default; it raises without CUDA) and the host clock on ``--device cpu``
(for the smoke test, tests/test_torch_bench.py; no number of it is a
device figure).  Prints tools/bench_stream.py's record (:87-100 for
polynomial plans, :134-141 for rational ones) and ``device``.

Knobs: R8B_SBENCH_CHANNELS (1024), R8B_SBENCH_BLOCK (8192),
R8B_SBENCH_BLOCKS (24), R8B_SBENCH_SRC (44100), R8B_SBENCH_DST (96000),
R8B_SBENCH_ATTEN (180.15), R8B_SBENCH_PRECISION (fast),
R8B_SBENCH_KBATCH (8).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BASELINE_MROPS = 38.0  # the C++ library's 44.1k -> 96k rate on one core
WARMUP_CALLS = 6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    env = os.environ.get
    C = int(env("R8B_SBENCH_CHANNELS", "1024"))
    block = int(env("R8B_SBENCH_BLOCK", "8192"))
    nblk = max(1, int(env("R8B_SBENCH_BLOCKS", "24")))
    src = float(env("R8B_SBENCH_SRC", "44100"))
    dst = float(env("R8B_SBENCH_DST", "96000"))
    atten = float(env("R8B_SBENCH_ATTEN", "180.15"))
    precision = env("R8B_SBENCH_PRECISION", "fast")

    import numpy as np
    import torch

    from r8brain_torch import Resampler, StreamResampler

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("torch_bench_stream: CUDA is not available "
                           "(--device cpu runs the plain versions, for the "
                           "smoke test only)")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    rs = Resampler(src, dst, 2.0, atten, 0, precision=precision,
                   device=args.device)
    st = StreamResampler(rs, block_len=block)
    poly = st._mode == "poly"
    kb = max(1, int(env("R8B_SBENCH_KBATCH", "8"))) if poly else 1
    L = st.block
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((C, L * kb)) * 0.5).to(
        device=rs.device, dtype=torch.float32)

    def call():
        return (st.process_blocks_device(xb) if kb > 1
                else st.process_block_device(xb))

    with torch.no_grad():
        for _ in range(WARMUP_CALLS):
            call()
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            for _ in range(nblk):
                y = call()
            e1.record()
            torch.cuda.synchronize()
            dt = e0.elapsed_time(e1) * 1e-3 / nblk
        else:
            t0 = time.perf_counter()
            for _ in range(nblk):
                y = call()
            dt = (time.perf_counter() - t0) / nblk
        assert bool(torch.isfinite(y).all())
    n_per_call = L * kb
    mrops = 1e-6 * C * n_per_call / dt
    streams = C * (n_per_call / src) / dt
    if poly:
        rec = {"metric": f"stream_{int(src)}_to_{int(dst)}"
                         "_steady_throughput",
               "value": round(mrops, 1), "unit": "Mrops",
               "vs_baseline": round(mrops / BASELINE_MROPS, 2),
               "block_len": L, "k_batch": kb,
               "mode": "poly_device_resident",
               "realtime": bool(dt < n_per_call / src),
               "realtime_streams_per_chip": int(streams)}
    else:
        rec = {"metric": "stream_44k_to_96k_steady_throughput"
                         if (src, dst) == (44100.0, 96000.0) else
                         f"stream_{int(src)}_to_{int(dst)}"
                         "_steady_throughput",
               "value": round(mrops, 1), "unit": "Mrops",
               "vs_baseline": round(mrops / BASELINE_MROPS, 2),
               "block_len": L,
               "realtime_streams_per_chip": int(streams)}
    rec["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
