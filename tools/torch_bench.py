#!/usr/bin/env python3
"""Oneshot throughput of the r8brain_torch port: bench.py's JSON record.

    python tools/torch_bench.py [--device cuda|cpu]

Runs the port's stage chain (``Resampler.forward``, the body of
``oneshot``) on ``R8B_BENCH_CHANNELS`` x ``R8B_BENCH_SECONDS`` of
``standard_normal * 0.5`` input from seed 0, bench.py's input, and prints
bench.py's one-line record (bench.py:194-216): ``metric``, ``value``
(Mrops = 1e-6 x channels x input samples / s, against the C++ library's
38 Mrops a core in ``vs_baseline``), ``exec_value``, ``exec_vs_baseline``
and, off the headline 44.1k -> 96k, ``ratio`` and
``exec_out_msamples_s``; and ``device``, the card's name.

On ``cuda`` (the default; it raises without CUDA) ``value`` is the host
clock around ``R8B_BENCH_ITERS`` back-to-back calls ended by a
synchronize (what a caller waits), best of ``R8B_BENCH_REPEATS``, and
``exec_value`` the device time a call from CUDA events around
``3 * R8B_BENCH_ITERS`` back-to-back calls.  ``--device cpu`` exists for
the smoke test (tests/test_torch_bench.py): the host clock for both, and
no number of it is a device figure.

Knobs (bench.py's): R8B_BENCH_CHANNELS (1024), R8B_BENCH_SECONDS (1.0),
R8B_BENCH_ITERS (10), R8B_BENCH_REPEATS (3), R8B_BENCH_DTYPE (float32),
R8B_BENCH_PRECISION (fast), R8B_BENCH_SRC (44100), R8B_BENCH_DST (96000),
R8B_BENCH_ATTEN (180.15), R8B_BENCH_TB (2.0), R8B_BENCH_ENGINE (auto),
R8B_BENCH_FRAC_ENGINE (ozaki when the engine is, else auto),
R8B_BENCH_FUSED (auto, 1, 0), R8B_BENCH_METRIC, R8B_BENCH_PROFILE (a
directory: ``torch.profiler`` traces two more calls into
``<metric>.pt.trace.json`` there, a Chrome trace, after the timing).
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


def rate_tag(r: float) -> str:
    if abs(r - round(r)) < 1e-9:
        return str(int(round(r)))
    return f"{r:g}".replace(".", "p").replace("+", "").replace("-", "m")


def metric_name(src, dst, atten, precision) -> str:
    """bench.py's metric name for a configuration."""
    cfg = ("44k_to_96k" if (src, dst) == (44100.0, 96000.0)
           else f"{rate_tag(src)}_to_{rate_tag(dst)}")
    tag = {136.45: "16bit", 109.56: "16bitIR", 180.15: "24bit",
           206.91: "default"}.get(atten) or f"a{rate_tag(atten)}"
    hp = "_hp" if precision != "fast" else ""
    return f"resample_{cfg}_{tag}{hp}_throughput"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    env = os.environ.get
    channels = int(env("R8B_BENCH_CHANNELS", "1024"))
    seconds = float(env("R8B_BENCH_SECONDS", "1.0"))
    iters = max(1, int(env("R8B_BENCH_ITERS", "10")))
    repeats = max(1, int(env("R8B_BENCH_REPEATS", "3")))
    dtype = env("R8B_BENCH_DTYPE", "float32")
    precision = env("R8B_BENCH_PRECISION", "fast")
    src = float(env("R8B_BENCH_SRC", "44100"))
    dst = float(env("R8B_BENCH_DST", "96000"))
    atten = float(env("R8B_BENCH_ATTEN", "180.15"))
    tb = float(env("R8B_BENCH_TB", "2.0"))
    engine = env("R8B_BENCH_ENGINE", "auto")
    frac_engine = env("R8B_BENCH_FRAC_ENGINE",
                      "ozaki" if engine == "ozaki" else "auto")
    fused = {"auto": "auto", "1": True, "0": False}[
        env("R8B_BENCH_FUSED", "auto")]

    import numpy as np
    import torch

    from r8brain_torch import Resampler

    metric = env("R8B_BENCH_METRIC") or metric_name(src, dst, atten,
                                                     precision)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("torch_bench: CUDA is not available (--device "
                           "cpu runs the plain versions, for the smoke "
                           "test only)")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n_in = int(src * seconds)
    rs = Resampler(src, dst, tb, atten, 0, dtype=getattr(torch, dtype),
                   precision=precision, fused=fused, conv_engine=engine,
                   frac_engine=frac_engine, device=args.device)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((channels, n_in)) * 0.5).to(
        device=rs.device, dtype=rs.dtype)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with torch.no_grad():
        rs(x0)  # builds and warms up
        sync()
        wall = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                y = rs(x0)
            sync()
            wall = min(wall, (time.perf_counter() - t0) / iters)
        assert bool(torch.isfinite(y).all())
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(3 * iters):
                rs(x0)
            e1.record()
            torch.cuda.synchronize()
            dev_s = e0.elapsed_time(e1) * 1e-3 / (3 * iters)
        else:
            dev_s = wall
        prof_dir = env("R8B_BENCH_PROFILE")
        if prof_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                for _ in range(2):
                    rs(x0)
                sync()
            os.makedirs(prof_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(prof_dir,
                                                  f"{metric}.pt.trace.json"))
    mrops = 1e-6 * channels * n_in / wall
    exec_mrops = 1e-6 * channels * n_in / dev_s
    rec = {"metric": metric,
           "value": round(mrops, 1), "unit": "Mrops",
           "vs_baseline": round(mrops / BASELINE_MROPS, 2),
           "exec_value": round(exec_mrops, 1),
           "exec_vs_baseline": round(exec_mrops / BASELINE_MROPS, 2)}
    if (src, dst) != (44100.0, 96000.0):
        rec["ratio"] = round(dst / src, 6)
        rec["exec_out_msamples_s"] = round(
            1e-6 * channels * rs.out_len_for_in(n_in) / dev_s, 1)
    rec["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
