#!/usr/bin/env python3
"""Time-sharding efficiency model of the r8brain_torch port, from its own
plan and sharding geometry (tools/halo_model.py's counterpart).

For each (shard count, audio duration) this prints the per-device work
inflation of ``ShardedResampler``'s time axis: every time shard processes
H + L_s + R input samples (left halo + useful segment + right halo,
``r8brain_torch/parallel/sharding.py`` ``shard_geometry``) to emit its
M_s outputs, so

    efficiency = L_s / (H + L_s + R)

the fraction of a shard's work that is useful.  The halos are fixed-size
functions of the chain's input span (``chain_input_span``), so the
efficiency tends to 1 as a shard's segment grows.  Channel sharding needs
no halos (efficiency 1 by construction).  This is arithmetic on the
geometry only: it states nothing about NCCL transfers or measured scaling
across GPUs.

Usage:
  python tools/torch_halo_model.py [--src 44100] [--dst 96000] [--tb 2]
      [--atten 180.15] [--shards 2,4,8,16,32] [--seconds 1,10,60]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from r8brain_torch.models.lengths import (  # noqa: E402
    chain_input_span, chain_shift_period)
from r8brain_torch.models.plan import make_plan  # noqa: E402
from r8brain_torch.parallel.sharding import shard_geometry  # noqa: E402


def efficiency(plan, period, span, n_t: int, n_in: int) -> dict:
    """The geometry of ``n_t`` time shards of an ``n_in``-sample input and
    the share of each shard's input that is its own segment."""
    out_len = int(n_in * plan.dst_rate / plan.src_rate)
    M_s, L_s, H, W, R = shard_geometry(plan, period, span, n_t, out_len,
                                       n_in)
    return {"n_t": n_t, "M_s": M_s, "L_s": L_s, "H": H, "W": W, "R": R,
            "efficiency": L_s / (H + L_s + R)}


def table(src: float, dst: float, tb: float, atten: float, shards,
          seconds):
    """(span, [(seconds, efficiency dict), ...]) in the order printed, or
    None for a polynomial-mode plan (no time sharding)."""
    plan = make_plan(src, dst, tb, atten, 0)
    period = chain_shift_period(plan)
    if period is None:
        return None
    span = chain_input_span(plan)
    return span, [(sec, efficiency(plan, period, span, n_t, int(sec * src)))
                  for sec in seconds for n_t in shards]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=float, default=44100.0)
    ap.add_argument("--dst", type=float, default=96000.0)
    ap.add_argument("--tb", type=float, default=2.0)
    ap.add_argument("--atten", type=float, default=180.15)
    ap.add_argument("--shards", default="2,4,8,16,32")
    ap.add_argument("--seconds", default="1,10,60")
    args = ap.parse_args(argv)

    t = table(args.src, args.dst, args.tb, args.atten,
              [int(s) for s in args.shards.split(",")],
              [float(s) for s in args.seconds.split(",")])
    if t is None:
        print("polynomial-mode plan: time sharding unavailable "
              "(channel sharding only, efficiency 1.0)")
        return 0
    span, rows = t
    print(f"# {args.src:g} -> {args.dst:g}  atten {args.atten:g}  "
          f"input span {span} (halo H+R below)")
    print(f"{'seconds':>8} {'shards':>7} {'H':>7} {'R':>7} {'L_s':>9} "
          f"{'efficiency':>11}")
    for sec, e in rows:
        print(f"{sec:8g} {e['n_t']:7d} {e['H']:7d} {e['R']:7d} "
              f"{e['L_s']:9d} {e['efficiency']:10.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
