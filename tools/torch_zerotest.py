#!/usr/bin/env python3
"""Round-trip zeroing sweep on the port (bench/zerotest.cpp:34-169).

    python tools/torch_zerotest.py [--quick] [--atten 160] [--n 12000]
        [--random N] [--impl oracle|f32] [--device cuda|cpu]

tools/zerotest.py on the port: the reference's 620 integer ratios k/20
for k = 21..640 (``--quick``: every 10th, 62 ratios) with a random
transition band from ``default_rng(1)``, each resampled up and back down
and the band-limited RMS difference against the input measured
(insensitive to transition-band loss, zerotest.cpp:62-84); the threshold
is -(atten - 25) dB.  ``--random N`` replaces the integer sweep with N
non-integer ratios of masstest's distribution (1 + 44 * rand, always up
then down), which land in the polynomial interpolator.

``--impl oracle`` runs the port's ``OracleResampler`` (float64, host)
and checks the closed-form latency query against streaming emission at
every ratio (zerotest.cpp:115-128); ``--impl f32`` runs the port's
``Resampler`` in float32 ``"fast"`` on ``--device`` (``cuda`` by
default, which raises without CUDA).  ``main`` returns 1 when any ratio
misses the threshold and also returns the sweep's worst through
``last``.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from helpers import band_limited_rms_db, lcg_uniform  # noqa: E402

#: the last sweep's (ratios, worst dB, its k, failures, seconds)
last = {}


def cases(quick: bool, random: int):
    """(k, src, dst) of the sweep, and the generator the transition bands
    are then drawn from (zerotest.py's order: the random ratios first)."""
    rng = np.random.default_rng(1)
    if random:
        return [(i, 44100.0, 44100.0 * (1.0 + 44.0 * rng.random()))
                for i in range(random)], rng
    return [(k, 44100.0, 44100.0 * k / 20.0)
            for k in range(21, 641, 10 if quick else 1)], rng


def round_trip(impl: str, src, dst, tb, atten, x, device):
    """x up to dst and back to src through ``impl``: (y, the oracle's
    latency-query check (need, got) or None)."""
    import torch

    n = x.shape[0]
    mid_len = int(np.floor(n * dst / src))
    if impl == "f32":
        from r8brain_torch import Resampler

        up = Resampler(src, dst, tb, atten, 0, dtype=torch.float32,
                       device=device)
        dn = Resampler(dst, src, tb, atten, 0, dtype=torch.float32,
                       device=device)
        mid = up.oneshot(torch.from_numpy(x.astype(np.float32))[None],
                         mid_len)
        y = dn.oneshot(mid, n)
        return y[0].cpu().double().numpy(), None
    from r8brain_torch.models.oracle import OracleResampler

    up = OracleResampler(src, dst, 2048, tb, atten, 0)
    dn = OracleResampler(dst, src, 2048, tb, atten, 0)
    need = up.get_input_required_for_output(100)
    up.clear()
    got = up.process(x[:need]).shape[0]
    up.clear()
    mid = up.oneshot(x, mid_len)
    return dn.oneshot(mid, n), (need, got)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="every 10th ratio only")
    ap.add_argument("--atten", type=float, default=160.0)
    ap.add_argument("--n", type=int, default=12000)
    ap.add_argument("--impl", choices=("oracle", "f32"), default="oracle",
                    help="oracle: the float64 host executor; f32: the "
                         "port's float32 chain on --device")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--random", type=int, default=0, metavar="N",
                    help="N randomized non-integer ratios instead of the "
                         "620-integer sweep (masstest distribution)")
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch.models.resampler import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweep, rng = cases(args.quick, args.random)
    thresh = -(args.atten - 25.0)
    worst, worst_k, fails = -1e30, None, 0
    t0 = time.time()
    for k, src, dst in sweep:
        tb = 0.5 + 4.5 * rng.random()
        x = lcg_uniform(k, args.n)
        y, lat = round_trip(args.impl, src, dst, tb, args.atten, x, dev)
        if lat is not None:
            assert lat[1] >= 100, (k, *lat)
        d = band_limited_rms_db(y, x)
        if d > worst:
            worst, worst_k = d, k
        if d > thresh:
            fails += 1
            print(f"  FAIL k={k} tb={tb:.2f}: {d:.1f} dB")
    dt = time.time() - t0
    last.update(ratios=len(sweep), worst=worst, worst_k=worst_k,
                fails=fails, seconds=dt)
    where = "host" if args.impl == "oracle" else dev.type
    print(f"{len(sweep)} ratios ({args.impl}, {where}) in {dt:.0f}s; worst "
          f"{worst:.1f} dB at k={worst_k} (threshold {thresh:.0f} dB); "
          f"{fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
