#!/usr/bin/env python3
"""SNR-against-attenuation sweep on the port (bench/snrtest.cpp:35-112).

    python tools/torch_snrtest.py [--impl oracle|f32] [--device cuda|cpu]
        [--step 6] [--ratios 8] [--n 9000]

tools/snrtest.py on the port: for each requested attenuation from 49 to
218 dB in ``--step`` steps, ``--ratios`` white-noise round trips at random
ratios k/20 (k and the transition band from ``default_rng(5)``), the
band-limited SNR of each round trip measured against its input.  The
achieved SNR must track the request: the minimum at each step must reach
min(atten - 15, 130) dB for ``--impl f32`` (the port's float32 ``"fast"``
``Resampler`` on ``--device``, ``cuda`` by default, which raises without
CUDA) and min(atten - 15, 185) dB for ``--impl oracle`` (the port's
float64 ``OracleResampler`` on the host), the reference's floors.  Each
step's average and minimum SNR are printed; ``main`` returns 1 when a
step misses its floor and leaves the steps in ``last``.
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

#: each implementation's floor: the f32 cap was set at XLA:CPU's
#: arithmetic floor in the reference, the oracle's at its f64 round trip
CAPS = {"f32": 130.0, "oracle": 185.0}
#: the last sweep's steps: [(atten, avg SNR, min SNR, floor)]
last = []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("oracle", "f32"), default="oracle")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--step", type=float, default=6.0)
    ap.add_argument("--ratios", type=int, default=8)
    ap.add_argument("--n", type=int, default=9000)
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.models.oracle import OracleResampler
    from r8brain_torch.models.resampler import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def convert(src, dst, tb, atten, x, out_len):
        if args.impl == "f32":
            rs = Resampler(src, dst, tb, atten, 0, dtype=torch.float32,
                           device=dev)
            return rs.oneshot(torch.from_numpy(x.astype(np.float32))[None],
                              out_len)[0].cpu().double().numpy()
        return OracleResampler(src, dst, 2048, tb, atten, 0).oneshot(
            x, out_len)

    rng = np.random.default_rng(5)
    t0 = time.time()
    last.clear()
    print(f"{'atten':>7} {'avg SNR':>9} {'min SNR':>9} {'floor':>7}")
    ok = True
    atten = 49.0
    while atten <= 218.0:
        snrs = []
        for _ in range(args.ratios):
            k = int(rng.integers(21, 641))
            src = 44100.0
            dst = src * k / 20.0
            tb = 0.5 + 4.5 * rng.random()
            x = lcg_uniform(k, args.n)
            mid = convert(src, dst, tb, atten, x,
                          int(np.floor(args.n * dst / src)))
            y = convert(dst, src, tb, atten, mid, args.n)
            snrs.append(-band_limited_rms_db(y, x))
        avg, mn = float(np.mean(snrs)), float(np.min(snrs))
        floor = min(atten - 15.0, CAPS[args.impl])
        last.append((atten, avg, mn, floor))
        print(f"{atten:7.1f} {avg:9.2f} {mn:9.2f} {floor:7.1f}")
        ok = ok and mn >= floor
        atten += args.step
    where = "host" if args.impl == "oracle" else dev.type
    print(f"\n{'PASS' if ok else 'FAIL'} ({args.impl}, {where}, "
          f"{time.time() - t0:.0f}s; achieved SNR tracks ReqAtten; "
          f"reference guidance: request +9 dB for a guarantee, "
          f"bench/snrtest.cpp:4-6)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
