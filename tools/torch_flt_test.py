#!/usr/bin/env python3
"""Fractional-interpolator SNR on the port (other/flttest.cpp:13-177).

    python tools/torch_flt_test.py [--attens 110,140,170,200]
        [--freq 9000] [--device cuda|cpu]

tools/flt_test.py on the port: the polynomial-mode fractional-delay bank
of 88.2 kHz -> 96001 Hz (``models/plan.py`` ``_make_frac``), run alone
by the port's ``FracPolyExec`` in float64 on ``--device`` (``cuda`` by
default, which raises without CUDA) over 30000 samples of a sine, each
output compared with the exact value at its read position
(``models/lengths.py`` ``frac_positions``: the positions do not depend
on the data, so the ideal output is sin(2 pi f p_n / src)).  The bank's
interpolation SNR must exceed atten - 10 dB at each ``--attens`` value.
``main`` returns 1 when one does not and leaves the rows in ``last``.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the last run's rows: [(atten, taps, fracs, SNR dB)]
last = []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--attens", default="110,140,170,200")
    ap.add_argument("--freq", type=float, default=9000.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch.models.lengths import frac_positions
    from r8brain_torch.models.plan import _make_frac
    from r8brain_torch.models.resampler import resolve_device
    from r8brain_torch.ops.stages import FracPolyExec

    dev = resolve_device(args.device)
    src, dst = 88200.0, 96001.0  # poly mode (irrational-equivalent ratio)
    n = 30000
    t = np.arange(n) / src
    x = torch.from_numpy(np.sin(2 * np.pi * args.freq * t))[None].to(dev)

    last.clear()
    print(f"{'atten':>7} {'taps':>5} {'fracs':>6} {'SNR dB':>8}")
    ok = True
    for a in (float(v) for v in args.attens.split(",")):
        spec = _make_frac(src, dst, a, False, 0.0)
        ex = FracPolyExec(spec, torch.float64).to(dev)
        y = ex.apply(x)[0].cpu().numpy()
        M = y.shape[0]
        s, f = frac_positions(spec, 0, M)
        ideal = np.sin(2 * np.pi * args.freq * (s + f) / src)
        sl = slice(100, M - 100)
        err = y[sl] - ideal[sl]
        snr = 10 * np.log10(np.mean(ideal[sl] ** 2)
                            / (np.mean(err ** 2) + 1e-300))
        last.append((a, spec.filter_len, spec.bank.fracs, snr))
        print(f"{a:7.1f} {spec.filter_len:5d} {spec.bank.fracs:6d} "
              f"{snr:8.2f}")
        # flttest guidance: achieved SNR tracks the requested atten
        ok = ok and snr > a - 10.0
    print(f"{'PASS' if ok else 'FAIL'} ({dev.type})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
