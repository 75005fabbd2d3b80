#!/usr/bin/env python3
"""The low-pass design's closed-form fits over the (transition band,
attenuation) grid, on the r8brain_torch port (tools/calc_error_table.py's
counterpart; other/calcErrorTable.cpp:21-135).

For each (tb, atten) the port's ``build_lp_filter`` designs a filter;
``response_mag`` measures its realised stop-band attenuation and its
-3 dB point; the worst deviations are printed.  The reference documents
an attenuation error of about 0 and a -3 dB point at about -3.01 dB
(other/calcErrorTable.cpp:5-12).  Host only (numpy).

Usage: python tools/torch_calc_error_table.py [--tb-steps 8]
           [--atten-steps 8]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def error_rows(tbs, attens, design=None):
    """[(tb %, requested atten, realised - requested dB, -3 dB point's
    deviation as a share of the cutoff)] for every tb of ``tbs`` and atten
    of ``attens``.  ``design``: the (build_lp_filter, response_mag) pair
    measured, default the port's."""
    from r8brain_torch.design.lpfilter import build_lp_filter
    from r8brain_torch.utils.scan import response_mag

    build, response = design or (build_lp_filter, response_mag)
    rows = []
    for tb in tbs:
        for att in attens:
            f = build(0.5, float(tb), float(att), 0, 1.0)
            # the stop band (|H| <= -atten) starts at norm_freq * pi; the
            # realised attenuation from there to Nyquist
            th = np.linspace(0.5 * np.pi * 1.0005, np.pi, 4000)
            sb = np.abs(response(f.kernel, th)).max()
            err = -20.0 * np.log10(sb + 1e-300) - att
            # the -3.01 dB point sits at norm_freq * (1 - tb / 100) * pi
            th_scan = np.linspace(0, 0.5 * np.pi, 8001)
            db = 20 * np.log10(np.abs(response(f.kernel, th_scan)) + 1e-300)
            i3 = int(np.searchsorted(db <= -3.01, True))
            th3 = th_scan[min(i3, th_scan.shape[0] - 1)]
            dev3 = (th3 - 0.5 * np.pi * (1.0 - tb / 100.0)) / (0.5 * np.pi)
            rows.append((float(tb), float(att), float(err), float(dev3)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tb-steps", type=int, default=8)
    ap.add_argument("--atten-steps", type=int, default=8)
    args = ap.parse_args(argv)

    from r8brain_torch.design import lpfilter as lp

    rows = error_rows(
        np.geomspace(lp.LP_MIN_TRANS_BAND, lp.LP_MAX_TRANS_BAND,
                     args.tb_steps),
        np.linspace(lp.LP_MIN_ATTEN, lp.LP_MAX_ATTEN, args.atten_steps))
    worst_att = max(max(-err, 0.0) for _tb, _a, err, _d in rows)
    worst_3db = max(abs(dev3) for _tb, _a, _e, dev3 in rows)
    print(f"{'tb%':>7} {'req_att':>8} {'att_err_dB':>11} {'m3db_dev':>9}")
    for tb, att, err, dev3 in rows:
        print(f"{tb:7.2f} {att:8.2f} {err:11.3f} {dev3:9.4f}")
    print(f"\nworst attenuation shortfall: {worst_att:.3f} dB "
          f"(reference realizes +0.40..+4.46 dB above request, "
          f"CDSPFIRFilter.h:583-586)")
    print(f"worst -3 dB point deviation: {worst_3db * 100:.2f} % of cutoff")
    return 0 if worst_att < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
