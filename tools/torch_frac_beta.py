#!/usr/bin/env python3
"""frac_whole's bias on the card: beta = mean(e * sign(y64)) / rms(e) of
its float32 error e against its float64 function, beside its plain model
and the floating split with truncated fold sums.

    python tools/torch_frac_beta.py [--channels 1024] [--device cuda]

For the flagship's fused call (I=294, D=1027, O=640), the half-band
upsampler of 44.1k -> 192k (I=128, D=150, O=256), the toeplitz conv
stage of 44.1k -> 96k (I=256, D=964, O=512) and its direct form (I=1,
D=709, O=2: the 8-column tile), each "fast" and "high" at its executor's
fold, on full-mantissa uniform input (seed 0): beta and RMS dB re full
scale of the kernel (``frac_whole``), of its plain model
(``frac_whole_ref``), of ``floating_split(fold_sum="truncate")``, the
arithmetic of a kernel whose lead slices float (each slice the nearest
bfloat16 to what the ones before left) on tensor cores that truncate each
big-pair fold sum toward zero (a truncated sum is a loss of gain: beta
clearly negative), and of the same split with each fold sum rounded once
to nearest (what the grids give up: the floating split holds the input
exactly).  Prints one line a call and the card's name and power limit;
with ``--device cpu`` the kernel's column is the plain model's.  Raises
without CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import FRAC_BETA_MAX, beta_of, beta_sums  # noqa: E402,F401


def floating_split(xp, parts, I, D, O, n_win, kc, fold_sum="float32"):
    """frac_whole's arithmetic with floating lead slices: x and the
    operator (s0 + s1 + s2 of ``parts``, and bf16(skT_lo)) split by
    ``split3``, each slice the nearest bfloat16 to what the ones before
    left; each big-pair fold summed (``fold_sum``) in float32, a float32
    matmul whose adds round to nearest ("float32"), or exactly and then
    rounded once, to nearest ("nearest") or toward zero ("truncate", as
    tensor cores that truncate an inexact sum do); folded into (hi, lo)
    with two_sum; the small pairs summed fold by fold in float32; hi +
    (lo + small)."""
    if fold_sum not in ("float32", "nearest", "truncate"):
        raise ValueError(f"fold_sum must be float32, nearest or truncate, "
                         f"got {fold_sum!r}")
    import torch

    from r8brain_torch.ops.dfloat import two_sum
    from r8brain_torch.ops.pallas_frac import split3, unpack_parts

    s = unpack_parts(parts, D, O)
    hi_s = list(split3(s[:3].double().sum(0).float()))
    xs = [v.unfold(1, D, I)[:, :n_win]
          for v in split3(xp[:, :(n_win - 1) * I + D])]
    hi = lo = small = None
    for d0 in range(0, D, kc):
        r = slice(d0, min(D, d0 + kc))
        x0, x1, x2 = (v[..., r] for v in xs)
        if fold_sum == "float32":
            acc = torch.matmul(x0, hi_s[0][r])
        else:
            p = torch.matmul(x0.double(), hi_s[0][r].double())
            acc = p.float()
            if fold_sum == "truncate":
                up = acc.double().abs() > p.abs()
                acc = torch.where(up, torch.nextafter(acc,
                                                      torch.zeros_like(acc)),
                                  acc)
        sm = (x0 @ (hi_s[1][r] + hi_s[2][r]) + x1 @ (hi_s[0][r] + hi_s[1][r])
              + x2 @ hi_s[0][r])
        if s.shape[0] == 4:
            sm = sm + x0 @ s[3][r]
        if hi is None:
            hi, lo, small = acc, torch.zeros_like(acc), sm
        else:
            hi, e = two_sum(hi, acc)
            lo, small = lo + e, small + sm
    return (hi + (lo + small)).reshape(xp.shape[0], -1)


def beta(y, y64) -> float:
    """mean(e * sign(y64)) / rms(e) of e = y - y64 (chip_smoke's
    beta_sums, beta_of), 0 where e is all zero."""
    return beta_of(beta_sums(y, y64))


#: the calls, "<call> <precision>"
LABELS = tuple(f"{c} {p}" for p in ("fast", "high")
               for c in ("flagship", "hb_up", "toeplitz", "direct"))


def calls(dev, only=LABELS):
    """(label, I, D, O, n_win, parts, float64 operator parts, fold, band)
    of the calls in ``only`` (LABELS: four calls, "fast" and "high"); band
    is the executor's own operator_band of parts."""
    import torch

    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.fused import FusedUpExec
    from r8brain_torch.ops.pallas_frac import operator_parts
    from r8brain_torch.ops.stages import ConvExec, HBUpExec

    p96 = make_plan(44100, 96000, 2.0, 180.15, 0)
    hb = make_plan(44100, 192000, 2.0, 180.15, 0).stages[-1]
    out = []
    for label in only:
        call, prec = label.split()
        if call == "flagship":
            ex = FusedUpExec(p96, torch.float32, prec).to(dev)
            head = (ex.p_in, ex.D, ex.p_out, 8)
        elif call == "hb_up":
            ex = HBUpExec(hb, torch.float32, precision=prec).to(dev)
            head = (128, ex.op.L_f, ex.op.Kcols, 20)
        elif call == "toeplitz":
            ex = ConvExec(p96.stages[0], torch.float32, prec,
                          engine="toeplitz").to(dev)
            head = (ex.B_toep * ex.spec.down, ex.op.L_f, ex.op.Kcols, 10)
        else:
            ex = ConvExec(p96.stages[0], torch.float32, prec,
                          engine="direct").to(dev)
            head = (ex.spec.down, ex.op.L_f, ex.op.Kcols, 100)
        op = ex.op
        p64 = operator_parts(op.hi.double(),
                             None if op.lo is None else op.lo.double())
        out.append((label, *head, op.parts, p64, op.kc, op.band))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch.models.resampler import resolve_device
    from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref

    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    for label, I, D, O, n_win, parts, p64, kc, band in calls(dev):
        L = (n_win - 1) * I + D
        u = torch.rand((args.channels, L), generator=g, device=dev,
                       dtype=torch.float64)
        xp = (u * 2 - 1).float()
        y64 = frac_whole_ref(xp.double(), p64, I, D, O, n_win)
        cols = []
        for name, fn in (("kernel", partial(frac_whole, band=band)),
                         ("model", partial(frac_whole_ref, band=band)),
                         ("floating truncated",
                          partial(floating_split, fold_sum="truncate")),
                         ("floating nearest",
                          partial(floating_split, fold_sum="nearest"))):
            y = fn(xp, parts, I, D, O, n_win, kc)
            db = 10 * torch.log10((y.double() - y64).square().mean()).item()
            cols.append(f"{name} beta {beta(y, y64):+.4f} ({db:.2f} dB)")
        print(f"{label} I={I} D={D} O={O} C={args.channels} n_win={n_win} "
              f"fold {kc}: " + ", ".join(cols))
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
