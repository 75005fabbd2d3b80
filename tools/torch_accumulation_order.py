"""CPU simulation: how the order of the float32 sums in the framed matmul
decides the accuracy class of the 44.1 kHz -> 96 kHz flagship.

    python tools/torch_accumulation_order.py [--channels 4] [--windows 60]

Runs the flagship fused operator (r8brain_torch FusedUpExec: stride 294,
D = 1027 terms per output, 640 outputs per window) on full-scale uniform
input rounded to float32, under several float32 accumulation schemes, and
prints each one's RMS error in dB against the float64 product of the same
float32 input.  A simulation on the CPU: it says nothing about speed.
Imports only the port (no JAX).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from r8brain_torch.models.plan import make_plan  # noqa: E402
from r8brain_torch.ops.fused import FusedUpExec  # noqa: E402
from r8brain_torch.ops.framing import _frames  # noqa: E402


def _db(y, ref) -> float:
    return float(10.0 * np.log10(np.mean((np.asarray(y, np.float64) - ref)
                                         ** 2)))


def _two_sum(hi, lo, acc):
    s = hi + acc
    bp = s - hi
    return s, lo + ((hi - (s - bp)) + (acc - bp))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    plan = make_plan(44100, 96000, 2.0, 180.15, 0)
    s64 = FusedUpExec(plan, torch.float64).op.hi
    s32 = s64.float()
    I, D = 294, s64.shape[0]
    C, n = args.channels, args.windows
    rng = np.random.default_rng(args.seed)
    x32 = torch.tensor(rng.uniform(-1.0, 1.0, (C, (n - 1) * I + D)),
                       dtype=torch.float32)
    w32 = _frames(x32, n, I, D)                     # [C, n, D] float32
    ref = (w32.double() @ s64).numpy()

    rows = [("f32 rounding of skT alone", (w32.double() @ s32.double()))]
    acc = torch.zeros(C, n, s32.shape[1])
    for d in range(D):                               # one running f32 sum
        acc = acc + w32[:, :, d : d + 1] * s32[d]
    rows.append(("one running f32 sum over d", acc))
    rows.append(("torch CPU f32 matmul over all of D", w32 @ s32))

    def partials(kc):
        return [w32[:, :, d0 : d0 + kc] @ s32[d0 : d0 + kc]
                for d0 in range(0, D, kc)]

    for kc in (64, 16):
        tot = torch.zeros_like(acc)
        for p in partials(kc):
            tot = tot + p
        rows.append((f"{kc}-term partials, plain sum", tot))
    for kc in (64, 32, 16):
        ps = partials(kc)
        hi, lo = ps[0], torch.zeros_like(ps[0])
        for p in ps[1:]:
            hi, lo = _two_sum(hi, lo, p)
        rows.append((f"{kc}-term partials, two_sum fold", hi + lo))
    hi = torch.zeros_like(acc)
    comp = torch.zeros_like(acc)
    for d in range(D):                               # Kahan on every term
        t = w32[:, :, d : d + 1] * s32[d] - comp
        s = hi + t
        comp = (s - hi) - t
        hi = s
    rows.append(("Kahan on every term", hi))

    print(f"flagship operator D={D}, {C} channels x {n} windows, full-scale "
          f"uniform float32 input (seed {args.seed}); RMS error vs float64:")
    for name, y in rows:
        print(f"  {name:38s} {_db(y.numpy(), ref):8.1f} dB")


if __name__ == "__main__":
    main()
