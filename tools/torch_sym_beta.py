#!/usr/bin/env python3
"""sym_conv's bias on the card against two plain models of its rounding.

    python tools/torch_sym_beta.py [--device cuda|cpu]

For each conv spec of the folded engine (the card test's ``SYM_CFGS``),
fast and high, 1024 rows of 8 frames of full-mantissa uniform input
(seed 16, as tests/test_torch_cuda.py::test_sym_conv_unbiased) go
through:

* ``sym_conv`` (the kernel on ``cuda``; its plain version on the CPU);
* ``sym_conv_ref``, which sums each fold's small pairs exactly and rounds
  them once into lo (to nearest);
* ``truncation_model``: the kernel's work order with every small-pair
  (and "high") MMA added into lo as the tensor cores add it, the exact sum
  of lo and the step's 16 products rounded toward zero (``rz``), in the
  kernel's MMA order; the big pair's step sums are exact either way.

Prints for each the bias statistic beta = mean(e * sign(y64)) / rms(e)
of its error e against the float64 function, its RMS error in dB re full
scale, and the kernel's distance from each model (the share of outputs
bit-equal, the largest difference in ulps of max |y|), then one JSON line
of all of it.  A model that reproduces the kernel's beta and bits names
the kernel's rounding.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SYM_CFGS = ((44100, 96001, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
            (44100, 96000, 2.0, 180.15), (96000, 44100, 5.0, 136.45))
CHANNELS, FRAMES = 1024, 8


def rz(x):
    """float64 -> float32 rounded toward zero, as the tensor cores round
    an inexact sum."""
    import torch

    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def truncation_model(xp, parts, L_fs, nb, hop):
    """The kernel's work order (csrc/sym_conv.cu): per phase and 32-column
    tile, k-tile by k-tile, folds of KC rows; in each fold the big pair's
    16-row step sums (exact) added in float32 into the fold's partial, the
    small pairs (and "high" terms) added into lo one MMA at a time in the
    kernel's order, each sum rounded toward zero; then two_sum of the
    partial into hi, its error added into lo; the tile's halves combined
    as the epilogue does."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.dfloat import two_sum
    from r8brain_torch.ops.framing import _frames
    from r8brain_torch.ops.pallas_frac import KC, TILE_K
    from r8brain_torch.ops.pallas_symconv import (BH, TILE_N, split_grid,
                                                  unpack_sym)

    S = unpack_sym(parts).double()  # [up, 2, P, Kt * TILE_K, BH]
    up, _, P, K, _ = S.shape
    C = xp.shape[0]
    y = torch.empty((C, nb, 2 * BH, up), device=xp.device)
    for j, L_f in enumerate(L_fs):
        Hp = (L_f + 1) // 2
        fr = _frames(xp, nb, hop, L_f)
        a, r = fr[..., :Hp], fr.flip(-1)[..., :Hp]
        z, ez = two_sum(a, r)
        w, ew = two_sum(a, -r)
        pad = (0, K - Hp)
        A = [[F.pad(s, pad).double() for s in split_grid(v)]
             + [F.pad(e.to(torch.bfloat16).float(), pad).double()]
             for v, e in ((z, ez), (w, ew))]
        for n in range(BH // TILE_N):
            cols = slice(n * TILE_N, (n + 1) * TILE_N)
            hi = [torch.zeros((C, nb, TILE_N), device=xp.device)
                  for _ in range(2)]
            lo = [torch.zeros_like(hi[0]) for _ in range(2)]
            for l0 in range(0, Hp, KC):
                for o in range(2):
                    v0, v1, v2, e0 = A[o]
                    B = S[j, o, :, :, cols]  # [P, K, TILE_N]
                    pe = None
                    for s0 in range(l0, l0 + KC, 16):
                        g = slice(s0, s0 + 16)
                        p = (v0[..., g] @ B[0, g]).float()  # exact
                        pe = p if pe is None else pe + p
                        terms = [(v0, 1), (v1, 0), (v0, 2), (v1, 1), (v2, 0)]
                        if P == 4:
                            terms += [(e0, 0), (v0, 3)]
                        for v, b in terms:
                            lo[o] = rz(lo[o].double() + v[..., g] @ B[b, g])
                    hi[o], err = two_sum(hi[o], pe)
                    lo[o] = lo[o] + err
            s, e = two_sum(hi[0], hi[1])
            y[:, :, cols, j] = s + (e + (lo[0] + lo[1]))
            s, e = two_sum(hi[0], -hi[1])
            y[:, :, 2 * BH - 1 - n * TILE_N - torch.arange(TILE_N), j] = \
                s + (e + (lo[0] - lo[1]))
    return y.reshape(C, -1)


def beta(e, y64) -> float:
    return ((e * y64.sign()).mean() / e.square().mean().sqrt()).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.models.resampler import resolve_device
    from r8brain_torch.ops.pallas_symconv import (sym_conv, sym_conv_ref,
                                                  sym_ops_high, sym_parts)
    from r8brain_torch.ops.stages import ConvExec

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    out = []
    for cfg in SYM_CFGS:
        st = make_plan(*cfg, 0).stages[0]
        ex = ConvExec(st, torch.float32, "high",
                      engine="toeplitz_sym").to(dev)
        C, nb, hop = CHANNELS, FRAMES, 256 * st.down
        L = (nb - 1) * hop + max(ex.sym_Lf)
        rng = np.random.default_rng(16)
        x = torch.tensor(rng.uniform(-1, 1, (C, L)), dtype=torch.float32,
                         device=dev)
        for prec in ("fast", "high"):
            ops, lo, rows = ex.sym_ops, ex.sym_lo, ex.sym_lo_rows
            if prec == "fast":
                parts, ops64 = sym_parts(ops), ops.double()
            else:
                parts, ops64 = ex.sym_parts, sym_ops_high(ops, lo, rows)
            fa = (ex.sym_Lf, nb, hop)
            y64 = sym_conv_ref(x.double(), ops64, *fa)
            ys = {"kernel": sym_conv(x, parts, *fa),
                  "ref": sym_conv_ref(x, parts, *fa),
                  "rz_model": truncation_model(x, parts, *fa)}
            ulp = 2.0 ** (math.floor(math.log2(y64.abs().max().item())) - 23)
            row = {"cfg": list(cfg), "precision": prec}
            for k, y in ys.items():
                e = y.double() - y64
                row[k] = {"beta": round(beta(e, y64), 5), "db": round(
                    10 * math.log10(e.square().mean().item() + 1e-300), 3)}
                if k != "kernel":
                    d = (ys["kernel"].double() - y.double()).abs()
                    row[k]["equal"] = round(
                        (d == 0).double().mean().item(), 5)
                    row[k]["max_ulps"] = round(d.max().item() / ulp, 3)
            print(f"{cfg} {prec}: " + ", ".join(
                f"{k} beta {v['beta']:+.4f} {v['db']:.2f} dB"
                + (f" (kernel equal {v['equal']:.4f}, max {v['max_ulps']:g}"
                   " ulps)" if "equal" in v else "")
                for k, v in row.items() if isinstance(v, dict)))
            out.append(row)
    print(json.dumps({"metric": "sym_conv_beta", "device": name,
                      "channels": CHANNELS, "frames": FRAMES,
                      "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
