#!/usr/bin/env python3
"""The conv stage's framed product on the card: the chain's own
formulation against plain dense GEMMs of the same size.

    python tools/torch_exp_framed_kernel.py [--c 1024] [--nb 171]
        [--hop 256] [--k 704] [--n 512] [--iters 20]

Counterpart of the reference package's tools/exp_framed_kernel.py and
tools/exp_pallas_gemm.py, with their shapes and their questions: does a
plain dense GEMM kernel (no Toeplitz logic) trail the library's on the
[M = C*nb, K, N] problem of the conv stage, and how far is the chain's
real formulation (the toeplitz engine's frac_whole call, windows read
straight from the signal at stride hop, no frame tensor) from that
ceiling?  Times with CUDA events after a warm-up (chip_smoke.cuda_ms), in
float32 with TF32 off:

  frac_whole_chain  frac_whole on the un-materialized frames
                    (ops/pallas_frac.py, the toeplitz engine's call)
  gemm_mt512        dense_gemm (csrc/dense_gemm.cu) at M tile 512
  gemm_mt176        the same at M tile 176
  gemm_seg512       M tile 512, K summed in hop-row segments
  matmul            torch.matmul on the same dense operand

and prints Tflop/s (2*C*nb*k*n flop over the time) per case, then one
dict.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--c", type=int, default=1024)
    ap.add_argument("--nb", type=int, default=171)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--k", type=int, default=704)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_exp_framed_kernel: CUDA is not available",
              file=sys.stderr)
        return 2
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.scout import dense_gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C, nb, hop, L_f, N = args.c, args.nb, args.hop, args.k, args.n
    n_seg = -(-L_f // hop)
    g = torch.Generator(device=dev).manual_seed(0)
    xp = torch.randn((C, (nb + n_seg + 8) * hop), generator=g, device=dev)
    T = torch.randn((L_f, N), generator=g, device=dev)
    M = C * nb  # logical frame rows
    lcm = 512 * 176 // math.gcd(512, 176)
    A = torch.randn((-(-M // lcm) * lcm, L_f), generator=g, device=dev)
    flops = 2.0 * M * L_f * N
    cases = (
        ("frac_whole_chain", lambda: frac_whole(xp, T, hop, L_f, N, nb)),
        ("gemm_mt512", lambda: dense_gemm(A, T, 512)),
        ("gemm_mt176", lambda: dense_gemm(A, T, 176)),
        ("gemm_seg512", lambda: dense_gemm(A, T, 512, hop)),
        ("matmul", lambda: torch.matmul(A, T)))
    out = {}
    for name, fn in cases:
        ms = cuda_ms(fn, args.iters)
        out[name] = round(flops / ms * 1e-9, 2)
        print(f"{name:16s} {ms:7.3f} ms  {out[name]:6.2f} Tflop/s logical",
              file=sys.stderr)
    print(f"{torch.cuda.get_device_name(0)}, C={C} nb={nb} hop={hop} "
          f"k={L_f} n={N}")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
