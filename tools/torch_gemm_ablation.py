#!/usr/bin/env python3
"""Where dense_gemm's kernel spends its time: the kernel against builds of
it with parts of the work taken out, on the card.

    python tools/torch_gemm_ablation.py [--iters 10]

Builds csrc/dense_gemm.cu as it is and, from the same source with
-DR8B_ABLATE=mask (the kernel's ablation switches), variants that drop
parts of the work (their outputs are wrong; only their times are read):

  no_split        one bf16 conversion a float pair: x1 = x2 = x0
  no_store        the epilogue computes but stores nothing
  big_only        the five small-pair MMAs go: the big pair alone
  mma_only        no A fragment reads, no split, no stores: the MMAs on
                  fixed registers, the copies into shared memory and the
                  rings

and times each with CUDA events (chip_smoke.cuda_ms), calling the kernel
on a B packed once (``pack_b``, timed on its own: ``dense_gemm`` packs B
in every call) at the conv stage's Toeplitz shape (M = 175104, K = 704,
N = 512; chip_smoke.py's GEMM_*), in one K loop and in hop-256 segments,
beside float32 torch.matmul (TF32 off).  Prints one line a variant and the
card's name and power limit.  Needs a CUDA device and nvcc; exits non-zero
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import GEMM_HOP, GEMM_K, GEMM_M, GEMM_N, cuda_ms  # noqa: E402

# the kernel's R8B_ABLATE bits
NO_SPLIT, NO_STORE, NO_FRAG, NO_SMALL = 1, 2, 4, 8
VARIANTS = {"base": 0, "no_split": NO_SPLIT, "no_store": NO_STORE,
            "big_only": NO_SMALL, "mma_only": NO_FRAG | NO_STORE}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_gemm_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from r8brain_torch.ops import _cuda
    from r8brain_torch.ops.scout import FOLD, pack_b

    torch.backends.cuda.matmul.allow_tf32 = False
    flags = list(_cuda.NVCC_FLAGS)
    src = ROOT / "r8brain_torch" / "csrc" / "dense_gemm.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_cuda.BUILD_DIR))
    procs = {}
    for name, mask in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *flags, f"-DR8B_ABLATE={mask}", "-o",
             str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(f"build of {name} failed:\n{log}", file=sys.stderr)
            return 1
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    M, K, N = GEMM_M, GEMM_K, GEMM_N
    A = torch.randn((M, K), generator=g, device=dev)
    B = torch.randn((K, N), generator=g, device=dev)
    C = torch.empty((M, N), device=dev)
    packed = pack_b(B)
    stream = torch.cuda.current_stream().cuda_stream
    vp, i = ctypes.c_void_p, ctypes.c_int
    flops = 2.0 * M * K * N
    print(f"pack_b {cuda_ms(lambda: pack_b(B), args.iters):.3f} ms; "
          f"torch.matmul f32 (TF32 off) "
          f"{cuda_ms(lambda: torch.matmul(A, B), args.iters):.3f} ms")
    for name in VARIANTS:
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).r8b_dense_gemm_f32
        fn.argtypes, fn.restype = [vp, vp, vp, i, i, i, i, vp], ctypes.c_int

        def run(fold):
            rc = fn(A.data_ptr(), packed.data_ptr(), C.data_ptr(), M, K, N,
                    fold, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        times = []
        for label, fold in (("one K loop", FOLD), (f"hop {GEMM_HOP}",
                                                    GEMM_HOP)):
            ms = cuda_ms(lambda: run(fold), args.iters)
            times.append(f"{label} {ms:7.3f} ms ({6 * flops / ms * 1e-9:5.1f}"
                         f" bf16 TFLOP/s)")
        print(f"{name:10s} " + "   ".join(times), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for f in tmp.iterdir():
        os.remove(f)
    tmp.rmdir()
    return 0


if __name__ == "__main__":
    sys.exit(main())
