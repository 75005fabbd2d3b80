#!/usr/bin/env python3
"""Where sym_conv's float32 kernel spends its time: the kernel against
builds of it with parts of the work taken out, on the card.

    python tools/torch_sym_ablation.py [--iters 10]

Builds csrc/sym_conv.cu as it is and, from the same source with
-DR8B_ABLATE=mask (the kernel's ablation switches), variants that drop
parts of the work (their outputs are wrong; only their times are read):

  no_stage        the span of the windows is never staged
  no_fold_split   neither the reversed window nor the split and its
                  grids: z = w = a, one bf16 conversion a float pair
  no_twosum       the two_sum fold of the big pair becomes one add
  only_big        the small-pair (and "high") MMAs go: the big pairs alone
  no_store        the epilogue computes but stores nothing
  mma_only        no staging, reversed window, split or two_sum: MMAs,
                  operator copies and the epilogue
  mma_nostore     mma_only without the stores

and times each with CUDA events (chip_smoke.cuda_ms) at the three calls of
the main paths, captured from Resampler(..., fused=False,
conv_engine="toeplitz_sym").oneshot on 1024 channels x 44100 samples:
44.1k -> 96k "fast" and "high" (the residual slice), 96k -> 44.1k
"fast".  Prints one line a variant and the
card's name and power limit.  Needs a CUDA device and nvcc; exits
non-zero without them.
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

from chip_smoke import capture_calls, cuda_ms  # noqa: E402

# the kernel's R8B_ABLATE bits
TWOSUM, SPLIT, SMALL, STAGE, STORE, SYM = 1, 2, 4, 8, 16, 32
MMA_ONLY = TWOSUM | SPLIT | STAGE | SYM
VARIANTS = {"base": 0, "no_stage": STAGE, "no_fold_split": SPLIT | SYM,
            "no_twosum": TWOSUM, "only_big": SMALL, "no_store": STORE,
            "mma_only": MMA_ONLY, "mma_nostore": MMA_ONLY | STORE}
# (label, src, dst, precision) of the captured calls
CALLS = (("44.1k->96k fast", 44100, 96000, "fast"),
         ("44.1k->96k high", 44100, 96000, "high"),
         ("96k->44.1k fast", 96000, 44100, "fast"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_sym_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from r8brain_torch import Resampler
    from r8brain_torch.ops import _cuda, stages
    from r8brain_torch.ops.pallas_symconv import _F32_ARGS

    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    src = ROOT / "r8brain_torch" / "csrc" / "sym_conv.cu"
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

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1024, 44100), generator=g, device=dev) * 2 - 1
    calls = {}
    for label, src_hz, dst_hz, prec in CALLS:
        rs = Resampler(src_hz, dst_hz, 2.0, 180.15, precision=prec,
                       fused=False, conv_engine="toeplitz_sym", device=dev)
        (xp, parts, L_fs, nb, hop), kw = capture_calls(
            rs, x, stages, ("sym_conv",))["sym_conv"]
        y = torch.empty((xp.shape[0], nb * 256 * len(L_fs)), device=dev)
        calls[label] = (xp, parts, L_fs, nb, hop, y)
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, name, label, xp, parts, L_fs, nb, hop, y):
        Lf = (ctypes.c_int * len(L_fs))(*L_fs)

        def run():
            rc = fn(xp.data_ptr(), xp.stride(0), parts.data_ptr(),
                    parts.shape[4], parts.shape[2], y.data_ptr(), xp.shape[0],
                    nb, hop, len(L_fs), Lf, stream)
            if rc != 0:
                raise RuntimeError(f"{name} {label}: CUDA error {rc}")
        return f"{label} {cuda_ms(run, args.iters):8.3f} ms"

    for name in VARIANTS:
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).r8b_sym_conv_f32
        fn.argtypes, fn.restype = _F32_ARGS, ctypes.c_int
        print(f"{name:14s} " + "   ".join(
            timed(fn, name, label, *call) for label, call in calls.items()),
            flush=True)
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
