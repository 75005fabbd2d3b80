#!/usr/bin/env python3
"""Where ozaki_framed's time goes: the kernel against builds of it with
parts of the work taken out, on the card.

    python tools/torch_ozaki_ablation.py [--iters 10]

Builds csrc/ozaki_framed.cu as it is and, from the same source with
-DR8B_ABLATE=mask (the kernel's ablation switches), variants that drop
parts of the work (their outputs are wrong; only their times are read):

  no_fold     the fold of a chunk's 10 pair values becomes plain adds
              into hi (no two_sum, no order)
  no_split    the four slices are all bf16(x) (one cvt a float pair)
  only_big    the small pairs go: only A_0 x [s0|s1|s2|s3] (4 of 10 pairs)
  no_stage    the input is never staged into shared memory
  no_skip     every k-tile is read, not only the band's
  mma_only    no fold, no split, no staging: the wgmmas, the operator's
              bulk copies and the output

and times each with CUDA events (chip_smoke.cuda_ms) at the guarantee
chain's two calls, on its own operators: the conv stage (C=1024, L_f=964,
hop=256, Kcols=512, 174 blocks) and the frac stage (D=170, stride 147,
Kcols=160, 600 windows), without x_lo and emit_pair (the carry-off
chain's calls).  Prints one line a variant and the card's name.  Needs a
CUDA device and nvcc; exits non-zero without them.
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

from chip_smoke import cuda_ms  # noqa: E402

# the kernel's R8B_ABLATE bits
FOLD, SPLIT, SMALL, STAGE, SKIP = 1, 2, 4, 8, 16
VARIANTS = {"base": 0, "no_fold": FOLD, "no_split": SPLIT,
            "only_big": SMALL, "no_stage": STAGE, "no_skip": SKIP,
            "mma_only": FOLD | SPLIT | STAGE}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_ozaki_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from r8brain_torch import Resampler
    from r8brain_torch.ops import _cuda
    from r8brain_torch.ops.ozaki import channel_scale
    from r8brain_torch.ops.pallas_ozaki import launch_args, set_argtypes

    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    src = ROOT / "r8brain_torch" / "csrc" / "ozaki_framed.cu"
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
    rs = Resampler(44100, 96000, 2.0, 180.15, precision="high",
                   conv_engine="ozaki", frac_engine="ozaki", device=dev)
    conv, frac = rs.execs
    C = 1024
    calls = {}
    for label, ex, nb in (("conv", conv, 174), ("frac", frac, 600)):
        L_f, hop, Kcols, _ = ex.geometry(1)
        xp = torch.rand((C, (nb - 1) * hop + L_f), generator=g,
                        device=dev) * 2 - 1
        y = torch.empty((C, nb * Kcols), device=dev)
        calls[label] = launch_args(xp, channel_scale(xp),
                                   (ex.op.tiles, ex.op.bands), L_f, hop,
                                   Kcols, nb, None, y, None)
    stream = torch.cuda.current_stream().cuda_stream

    for name in VARIANTS:
        fn = set_argtypes(ctypes.CDLL(str(tmp / f"{name}.so"))).r8b_ozaki_framed
        times = []
        for label, a in calls.items():
            def run():
                rc = fn(*a, stream)
                if rc != 0:
                    raise RuntimeError(f"{name} {label}: CUDA error {rc}")
            times.append(f"{label} {cuda_ms(run, args.iters):8.3f} ms")
        print(f"{name:10s} " + "   ".join(times))
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
