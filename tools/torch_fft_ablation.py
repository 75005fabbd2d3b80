#!/usr/bin/env python3
"""Where df_fft_conv's one-CTA kernel spends its time: the kernel against
builds of it with parts of the work taken out, on the card.

    python tools/torch_fft_ablation.py [--iters 20]

Builds csrc/df_fft_conv.cu as it is and, from the same source with
-DR8B_ABLATE=mask (the kernel's ablation switches), variants that drop
parts of the work (their outputs are wrong; only their times are read):

  tw_table        every twiddle loaded from the table (15 loads a pass
                  and thread) in place of powers of one (one load);
                  the output is right
  no_twiddle      the twiddles between passes skipped
  no_exchange     the exchanges through shared memory skipped
  no_product      the spectrum product (and its G loads) skipped
  io_only         loads and stores only: no passes, no product
  reg_cap         at most 128 registers a thread (two CTAs an SM at
                  n = 4096, spilling); the output is right

and times each with CUDA events (chip_smoke.cuda_ms) through the
``df_fft_conv`` wrapper at the four calls that chip_smoke.py times,
captured from Resampler(..., precision="high", fused=False).oneshot on
1024 channels x 44100 samples: polyphase n=4096 (``pallas_fft5``, 44.1k
-> 96k), n=8192 head 1416 (``pallas_fft4``), framed n=8192
(``pallas_fft5``, 96k -> 44.1k) and n=2048 (96k -> 44.1k at trans_band 5,
136.45 dB).  Prints one line a variant and the card's name and power
limit.  Needs a CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import capture_calls, cuda_ms  # noqa: E402

# the kernel's R8B_ABLATE bits
TW_TABLE, NO_PRODUCT, IO_ONLY, NO_EXCHANGE, NO_TWIDDLE, REG_CAP = (
    1, 2, 4, 8, 16, 32)
VARIANTS = {"base": 0, "tw_table": TW_TABLE, "no_twiddle": NO_TWIDDLE,
            "no_exchange": NO_EXCHANGE, "no_product": NO_PRODUCT,
            "io_only": IO_ONLY, "reg_cap": REG_CAP}
# (label, src, dst, trans_band, atten, conv_engine) of the captured calls
CALLS = (("poly 4096", 44100, 96000, 2.0, 180.15, "pallas_fft5"),
         ("8192 h1416", 44100, 96000, 2.0, 180.15, "pallas_fft4"),
         ("framed 8192", 96000, 44100, 2.0, 180.15, "pallas_fft5"),
         ("2048", 96000, 44100, 5.0, 136.45, "pallas_fft5"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_fft_ablation: CUDA is not available", file=sys.stderr)
        return 2
    import ctypes

    from r8brain_torch import Resampler
    from r8brain_torch.ops import _cuda, pallas_dfft, stages

    flags = list(_cuda.NVCC_FLAGS)
    src = ROOT / "r8brain_torch" / "csrc" / "df_fft_conv.cu"
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
        if name in ("base", "reg_cap"):  # registers and spills by kernel
            for line in log.splitlines():
                if "conv_reg_kernel" in line or "registers" in line or \
                        "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1024, 44100), generator=g, device=dev) * 2 - 1
    calls = {}
    for label, src_hz, dst_hz, tb, atten, engine in CALLS:
        rs = Resampler(src_hz, dst_hz, tb, atten, precision="high",
                       fused=False, conv_engine=engine, device=dev)
        calls[label] = capture_calls(rs, x, stages,
                                     ("df_fft_conv",))["df_fft_conv"][0]

    real_lib = pallas_dfft._lib
    try:
        for name in VARIANTS:
            lib = ctypes.CDLL(str(tmp / f"{name}.so"))
            lib.r8b_df_fft_conv.argtypes = pallas_dfft._ARGTYPES
            lib.r8b_df_fft_conv.restype = ctypes.c_int
            pallas_dfft._lib = lambda lib=lib: lib
            times = [f"{label} {cuda_ms(lambda: pallas_dfft.df_fft_conv(*c),
                                            args.iters):7.3f} ms"
                     for label, c in calls.items()]
            print(f"{name:12s} " + "   ".join(times), flush=True)
    finally:
        pallas_dfft._lib = real_lib
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
