#!/usr/bin/env python3
"""Where frac_whole's float32 kernel spends its time: the kernel against
builds of it with parts of the work taken out, and its 64-column tile
against the 128-column one, on the card.

    python tools/torch_frac_ablation.py [--iters 10] [--variants base ...]
        [--against NAME=DIR ...]

Builds csrc/frac_whole.cu as it is and, from the same source with
-DR8B_ABLATE=mask (the kernel's ablation switches), variants that drop
parts of the work (their outputs are wrong; only their times are read):

  no_fold         the two_sum fold becomes one add
  no_split        no grids, x1 and x2 copies of x0 (one cvt a float pair)
  only_big        the small-pair MMAs go (the big pair alone)
  no_stage        the input is never staged into shared memory
  mma_only        no fold, no split, no staging: MMAs, operator loads and
                  the output
  nofold_nostage  no fold and no staging

and times each with CUDA events (chip_smoke.cuda_ms) at the fused
flagship's call (C=1024, I=294, D=1027, O=640, 150 windows, 32-term folds),
44.1k -> 96001's two toeplitz conv calls (C=1024, I=256, D=964 / 561,
O=512, 173 / 188 blocks) and the direct conv stage's (C=1024, I=1, D=709,
O=2, 44106 windows), each against its executor's operator and band.
Then it times the kernel as built with the operator packed for the
64-column tile (no register spill) against the 128-column tile the
executors use (255 registers, spilling), at the flagship's call and at the
toeplitz conv stage's (C=1024, I=256, D=964, O=512, 173 blocks).
``--variants`` builds and times only those (``base``: the kernel as it
is).  ``--against NAME=DIR`` also builds DIR/r8brain_torch/csrc/
frac_whole.cu as it is (another tree of this repository, say an unpacked
parent commit) under NAME; the builds are then timed in one order and
again in the reverse one (parent, change, change, parent), at the same
calls with the same operators (a tree whose kernel takes no band, from
before the band walk, is called without one).  Prints one line a timing
and the card's name.  Needs a CUDA device and nvcc; exits non-zero
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

from chip_smoke import cuda_ms  # noqa: E402

# the kernel's R8B_ABLATE bits
FOLD, SPLIT, SMALL, STAGE = 1, 2, 4, 8
VARIANTS = {"base": 0, "no_fold": FOLD, "no_split": SPLIT,
            "only_big": SMALL, "no_stage": STAGE,
            "mma_only": FOLD | SPLIT | STAGE, "nofold_nostage": FOLD | STAGE}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", nargs="+", choices=tuple(VARIANTS),
                    default=list(VARIANTS))
    ap.add_argument("--against", nargs="+", default=[], metavar="NAME=DIR")
    args = ap.parse_args(argv)
    variants = {k: VARIANTS[k] for k in args.variants}
    against = dict(a.split("=", 1) for a in args.against)

    import torch

    if not torch.cuda.is_available():
        print("torch_frac_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from r8brain_torch import Resampler
    from r8brain_torch.ops import _cuda
    from r8brain_torch.ops.pallas_frac import (_F32_ARGS, _pack, _slices,
                                               copy_width, operator_band,
                                               operator_parts)

    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    src = ROOT / "r8brain_torch" / "csrc" / "frac_whole.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_cuda.BUILD_DIR))
    builds = {name: (src, mask) for name, mask in variants.items()}
    builds.update({name: (Path(d) / "r8brain_torch" / "csrc"
                          / "frac_whole.cu", 0)
                   for name, d in against.items()})
    procs = {}
    for name, (path, mask) in builds.items():
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *flags, f"-DR8B_ABLATE={mask}", "-o",
             str(tmp / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(f"build of {name} failed:\n{log}", file=sys.stderr)
            return 1

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    ex = Resampler(44100, 96000, 2.0, 180.15, device=dev).execs[0]
    c1, _poly, c2 = Resampler(44100, 96001, 2.0, 180.15, device=dev).execs
    C = 1024
    shapes = {"flagship": (ex.p_in, ex.D, ex.p_out, 150, ex.op.parts,
                           ex.op.band)}
    for label, cx, n_blk in (("toeplitz964", c1, 173),
                             ("toeplitz561", c2, 188)):
        shapes[label] = (cx.B_toep * cx.spec.down, cx.op.L_f,
                         cx.B_toep * cx.spec.up, n_blk, cx.op.parts,
                         cx.op.band)
    shapes["direct"] = (1, 709, 2, 44106, None, None)
    calls = {}
    for label, (I, D, O, n_win, parts, band) in shapes.items():
        xp = torch.rand((C, (n_win - 1) * I + D), generator=g,
                        device=dev) * 2 - 1
        if parts is None:
            parts = operator_parts(torch.randn((D, O), generator=g,
                                               device=dev))
            band = operator_band(parts)
        y = torch.empty((C, n_win * O), device=dev)
        calls[label] = (xp, parts, band, I, D, O, n_win, y)
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, name, label, xp, parts, band, I, D, O, n_win, y):
        Nt, Kt, P, BN, _ = parts.shape
        # a build from before the band walk takes no band, one from before
        # the in-place read no window origin and length
        head = (xp.data_ptr(), xp.stride(0)) + (
            (0, xp.shape[1]) if in_place[name] else ()) + (
            parts.data_ptr(),) + (
            (band.steps.data_ptr(),) if banded[name] else ())

        # one that chooses the copy width takes it from the caller
        tail = (copy_width(xp, 0, I, O) == 16,) if takes_vec[name] else ()

        def run():
            rc = fn(*head, P - (BN == 8), BN, Kt, y.data_ptr(), C, n_win, I,
                    D, O, 32, *tail, stream)
            if rc != 0:
                raise RuntimeError(f"{name} {label}: CUDA error {rc}")
        return f"{label} {cuda_ms(run, args.iters):8.3f} ms"

    lib, banded, in_place, takes_vec = {}, {}, {}, {}
    for name, (path, _mask) in builds.items():
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).r8b_frac_whole_f32
        text = path.read_text()
        banded[name] = "const int* band" in text
        in_place[name] = "long long x0" in text
        takes_vec[name] = "int fold, int vec" in text
        # _F32_ARGS: x, ldx, x0, n, parts, band, ..., fold, vec, stream
        vec_at = len(_F32_ARGS) - 2
        fn.argtypes = [t for i, t in enumerate(_F32_ARGS)
                       if (in_place[name] or i not in (2, 3))
                       and (banded[name] or i != 5)
                       and (takes_vec[name] or i != vec_at)]
        fn.restype = ctypes.c_int
        lib[name] = fn
    order = list(against) + list(variants)
    for name in order + (order[::-1] if against else []):
        print(f"{name:15s} " + "   ".join(
            timed(lib[name], name, label, *call)
            for label, call in calls.items()))

    # the 64-column tile against the 128-column one, as built
    cx = Resampler(44100, 96000, 2.0, 180.15, fused=False,
                   device=dev).execs[0]
    B, down, up = cx.B_toep, cx.spec.down, cx.spec.up
    L_f, n_blk = cx.op.L_f, 173
    xt = torch.rand((C, (n_blk - 1) * B * down + L_f), generator=g,
                    device=dev) * 2 - 1
    xf, _p, _b, If, Df, Of, nf, _y = calls["flagship"]
    wide = {"flagship": (xf, If, Df, Of, nf, ex.op.hi),
            "toeplitz": (xt, B * down, L_f, B * up, n_blk, cx.op.hi)}
    for label, (xp, I, D, O, n_win, skT) in (wide.items() if "base" in lib
                                             else ()):
        y = torch.empty((C, n_win * O), device=dev)
        packed = {bn: _pack(_slices(skT, None), bn) for bn in (128, 64)}
        times = [timed(lib["base"], "base", f"{label} BN={bn}", xp, p,
                       operator_band(p), I, D, O, n_win, y)
                 for bn, p in packed.items()]
        print(f"{'tile ' + label:15s} " + "   ".join(times))
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
