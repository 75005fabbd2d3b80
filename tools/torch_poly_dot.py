#!/usr/bin/env python3
"""The polynomial stage's ``poly_dot`` kernel on the card: checked against
its plain version, timed beside its bound, and the stage and the chain
timed on the kernel and on the banded contraction it replaces.

    python tools/torch_poly_dot.py [--reps 20]

At 44.1k -> 96001 (CDSPResampler24, 1024 channels of seeded uniform
input, 1 s), the stage's input is the first conv stage's raw buffer
(``apply_v``) and its outputs the seam path's ceil(M/G)*G columns:

* the kernel against ``poly_dot_ref`` and against the banded contraction
  on the card, each within ``abs_bound`` (two float32 sums of the same 24
  products in other orders); ragged calls too: C = 1, 3, 1024, starts
  below 0 and windows past N, a row-strided unaligned view of x; and
  each at width fl, where the tiles read x from global memory, bit for
  bit the same;
* the kernel's time beside the bytes' bound (x read once, y
  written once, the taps), the plain version's and the banded
  contraction's (the stage before the kernel); the stage's ``apply_v`` and
  the whole oneshot on each path, in turns (banded, kernel, kernel,
  banded; CUDA events, chip_smoke.cuda_ms);
* ``poly.kernel`` / ``poly.banded`` over a profiled window of 8 oneshots
  (one ``poly.kernel`` a call, no ``poly.banded``);
* a gradient through ``resample_fn`` (2 channels, 0.1 s) on the kernel
  path against the banded path's.

Prints one line a check and a JSON record last; exits non-zero when a
check fails.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CHANNELS, N_IN, SEED = 1024, 44100, 25
PEAK_BYTES = 3.35e12


def stage_input(dev, channels: int = CHANNELS):
    """(resampler, poly executor, v, m, Mp): the polynomial stage's raw
    input v with its logical length m at 44.1k -> 96001, and its seam
    path's output columns Mp."""
    import torch

    from r8brain_torch import Resampler

    rs = Resampler(44100, 96001, 2.0, 180.15, device=dev)
    ex = next(e for e in rs.execs if type(e).__name__ == "FracPolyExec")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((channels, N_IN), generator=g, device=dev) * 2 - 1
    T = max(N_IN, rs.in_len_for_out(rs.default_out_len(N_IN)))
    v, m = torch.nn.functional.pad(x, (0, T - N_IN)), T
    for e in rs.execs[:list(rs.execs).index(ex)]:
        v, m = e.apply_v(v, m)
    M = ex.out_len(m)
    return rs, ex, x, v, m, -(-M // ex.G) * ex.G


def within(y, ref, bnd) -> float:
    """max |y - ref| / bound over the outputs (<= 1 passes)."""
    return float(((y.double() - ref.double()).abs() / (bnd + 1e-300))
                 .max())


def ragged_cases(dev):
    """(label, x, starts, taps): C = 1, 2, 3, 130, 1024; starts from below
    0 to windows past N; x contiguous (the TMA box copies) or a row-strided
    view at an unaligned offset (element copies); M a multiple of 4 (the
    bulk row stores) or not; fl 24 and 26 (register windows, 4 or 2 taps a
    load), 18 (steps up to 4: runs split at the window's reach) and 17
    (every sample from shared memory)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(SEED)
    out = []
    for C, N, M, fl, step, view in ((1, 996, 301, 24, 3, False),
                                    (2, 3000, 1400, 18, 5, False),
                                    (3, 5003, 2711, 17, 3, True),
                                    (130, 2001, 777, 26, 3, True),
                                    (1024, 4100, 2204, 24, 3, False)):
        steps = torch.randint(0, step, (M,), generator=g)
        starts = (torch.cumsum(steps, 0) - 40).to(torch.int32)
        starts = starts + (N + 30 - int(starts[-1]) - fl) * (M > 1000)
        big = torch.rand((C, N + 5), generator=g) * 2 - 1
        x = big[:, 3 : N + 3] if view else big[:, :N].clone(
            memory_format=torch.contiguous_format)
        taps = torch.randn((M, fl), generator=g)
        out.append((f"C={C} N={N} M={M} fl={fl} starts "
                    f"{int(starts.min())}..{int(starts.max()) + fl}"
                    + (" (strided view)" if view else ""),
                    x.to(dev), starts.to(dev), taps.to(dev)))
    return out


@contextlib.contextmanager
def on_operators():
    """Every FracPolyExec on its banded operators, the card too (the
    stage before poly_dot), until the block ends."""
    from r8brain_torch.ops.stages import FracPolyExec

    real = FracPolyExec._takes_kernel
    FracPolyExec._takes_kernel = lambda self, *a: False
    try:
        yield
    finally:
        FracPolyExec._takes_kernel = real


def seam_call(ex, v, m, reps: int = 20) -> dict:
    """poly_dot at a polynomial stage's seam call (raw input v of logical
    length m, the ceil(M/G)*G outputs): the launches of one apply_v
    (counted from 0), its distance from the plain version and from the
    stage's banded contraction (``_apply_operators``) in units of
    abs_bound, and the kernel, the plain version and the banded
    contraction (the library yardstick: torch.matmul in IEEE float32, its
    pad, chunks and cat) timed with CUDA events, beside the bytes' bound
    (x read once, y written once, the taps and starts)."""
    import torch

    from chip_smoke import cuda_ms
    from r8brain_torch.ops.poly_dot import abs_bound, poly_dot, poly_dot_ref

    M = ex.out_len(m)
    Mp = -(-M // ex.G) * ex.G
    starts, taps, width = ex._dot_state(Mp, v.device)
    (C, N), fl = v.shape, ex.fl
    poly_dot.launches = 0
    y, m_kern = ex.apply_v(v, m)
    torch.cuda.synchronize()
    launches = poly_dot.launches
    bnd = abs_bound(v, starts, taps)
    plain = poly_dot_ref(v, starts, taps)
    y_band = ex._apply_operators(v, Mp, raw=True)
    band_ms = cuda_ms(lambda: ex._apply_operators(v, Mp, raw=True), reps=5)
    rec = dict(shape=dict(C=C, N=N, M=Mp, fl=fl, width=width),
               launches=launches,
               same_shape=m_kern == M and y.shape == y_band.shape,
               of_bound_plain=within(y, plain, bnd),
               of_bound_banded=within(y, y_band, bnd),
               max_abs=float((y - plain).abs().max()))
    del y, y_band, plain, bnd
    nbytes = 4.0 * (C * N + C * Mp + taps.numel() + starts.numel())
    rec.update(kernel_ms=cuda_ms(lambda: poly_dot(v, starts, taps, width),
                                 reps=reps),
               plain_ms=cuda_ms(lambda: poly_dot_ref(v, starts, taps),
                                reps=2),
               banded_ms=band_ms, mbytes=nbytes / 1e6,
               bound_ms=nbytes / PEAK_BYTES * 1e3)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import cuda_ms
    from r8brain_torch import resample_fn
    from r8brain_torch.ops import _cuda
    from r8brain_torch.ops.poly_dot import abs_bound, poly_dot, poly_dot_ref

    if not torch.cuda.is_available():
        print("torch_poly_dot: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _cuda.build(["poly_dot"])
    for line in _cuda.build_logs.get("poly_dot", "").splitlines():
        if any(k in line for k in ("registers", "spill", "smem")):
            print("ptxas:", line.strip())
    ok, rec = True, {"card": card}

    def check(good, what):
        nonlocal ok
        print(("ok: " if good else "FAILED: ") + what)
        ok = ok and good

    for label, x, starts, taps in ragged_cases(dev):
        y = poly_dot(x, starts, taps)
        torch.cuda.synchronize()
        r = within(y, poly_dot_ref(x, starts, taps), abs_bound(x, starts,
                                                                taps))
        check(r <= 1.0, f"ragged {label}: {r:.3f} of the bound")
        narrow = poly_dot(x, starts, taps, taps.shape[1])
        check(torch.equal(narrow, y), f"ragged {label}, width fl (tiles "
              f"read x from global memory): bit-equal")

    rs, ex, x, v, m, _Mp = stage_input(dev)
    sc = seam_call(ex, v, m, args.reps)
    rec.update(sc)
    shape = " ".join(f"{k}={v_}" for k, v_ in sc["shape"].items())
    check(sc["launches"] == 1, f"{sc['launches']} launches a stage call")
    check(sc["same_shape"], "the kernel's output has the banded "
          "contraction's shape")
    check(sc["of_bound_plain"] <= 1.0 and sc["of_bound_banded"] <= 1.0,
          f"cell shape ({shape}): {sc['of_bound_plain']:.3f} / "
          f"{sc['of_bound_banded']:.3f} of the bound from the plain version "
          f"/ the banded contraction")
    print(f"timing [{card}]: poly_dot {shape}: {sc['kernel_ms']:.4f} ms; "
          f"bound {sc['bound_ms']:.4f} ms (bytes, {sc['mbytes']:.1f} MB); "
          f"plain {sc['plain_ms']:.3f} ms; the stage on the banded "
          f"contraction {sc['banded_ms']:.4f} ms")

    def paths(fn):
        """fn timed banded, kernel, kernel, banded: (banded, kernel)."""
        out = {True: [], False: []}
        for banded in (True, False, False, True):
            with on_operators() if banded else contextlib.nullcontext():
                out[banded].append(cuda_ms(fn, reps=args.reps))
        return sum(out[True]) / 2, sum(out[False]) / 2

    st_b, st_k = paths(lambda: ex.apply_v(v, m))
    one_b, one_k = paths(lambda: rs.oneshot(x))
    rec.update(stage_ms=dict(banded=st_b, kernel=st_k),
               oneshot_ms=dict(banded=one_b, kernel=one_k))
    print(f"timing [{card}]: polynomial stage apply_v banded {st_b:.4f} ms, "
          f"kernel {st_k:.4f} ms; oneshot banded {one_b:.3f} ms = "
          f"{1e-6 * CHANNELS * N_IN / (one_b * 1e-3):.1f} Mrops, kernel "
          f"{one_k:.3f} ms = {1e-6 * CHANNELS * N_IN / (one_k * 1e-3):.1f} "
          f"Mrops")

    # the engagement counters over a profiled window of oneshots
    from r8brain_torch.utils import trace

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        trace.reset_counters()
        for _ in range(8):
            rs.oneshot(x)
        torch.cuda.synchronize()
        cnt = {k: v for k, v in trace.counters().items()
               if k.startswith("poly")}
    trace.reset_counters()
    check(cnt.get("poly.kernel") == 8 and "poly.banded" not in cnt,
          f"8 profiled oneshots count {cnt}")
    rec.update(counters=cnt)
    del v, x

    # a gradient through resample_fn on each path
    n = 4410
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    xg = torch.rand((2, n), generator=g, device=dev) * 2 - 1
    f = resample_fn(rs, n)
    w = torch.rand((2, rs.default_out_len(n)), generator=g, device=dev)
    with on_operators():
        gb = torch.func.grad(lambda z: (w * f(z)).sum())(xg).double()
    gk = torch.func.grad(lambda z: (w * f(z)).sum())(xg).double()
    g_rel = float((gk - gb).abs().max() / gb.abs().max())
    check(g_rel <= 1e-5, f"gradient through resample_fn 44.1k->96001 fast: "
          f"kernel path within {g_rel:.3e} of max |g| of the banded path's")
    rec.update(grad_max_rel=g_rel, ok=ok)
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
