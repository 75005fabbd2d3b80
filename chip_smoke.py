#!/usr/bin/env python3
"""Smoke test of the r8brain_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the main
path (the 44.1 kHz -> 96 kHz flagship, 1024 channels x 1 s, float32,
``precision="fast"``) through ``Resampler.oneshot`` and checks its output
against the port's own float64 CPU path, then times the path, the kernel,
its plain version and the one PyTorch call that computes the same
function.  Every phase prints one line; the line before the last is the
per-kernel JSON record and the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line,
when CUDA is unavailable, a kernel does not build or launch, or any check
fails.  Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
SRC, DST, TB, ATTEN = 44100, 96000, 2.0, 180.15
CHANNELS, N_IN = 1024, 44100
N_CMP = 4              # channels held against the float64 CPU path
EDGE_S = 0.05          # edge skip of that comparison, seconds
CLASS_DB = -141.0      # the reference's golden-equality class
KERNEL_REL_TOL = 1e-5  # kernel (f32) vs frac_whole_ref (f64), max rel err
F64_REL_TOL = 1e-12    # kernel (f64) vs frac_whole_ref (f64)

# (fp32 CUDA-core peak FLOP/s, HBM bytes/s) by SKU, dense, at the full power
# limit (NVIDIA data sheets).  Substring match on the device name.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 67.0e12, 3.35e12), ("H200", 67.0e12, 4.8e12))


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rms_db(d) -> float:
    """10*log10(mean(d^2)): RMS of a difference in dB re full scale."""
    import numpy as np

    return float(10.0 * np.log10(np.mean(np.square(d)) + 1e-300))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_rel(y, ref) -> float:
    return float(((y.double() - ref).abs().max() / ref.abs().max()).item())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from r8brain_torch import Resampler
    from r8brain_torch.ops import _cuda
    from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref

    # full fp32 everywhere: TF32 cannot hold the -141 dB class
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(f"device: {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    peak_flops, peak_bytes = next((f, b) for k, f, b in PEAKS if k in name)

    # build every kernel of the path, all nvcc processes at once
    t0 = time.perf_counter()
    _cuda.build(["frac_whole"])
    print(f"build: frac_whole {time.perf_counter() - t0:.1f} s")
    for line in _cuda.build_logs.get("frac_whole", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain, on the card
    rs = Resampler(SRC, DST, TB, ATTEN, device=dev)
    ex = rs.execs[0]
    I, D, O = ex.p_in, ex.D, ex.p_out
    # the window count oneshot gives the kernel (its zero-flush pad)
    T = max(N_IN, rs.in_len_for_out(rs.default_out_len(N_IN)))
    n_win = -(-rs.out_len_for_in(T) // O)
    L = (n_win - 1) * I + D
    g = torch.Generator(device=dev).manual_seed(SEED)
    xp = torch.rand((CHANNELS, L), generator=g, device=dev) * 2 - 1
    y = frac_whole(xp, ex.skT, I, D, O, n_win)
    ref64 = frac_whole_ref(xp.double(), ex.skT.double(), I, D, O, n_win)
    ref32 = frac_whole_ref(xp, ex.skT, I, D, O, n_win)
    torch.cuda.synchronize()
    err = max_rel(y, ref64)
    max_abs = float((y.double() - ref64).abs().max().item())
    err32 = max_rel(y, ref32.double())
    print(f"kernel flagship I={I} D={D} O={O} C={CHANNELS} n_win={n_win}: "
          f"max rel err {err:.3e} vs f64 plain (tol {KERNEL_REL_TOL:g}), "
          f"max abs {max_abs:.3e}; {err32:.3e} vs f32 plain model")
    check(err <= KERNEL_REL_TOL, f"flagship kernel rel err {err:.3e}")
    del ref32

    Io, Do, Oo, Co, no = 147, 171, 160, 13, 37
    xo = torch.rand((Co, (no - 1) * Io + Do + 5), generator=g, device=dev)
    xo = xo * 2 - 1
    so = torch.randn((Do, Oo), generator=g, device=dev)
    slo = torch.randn((Do, Oo), generator=g, device=dev) * 2.0**-24
    yo = frac_whole(xo, so, Io, Do, Oo, no, skT_lo=slo)
    ro = frac_whole_ref(xo.double(), so.double(), Io, Do, Oo, no,
                        skT_lo=slo.double())
    yo64 = frac_whole(xo.double(), so.double(), Io, Do, Oo, no,
                      skT_lo=slo.double())
    torch.cuda.synchronize()
    erro, erro64 = max_rel(yo, ro), max_rel(yo64, ro)
    print(f"kernel odd I={Io} D={Do} O={Oo} C={Co} n_win={no} with skT_lo: "
          f"max rel err f32 {erro:.3e} (tol {KERNEL_REL_TOL:g}), "
          f"f64 {erro64:.3e} (tol {F64_REL_TOL:g})")
    check(erro <= KERNEL_REL_TOL, f"odd-geometry kernel rel err {erro:.3e}")
    check(erro64 <= F64_REL_TOL, f"odd-geometry f64 kernel err {erro64:.3e}")

    # 3. main path, counted
    x = torch.rand((CHANNELS, N_IN), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 2 - 1
    frac_whole.launches = 0
    out = rs.oneshot(x)
    torch.cuda.synchronize()
    launches = frac_whole.launches
    out_len = rs.default_out_len(N_IN)
    check(tuple(out.shape) == (CHANNELS, out_len),
          f"oneshot shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "oneshot output not finite")
    check(launches >= 1, "the main path never launched frac_whole")
    rs64 = Resampler(SRC, DST, TB, ATTEN, dtype=torch.float64, device="cpu")
    ref = rs64.oneshot(x[:N_CMP].cpu().double()).numpy()
    skip = int(EDGE_S * DST)
    db = rms_db(out[:N_CMP].cpu().double().numpy()[:, skip:-skip]
                - ref[:, skip:-skip])
    print(f"main path: Resampler({SRC}, {DST}, {TB}, {ATTEN}) f32 fast, "
          f"{CHANNELS} x {N_IN} full-scale uniform (seed {SEED}) -> "
          f"{tuple(out.shape)}; {N_CMP} channels vs port f64 CPU path "
          f"{db:.2f} dB RMS (class {CLASS_DB:g}, {EDGE_S * 1e3:g} ms edge "
          f"skip); frac_whole launches {launches}")
    check(db <= CLASS_DB, f"main path {db:.2f} dB misses {CLASS_DB:g} dB")

    # 4. timing (CUDA events, after warmup)
    one_ms = cuda_ms(lambda: rs.oneshot(x), reps=10)
    mrops = 1e-6 * CHANNELS * N_IN / (one_ms * 1e-3)
    print(f"timing {card}: oneshot {one_ms:.3f} ms = {mrops:.1f} Mrops "
          f"(1e-6 x channels x input samples / s)")
    k_ms = cuda_ms(lambda: frac_whole(xp, ex.skT, I, D, O, n_win), reps=20)
    p_ms = cuda_ms(lambda: frac_whole_ref(xp, ex.skT, I, D, O, n_win),
                   reps=5, warmup=1)
    w = ex.skT.T.contiguous()[:, None, :]
    lib_ms = cuda_ms(lambda: F.conv1d(xp[:, None, :], w, stride=I), reps=10)
    flops = 2.0 * CHANNELS * n_win * D * O
    nbytes = 4.0 * (CHANNELS * L + D * O + CHANNELS * n_win * O)
    bound_ms = max(flops / peak_flops, nbytes / peak_bytes) * 1e3
    bound_by = "operations" if flops / peak_flops >= nbytes / peak_bytes \
        else "bytes"
    print(f"timing {card}: frac_whole kernel {k_ms:.3f} ms "
          f"({flops / k_ms * 1e-9:.1f} TFLOP/s), bound {bound_ms:.3f} ms by "
          f"{bound_by} ({flops:.3e} flop, {nbytes / 1e9:.3f} GB), plain "
          f"frac_whole_ref {p_ms:.3f} ms, cuDNN conv1d (TF32 off) "
          f"{lib_ms:.3f} ms")

    # 5. per-kernel record
    kernels = [{
        "name": "frac_whole", "route": "cuda",
        "source": "r8brain_torch/csrc/frac_whole.cu",
        "replaces": "r8brain_tpu/ops/pallas_frac.py:111",
        "launches": launches, "max_abs_err": max_abs, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
