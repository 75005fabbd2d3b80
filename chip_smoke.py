#!/usr/bin/env python3
"""Smoke test of the r8brain_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, and drives the port's paths through
``Resampler.oneshot`` on 1024 channels x 44100 samples (1 s) of full-scale
uniform float32 input:

* the fast flagship, 44.1 kHz -> 96 kHz ``precision="fast"``, fused, on
  ``frac_whole``; checked at -141 dB against the port's float64 CPU path;
  and the same fused path with ``precision="high"`` (the residual dot);
* the guarantee chain, the same conversion with ``precision="high"``,
  ``conv_engine="ozaki"``, ``frac_engine="ozaki"``: conv and whole-frac
  stages on ``ozaki_framed`` with the df32 inter-stage carry, checked at
  -150 dB; and the same with the carry off (``R8BT_DF_CARRY=0``) at
  -141 dB;
* the df32-FFT guarantee engines, ``precision="high"``, ``fused=False``:
  the same conversion with ``conv_engine="pallas_fft5"`` (the polyphase
  mode of ``df_fft_conv`` at n=4096, then ``frac_whole`` with the operator
  residual), ``"pallas_fft4"`` and ``"pallas_fft"`` (n=8192, head P), and
  96 kHz -> 44.1 kHz with ``"pallas_fft5"`` (framed, n=8192) and at
  ``trans_band=5``, ``atten=136.45`` (n=2048, the reference's unframed
  kernel), and ``"fft"`` (the same kernel as ``"pallas_fft"``), each
  checked at -141 dB;
* the float32 stage chain, ``fused=False``: 44.1 kHz -> 96 kHz with
  ``conv_engine`` ``"auto"`` (the banded operator on ``frac_whole``),
  ``"toeplitz_sym"`` (the folded operators on ``sym_conv``), ``"pallas"``
  (the B=64 mini-Toeplitz on ``frac_whole``) and ``"direct"`` (the
  superkernel on ``frac_whole``), each under ``"fast"`` and ``"high"``, and
  96 kHz -> 44.1 kHz with ``"toeplitz_sym"``, each checked at -141 dB
  under ``"fast"`` (``"direct"`` at -139.97 dB, 1 dB above the reference
  package's own chain on the CPU) and at -143 dB under ``"high"``.

Before the guarantee chain it pins the exactness lemma the split-operand
kernel rests on (a 256-deep tensor-core float32 accumulation of bf16 slice
products is exact); before the FFT engines it holds ``df_fft_conv`` in
every mode and at every size class (one CTA, four-step) to its plain
version; before the stage chains it holds ``sym_conv`` at every conv
spec of the folded engine (float32 fast and high, float64, and the gain
of ``"high"`` against its float64 function) and the scouting GEMM
``dense_gemm`` to their plain versions.  Each path runs
with the launch counts set to 0 just before it and read just after.
Then it times each path, each kernel at the path's shapes, its plain
version and the one PyTorch call that computes the same function.  Every phase prints one line; the line before
the last is the per-kernel JSON record and the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line,
when CUDA is unavailable, a kernel does not build or launch, or any check
fails.  Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED = 0
SRC, DST, TB, ATTEN = 44100, 96000, 2.0, 180.15
CHANNELS, N_IN = 1024, 44100
N_CMP = 4              # channels held against the float64 CPU path
EDGE_S = 0.05          # edge skip of that comparison, seconds
CLASS_DB = -141.0      # the reference's golden-equality class
KERNEL_REL_TOL = 1e-5  # frac_whole (f32) vs frac_whole_ref (f64), max rel err
F64_REL_TOL = 1e-12    # frac_whole (f64) vs frac_whole_ref (f64)
# guarantee chain vs the float64 path, relative to the reference signal's
# RMS: with the df32 carry and without (tests/test_ozaki.py:284)
OZ_CARRY_DB, OZ_NOCARRY_DB = -150.0, -141.0
OZ_KERNEL_DB = -150.0  # ozaki_framed vs the float64 product, relative
# ozaki_framed vs ozaki_framed_ref: bit-equal without x_lo; with x_lo the
# inexact bf16 residual pass (~2^-24 of y) sums in another order, which
# may move the rounding of the collapsed output by one ulp (2^-22 of max
# |y|) and, for the pair's hi + lo, that of the small term (lo + rest)*s +
# cheap, below 2^-5 of max |y|, by one ulp (2^-28): a dropped or
# misplaced x_lo pass (~2^-24) fails it
OZ_LO_REL_TOL, OZ_PAIR_REL_TOL = 2.0**-22, 2.0**-28

# df_fft_conv vs df_fft_conv_ref: both round one float64 convolution to
# float32, so they differ by at most one ulp of the output
FFT_REL_TOL = 2.0**-22
# the FFT engines' paths: (label, src, dst, trans_band, atten,
# conv_engine, expected df_fft_conv launch (mode, n), replaced TPU kernel
# or None where the kernel call is the one of the path before)
FFT_PATHS = (
    ("poly", 44100, 96000, 2.0, 180.15, "pallas_fft5", ("poly", 4096),
     "r8brain_tpu/ops/pallas_dfft5.py:763"),
    ("fft4", 44100, 96000, 2.0, 180.15, "pallas_fft4", ("framed", 8192),
     "r8brain_tpu/ops/pallas_dfft4.py:404"),
    ("fft", 44100, 96000, 2.0, 180.15, "pallas_fft", ("framed", 8192),
     "r8brain_tpu/ops/pallas_dfft.py:269"),
    ("framed5", 96000, 44100, 2.0, 180.15, "pallas_fft5", ("framed", 8192),
     "r8brain_tpu/ops/pallas_dfft5.py:693"),
    ("unframed5", 96000, 44100, 5.0, 136.45, "pallas_fft5",
     ("framed", 2048), "r8brain_tpu/ops/pallas_dfft5.py:623"),
    ("xla_fft", 44100, 96000, 2.0, 180.15, "fft", ("framed", 8192), None))
# df_fft_conv against its plain version at every mode and size class:
# (mode, n, head, C, n_frames), C * n_frames odd outside poly mode
FFT_CASES = ([("frames", n, 0, 5, 3) for n in (512, 1024, 8192, 16384, 65536)]
             + [("framed", n, n // 4, 3, 5) for n in (4096, 8192)]
             + [("poly", n, n // 4, 3, 4) for n in (4096, 8192, 16384)])

# sym_conv vs sym_conv_ref, in ulps of max |y|: the kernel and the
# model's matmuls add each 32-term chunk in their own order
SYM_ULPS = {"float32": 4, "float64": 16}
# precision "high" moves sym_conv's output by about an ulp, inside
# SYM_ULPS, so it is held by its gain: the drop, in dB, of the RMS error
# against the float64 function of "high" (sym_ops_high) from the fast
# output to the high one, on full-mantissa input.  The model gains 0.47 to
# 0.54 dB at every spec (0.28 from the fold errors, 0.2 from the residual
# rows); the kernel's gain must be within SYM_GAIN_TOL_DB of the model's,
# so a kernel missing either part fails
SYM_GAIN_MIN_DB, SYM_GAIN_TOL_DB = 0.3, 0.1
# sym_conv's specs: the first conv stage of each (src, dst, trans_band,
# atten) (tests/test_toeplitz_sym.py's specs and 96k -> 44.1k at tb 5)
SYM_CFGS = ((44100, 96001, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
            (44100, 96000, 2.0, 180.15), (96000, 44100, 5.0, 136.45))
DENSE_REL_TOL = 1e-5  # dense_gemm (f32) vs the float64 product, of max |C|
# the scouting GEMM's shape: the conv stage's Toeplitz product (the
# reference tools' defaults, tools/exp_pallas_gemm.py)
GEMM_M, GEMM_K, GEMM_N, GEMM_HOP = 175104, 704, 512, 256
# the float32 stage chains: (label, src, dst, trans_band, atten,
# conv_engine, precision, {kernel: launches a oneshot}, bound dB).  Under
# "high" the bound is -143 dB, between the fast chains (-142.34 to -142.45
# on the H100) and the high ones (-143.61 to -146.36), so a chain whose
# residual terms were dropped fails
HIGH_CHAIN_DB = -143.0
MATMUL_PATHS = tuple(
    (f"{e}/{p}", 44100, 96000, 2.0, 180.15, e, p, n,
     HIGH_CHAIN_DB if p == "high" else
     -139.97 if e == "direct" else CLASS_DB)
    for e, n in (("auto", {"frac_whole": 2, "sym_conv": 0}),
                 ("toeplitz_sym", {"frac_whole": 1, "sym_conv": 1}),
                 ("pallas", {"frac_whole": 2, "sym_conv": 0}),
                 ("direct", {"frac_whole": 2, "sym_conv": 0}))
    for p in ("fast", "high")) + (
    ("toeplitz_sym/fast 96k", 96000, 44100, 2.0, 180.15, "toeplitz_sym",
     "fast", {"frac_whole": 1, "sym_conv": 1}, CLASS_DB),)
# the paths whose conv-stage kernel call gets a record: label -> (kernel,
# record name)
MATMUL_RECORDS = {
    "auto/fast": ("frac_whole", "frac_whole[toeplitz conv stage]"),
    "toeplitz_sym/fast": ("sym_conv", "sym_conv[44.1k->96k fast]"),
    "toeplitz_sym/high": ("sym_conv", "sym_conv[44.1k->96k high]"),
    "toeplitz_sym/fast 96k": ("sym_conv", "sym_conv[96k->44.1k fast]"),
    "pallas/fast": ("frac_whole", "frac_whole[mini-Toeplitz conv stage]"),
    "direct/fast": ("frac_whole", "frac_whole[direct conv stage]")}

# (fp32 CUDA-core, dense bf16 tensor-core, fp64 tensor-core peak FLOP/s,
# HBM bytes/s) by SKU, at the full power limit (NVIDIA data sheets).  The
# fp64 bound takes the tensor cores' rate, the card's highest for fp64 (an
# FFT can run as small DFT products there); the CUDA cores' is half of it.
# Substring match on the device name.
PEAKS = (("H100 PCIe", 51.2e12, 756e12, 51.2e12, 2.0e12),
         ("H100 NVL", 60.0e12, 835e12, 60.0e12, 3.9e12),
         ("H100", 67.0e12, 989e12, 67.0e12, 3.35e12),
         ("H200", 67.0e12, 989e12, 67.0e12, 4.8e12))


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rms_db(d) -> float:
    """10*log10(mean(d^2)) of an array or tensor (computed where it lies):
    RMS of a difference in dB re full scale."""
    import torch

    d = torch.as_tensor(d).double()
    return float(10.0 * torch.log10(d.square().mean() + 1e-300))


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


def bound(flops: float, nbytes: float, peak_flops: float,
          peak_bytes: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_op, t_by = flops / peak_flops, nbytes / peak_bytes
    return max(t_op, t_by) * 1e3, "operations" if t_op >= t_by else "bytes"


def build_kernels() -> None:
    from r8brain_torch.ops import _cuda

    names = ["frac_whole", "ozaki_framed", "df_fft_conv", "sym_conv",
             "dense_gemm"]
    t0 = time.perf_counter()
    _cuda.build(names)
    print(f"build: {', '.join(names)} {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _cuda.build_logs.get(name, "").splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}")


def fast_path(dev, x, ref, skip, peaks, card):
    """The fast flagship's phases: frac_whole vs its plain version, the
    path itself (counted), its accuracy and timings.  Returns the kernel
    record."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch import Resampler
    from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref

    peak_flops, _bf16, peak_bytes = peaks
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
    print(f"frac_whole flagship I={I} D={D} O={O} C={CHANNELS} "
          f"n_win={n_win}: max rel err {err:.3e} vs f64 plain (tol "
          f"{KERNEL_REL_TOL:g}), max abs {max_abs:.3e}; {err32:.3e} vs f32 "
          f"plain model")
    check(err <= KERNEL_REL_TOL, f"flagship kernel rel err {err:.3e}")
    del ref32, ref64

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
    print(f"frac_whole odd I={Io} D={Do} O={Oo} C={Co} n_win={no} with "
          f"skT_lo: max rel err f32 {erro:.3e} (tol {KERNEL_REL_TOL:g}), "
          f"f64 {erro64:.3e} (tol {F64_REL_TOL:g})")
    check(erro <= KERNEL_REL_TOL, f"odd-geometry kernel rel err {erro:.3e}")
    check(erro64 <= F64_REL_TOL, f"odd-geometry f64 kernel err {erro64:.3e}")

    frac_whole.launches = 0
    out = rs.oneshot(x)
    torch.cuda.synchronize()
    launches = frac_whole.launches
    out_len = rs.default_out_len(N_IN)
    check(tuple(out.shape) == (CHANNELS, out_len),
          f"oneshot shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "oneshot output not finite")
    check(launches >= 1, "the fast path never launched frac_whole")
    db = rms_db(out[:N_CMP].cpu().double().numpy()[:, skip:-skip]
                - ref[:, skip:-skip])
    print(f"fast path: Resampler({SRC}, {DST}, {TB}, {ATTEN}) f32 fast, "
          f"{CHANNELS} x {N_IN} full-scale uniform (seed {SEED}) -> "
          f"{tuple(out.shape)}; {N_CMP} channels vs port f64 CPU path "
          f"{db:.2f} dB RMS (class {CLASS_DB:g}, {EDGE_S * 1e3:g} ms edge "
          f"skip); frac_whole launches {launches}")
    check(db <= CLASS_DB, f"fast path {db:.2f} dB misses {CLASS_DB:g} dB")
    del out

    one_ms = cuda_ms(lambda: rs.oneshot(x), reps=10)
    mrops = 1e-6 * CHANNELS * N_IN / (one_ms * 1e-3)
    print(f"timing {card}: fast oneshot {one_ms:.3f} ms = {mrops:.1f} Mrops "
          f"(1e-6 x channels x input samples / s)")
    k_ms = cuda_ms(lambda: frac_whole(xp, ex.skT, I, D, O, n_win), reps=20)
    p_ms = cuda_ms(lambda: frac_whole_ref(xp, ex.skT, I, D, O, n_win),
                   reps=5, warmup=1)
    w = ex.skT.T.contiguous()[:, None, :]
    lib_ms = cuda_ms(lambda: F.conv1d(xp[:, None, :], w, stride=I), reps=10)
    flops = 2.0 * CHANNELS * n_win * D * O
    nbytes = 4.0 * (CHANNELS * L + D * O + CHANNELS * n_win * O)
    bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bytes)
    print(f"timing {card}: frac_whole kernel {k_ms:.3f} ms "
          f"({flops / k_ms * 1e-9:.1f} TFLOP/s), bound {bound_ms:.3f} ms by "
          f"{bound_by} ({flops:.3e} flop, {nbytes / 1e9:.3f} GB), plain "
          f"frac_whole_ref {p_ms:.3f} ms, cuDNN conv1d (TF32 off) "
          f"{lib_ms:.3f} ms")
    return {"name": "frac_whole", "route": "cuda",
            "source": "r8brain_torch/csrc/frac_whole.cu",
            "replaces": "r8brain_tpu/ops/pallas_frac.py:111",
            "launches": launches, "max_abs_err": max_abs, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def lemma_pin(dev) -> None:
    """The exactness lemma on the card's tensor cores: for every kept
    slice pair (p, q), a 256-deep mma.sync float32 accumulation of bf16
    slices equals the float64 product bit for bit, for worst-case slices
    (all +-256 units, all one sign and random signs), uniform random
    integer slices and the split of Gaussian data."""
    import numpy as np
    import torch

    from r8brain_torch.ops import ozaki
    from r8brain_torch.ops.pallas_ozaki import mma_dot

    rng = np.random.default_rng(SEED)
    K, M, N = ozaki.K0, 64, 64
    xparts, _ = ozaki.split_input(torch.from_numpy(rng.standard_normal((M, K))))
    tparts, _ = ozaki.split_operator_host(rng.standard_normal((K, N)))
    cases = {"all +256": (np.ones((M, K)), np.ones((K, N))),
             "+-256": tuple(rng.choice([-1.0, 1.0], s)
                            for s in ((M, K), (K, N))),
             "random units": tuple(rng.integers(-256, 257, s) / 256.0
                                   for s in ((M, K), (K, N)))}
    n = 0
    for p in range(ozaki.N_PARTS):
        for q in range(ozaki.N_DIAG - p):
            # slice p's grid step is 2^-8(p+1): 256 units = 2^-8p
            grid = {k: (torch.from_numpy(a * 2.0**(-8 * p)).bfloat16(),
                        torch.from_numpy(b * 2.0**(-8 * q)).bfloat16())
                    for k, (a, b) in cases.items()}
            grid["gaussian split"] = (xparts[p], tparts[q])
            for what, (a, b) in grid.items():
                want = a.double() @ b.double()
                got = mma_dot(a.to(dev), b.to(dev)).double().cpu()
                check(torch.equal(got, want),
                      f"lemma pin: mma.sync accumulation inexact at slice "
                      f"pair ({p}, {q}), {what}: max |diff| "
                      f"{(got - want).abs().max().item():.3e}")
                n += 1
    print(f"lemma pin: {n} cases (10 slice pairs x 4 operand kinds, "
          f"{M}x{K} @ {K}x{N}), mma.sync m16n8k16 bf16 -> f32 accumulation "
          f"bit-equal to the f64 product")


def ozaki_case(dev, g, C, L_f, hop, Kcols, n_blocks, parts):
    """Full-scale uniform signal, its per-channel scales, a bf16 residual
    stream at 2^-24 of it, and the float64 products of both."""
    import torch

    from r8brain_torch.ops.framing import _framed_matmul
    from r8brain_torch.ops.ozaki import channel_scale

    L = (n_blocks - 1) * hop + L_f
    xp = torch.rand((C, L), generator=g, device=dev) * 2 - 1
    xl = ((torch.rand((C, L), generator=g, device=dev) * 2 - 1)
          * 2.0**-24).bfloat16()
    T64 = parts.double().sum(dim=0)
    p64 = [_framed_matmul(v.double(), T64, n_blocks, hop).reshape(C, -1)
           for v in (xp, xl)]
    return xp, channel_scale(xp), xl, p64


VARIANTS = ((False, False), (False, True), (True, False), (True, True))


def check_ozaki_variants(label, geo, case, parts):
    """Every (has_lo, emit_pair) variant of ozaki_framed against
    ozaki_framed_ref on the card and against the float64 product.
    Returns {variant: max |kernel - plain|}."""
    import torch

    from r8brain_torch.ops.pallas_ozaki import ozaki_framed, ozaki_framed_ref

    L_f, hop, Kcols, n_blocks = geo
    xp, sx, xl, (p_x, p_l) = case
    errs, dbs = {}, []
    for has_lo, emit in VARIANTS:
        lo = xl if has_lo else None
        args = (xp, sx, parts, L_f, hop, Kcols, n_blocks)
        y = ozaki_framed(*args, x_lo=lo, emit_pair=emit)
        r = ozaki_framed_ref(*args, x_lo=lo, emit_pair=emit)
        torch.cuda.synchronize()
        ys = y if emit else (y,)
        rs = r if emit else (r,)
        yc = sum(t.double() for t in ys)
        rc = sum(t.double() for t in rs)
        err = float((yc - rc).abs().max().item())
        rel = err / float(rc.abs().max().item())
        if has_lo:
            tol = OZ_PAIR_REL_TOL if emit else OZ_LO_REL_TOL
            check(rel <= tol, f"ozaki_framed {label} lo={has_lo} "
                  f"pair={emit}: max rel {rel:.3e} vs plain")
        else:
            check(all(torch.equal(a, b) for a, b in zip(ys, rs)),
                  f"ozaki_framed {label} pair={emit}: not bit-equal to "
                  f"ozaki_framed_ref (max abs {err:.3e})")
        ref = p_x + p_l if has_lo else p_x
        db = rms_db(yc - ref) - rms_db(ref)
        check(db <= OZ_KERNEL_DB, f"ozaki_framed {label} lo={has_lo} "
              f"pair={emit}: {db:.2f} dB vs f64 product")
        errs[(has_lo, emit)] = err
        dbs.append(f"{int(has_lo)}{int(emit)}: {rel:.2e} / {db:.1f} dB")
    C = xp.shape[0]
    print(f"ozaki_framed {label} C={C} L_f={L_f} hop={hop} Kcols={Kcols} "
          f"n_blocks={n_blocks}, variants (has_lo, emit_pair): max rel err "
          f"vs plain / dB vs f64 product: {'; '.join(dbs)} (tol: bit-equal "
          f"without x_lo, {OZ_LO_REL_TOL:.2e} with ({OZ_PAIR_REL_TOL:.2e} "
          f"as a pair); {OZ_KERNEL_DB:g} dB)")
    return errs


def guarantee_chain(dev, x, ref, skip, carry: bool):
    """The guarantee chain on x, counted and held to its bound; returns
    (resampler, ozaki_framed launches by (hop, L_f, Kcols, has_lo,
    emit_pair))."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed

    old = os.environ.get("R8BT_DF_CARRY")
    os.environ["R8BT_DF_CARRY"] = "1" if carry else "0"
    try:
        rs = Resampler(SRC, DST, TB, ATTEN, precision="high",
                       conv_engine="ozaki", frac_engine="ozaki", device=dev)
    finally:
        if old is None:
            del os.environ["R8BT_DF_CARRY"]
        else:
            os.environ["R8BT_DF_CARRY"] = old
    check(rs.df_carry == carry, f"df_carry is {rs.df_carry}, want {carry}")
    ozaki_framed.launches = 0
    ozaki_framed.launches_by.clear()
    out = rs.oneshot(x)
    torch.cuda.synchronize()
    by = dict(ozaki_framed.launches_by)
    out_len = rs.default_out_len(N_IN)
    check(tuple(out.shape) == (CHANNELS, out_len),
          f"guarantee oneshot shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "guarantee output not finite")
    d = out[:N_CMP].cpu().double().numpy()[:, skip:-skip] - ref[:, skip:-skip]
    db_abs = rms_db(d)
    db = db_abs - rms_db(ref[:, skip:-skip])
    bound_db = OZ_CARRY_DB if carry else OZ_NOCARRY_DB
    print(f"guarantee chain, carry {'on' if carry else 'off'}: "
          f"Resampler({SRC}, {DST}, {TB}, {ATTEN}, precision='high', "
          f"conv_engine='ozaki', frac_engine='ozaki') {CHANNELS} x {N_IN} -> "
          f"{tuple(out.shape)}; {N_CMP} channels vs port f64 CPU path "
          f"{db:.2f} dB relative ({db_abs:.2f} dB re full scale; bound "
          f"{bound_db:g} relative, {EDGE_S * 1e3:g} ms edge skip); "
          f"ozaki_framed launches {ozaki_framed.launches} by (hop, L_f, "
          f"Kcols, has_lo, emit_pair) {by}")
    check(db <= bound_db, f"guarantee chain carry={carry}: {db:.2f} dB "
          f"misses {bound_db:g} dB")
    return rs, by


def check_fft_cases(dev) -> None:
    """df_fft_conv in every mode, one-CTA and four-step sizes, odd channel
    and frame counts, on a row-strided input, against df_fft_conv_ref on
    the card."""
    import numpy as np
    import torch

    from r8brain_torch.ops.pallas_dfft import (DfFFTPlan, df_fft_conv,
                                               df_fft_conv_ref)

    rng = np.random.default_rng(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for mode, n, head, C, n_frames in FFT_CASES:
        k = rng.standard_normal(min(701, n // 2))
        ks = (k[0::2], k[1::2]) if mode == "poly" else (k,)
        plan = DfFFTPlan(n, *[np.fft.fft(kk, n) / n for kk in ks]).to(dev)
        L = (n_frames - 1) * (n - head) + n - 7
        u = (torch.rand((C, L + 3), generator=g, device=dev) * 2 - 1)[:, 3:]
        y = df_fft_conv(u, plan, n_frames, head)
        r = df_fft_conv_ref(u, plan, n_frames, head)
        torch.cuda.synchronize()
        rel = max_rel(y, r.double())
        check(rel <= FFT_REL_TOL, f"df_fft_conv {mode} n={n}: max rel err "
              f"{rel:.3e} vs plain")
        worst = max(worst, rel)
    print(f"df_fft_conv: {len(FFT_CASES)} cases (frames n=512..65536, "
          f"framed n=4096/8192, poly n=4096..16384; odd C*n_frames, "
          f"row-strided input) vs df_fft_conv_ref: max rel err {worst:.3e} "
          f"(tol {FFT_REL_TOL:.2e})")


def capture_calls(rs, x, module, names=("df_fft_conv", "frac_whole")):
    """Run rs.oneshot(x) once with the kernel wrappers ``names`` that
    ``module`` calls recorded: the arguments each kernel gets on this
    path."""
    calls = {}
    real = {k: getattr(module, k) for k in names}

    def recorder(k):
        def rec(*args, **kw):
            calls.setdefault(k, (args, kw))
            return real[k](*args, **kw)
        return rec

    try:
        for k in real:
            setattr(module, k, recorder(k))
        rs.oneshot(x)
    finally:
        for k, fn in real.items():
            setattr(module, k, fn)
    return calls


def rfft_conv(u, plan, n_frames: int, head: int):
    """The library route of df_fft_conv's function: the frames in float64
    through ``torch.fft.rfft``, the product by the real kernels' half
    spectra (H_e and H_o in polyphase mode, split out of G = H_e + i*H_o
    by Hermitian symmetry) and one batched ``torch.fft.irfft``.  Returns a
    function of no arguments."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.framing import _frames

    n, C = plan.n, u.shape[0]
    hop, half = n - head, n // 2 + 1
    G = plan.G
    if plan.poly:
        Gm = torch.roll(torch.flip(G, (0,)), 1).conj()  # conj(G[-k mod n])
        Hr = torch.stack([(G + Gm) / 2, (G - Gm) / 2j])[:, :half]
    else:
        Hr = G[None, :half]
    need = (n_frames - 1) * hop + n
    pad = max(0, need - u.shape[1])

    def run():
        up = F.pad(u[:, :need], (0, pad)).double()
        X = torch.fft.rfft(_frames(up, n_frames, hop, n))
        w = torch.fft.irfft(X[:, :, None, :] * Hr, n=n, norm="forward")
        w = w[..., head:].transpose(-1, -2) if plan.poly else w[..., 0, head:]
        return w.reshape(C, -1).float()
    return run


def fft_flops(n: int, f_total: int, poly: bool) -> float:
    """Floating-point operations the function needs: each real frame one
    real-input transform forward (2.5 n log2 n), and for each of its one
    or two kernels (poly) a product with a half spectrum (3n) and one
    real-output inverse (2.5 n log2 n)."""
    n_out = 2 if poly else 1
    return f_total * (2.5 * n * math.log2(n) * (1 + n_out) + 3.0 * n * n_out)


def fft_paths(dev, x, ref, skip, peaks, card):
    """The df32-FFT engines' paths: each counted (launches set to 0 just
    before, read just after), checked at -141 dB against the port's
    float64 CPU path and timed with its kernel calls.  Returns the kernel
    records."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import stages
    from r8brain_torch.ops.pallas_dfft import df_fft_conv, df_fft_conv_ref
    from r8brain_torch.ops.pallas_frac import frac_whole

    peak_f32, peak_f64, peak_bytes = peaks
    refs = {(SRC, DST, TB, ATTEN): (ref, skip)}
    x4 = x[:N_CMP].cpu().double()
    records = []
    for label, src, dst, tb, atten, engine, want, replaces in FFT_PATHS:
        key = (src, dst, tb, atten)
        if key not in refs:
            r64 = Resampler(src, dst, tb, atten, dtype=torch.float64,
                            device="cpu").oneshot(x4).numpy()
            refs[key] = (r64, int(EDGE_S * dst))
        r64, sk = refs[key]
        rs = Resampler(src, dst, tb, atten, precision="high", fused=False,
                       conv_engine=engine, device=dev)
        df_fft_conv.launches = 0
        df_fft_conv.launches_by.clear()
        frac_whole.launches = 0
        out = rs.oneshot(x)
        torch.cuda.synchronize()
        by, n_fw = dict(df_fft_conv.launches_by), frac_whole.launches
        check(tuple(out.shape) == (CHANNELS, rs.default_out_len(N_IN)),
              f"{label} oneshot shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{label} output not finite")
        check(by.get(want, 0) >= 1, f"path {label} never launched "
              f"df_fft_conv {want}: {by}")
        check(n_fw >= 1, f"path {label} never launched frac_whole")
        db = rms_db(out[:N_CMP].cpu().double().numpy()[:, sk:-sk]
                    - r64[:, sk:-sk])
        print(f"fft path {label}: Resampler({src}, {dst}, {tb}, {atten}, "
              f"precision='high', fused=False, conv_engine='{engine}') "
              f"{CHANNELS} x {N_IN} -> {tuple(out.shape)}; {N_CMP} channels "
              f"vs port f64 CPU path {db:.2f} dB re full scale (class "
              f"{CLASS_DB:g}, {EDGE_S * 1e3:g} ms edge skip); df_fft_conv "
              f"launches {by}, frac_whole launches {n_fw}")
        check(db <= CLASS_DB, f"fft path {label}: {db:.2f} dB misses "
              f"{CLASS_DB:g} dB")
        del out
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        print(f"timing {card}: fft path {label} oneshot {one_ms:.3f} ms = "
              f"{1e-6 * CHANNELS * N_IN / (one_ms * 1e-3):.1f} Mrops")
        if replaces is None:
            del rs
            continue

        calls = capture_calls(rs, x, stages)
        (u, plan, n_frames, head), _kw = calls["df_fft_conv"]
        y = df_fft_conv(u, plan, n_frames, head)
        r = df_fft_conv_ref(u, plan, n_frames, head)
        lib = rfft_conv(u, plan, n_frames, head)
        rl = lib()
        torch.cuda.synchronize()
        rel = max_rel(y, r.double())
        rel_lib = max_rel(rl, r.double())
        max_abs = float((y.double() - r.double()).abs().max().item())
        check(rel <= FFT_REL_TOL, f"df_fft_conv at the {label} path's shape: "
              f"max rel err {rel:.3e} vs plain")
        check(rel_lib <= FFT_REL_TOL, f"the rfft route at the {label} "
              f"path's shape: max rel err {rel_lib:.3e} vs plain")
        del rl
        k_ms = cuda_ms(lambda: df_fft_conv(u, plan, n_frames, head), reps=20)
        p_ms = cuda_ms(lambda: df_fft_conv_ref(u, plan, n_frames, head),
                       reps=3, warmup=1)
        lib_ms = cuda_ms(lib, reps=3, warmup=1)
        n = plan.n
        f_total = u.shape[0] * n_frames
        flops = fft_flops(n, f_total, plan.poly)
        span = min(u.shape[1], (n_frames - 1) * (n - head) + n)
        nbytes = 4.0 * u.shape[0] * span + 4.0 * y.numel() + 32.0 * n
        bound_ms, bound_by = bound(flops, nbytes, peak_f64, peak_bytes)
        mode = plan.mode(head)
        print(f"timing {card}: df_fft_conv {label} ({mode}, n={n}, head="
              f"{head}, C={u.shape[0]}, {n_frames} frames a row) kernel "
              f"{k_ms:.3f} ms ({flops / k_ms * 1e-9:.2f} fp64 TFLOP/s of "
              f"real-input work), bound {bound_ms:.3f} ms by {bound_by} "
              f"({flops:.3e} flop over {peak_f64 * 1e-12:g} TFLOP/s, "
              f"{nbytes / 1e9:.3f} GB), plain df_fft_conv_ref (complex128 "
              f"torch.fft) {p_ms:.3f} ms, library route (float64 torch.fft."
              f"rfft / irfft) {lib_ms:.3f} ms; max rel err vs plain "
              f"{rel:.3e}, library route {rel_lib:.3e}")
        records.append({
            "name": f"df_fft_conv[{label}: {mode}, n={n}]", "route": "cuda",
            "source": "r8brain_torch/csrc/df_fft_conv.cu",
            "replaces": replaces, "launches": by.get(want, 0),
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        del y, r, u, lib

        if label == "poly":
            records.append(frac_lo_record(
                "frac_whole[frac stage, skT_lo]", calls["frac_whole"], n_fw,
                peak_f32, peak_bytes, card))
        del calls, rs
        torch.cuda.empty_cache()
    return records


def frac_lo_record(name, call, launches, peak_f32, peak_bytes, card):
    """frac_whole with the operator residual at one path's call: against
    its plain version in float64, timed at the call's fold length and at
    the other one, beside the float32 model and float64 cuDNN conv1d.  The
    bound counts the operator's nonzero entries (a whole-stepping stage's
    operator is banded; the kernel multiplies it dense)."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.pallas_frac import (KC, KC_LO, frac_whole,
                                               frac_whole_ref)

    (xp, skT, I, D, O, n_win), kw = call
    lo, kc = kw["skT_lo"], kw.get("kc", KC)
    y = frac_whole(xp, skT, I, D, O, n_win, skT_lo=lo, kc=kc)
    r64 = frac_whole_ref(xp.double(), skT.double(), I, D, O, n_win,
                         skT_lo=lo.double())
    torch.cuda.synchronize()
    err = max_rel(y, r64)
    max_abs = float((y.double() - r64).abs().max().item())
    check(err <= KERNEL_REL_TOL, f"{name} rel err {err:.3e}")
    del r64, y
    ms = {k: cuda_ms(lambda: frac_whole(xp, skT, I, D, O, n_win, skT_lo=lo,
                                        kc=k), reps=20)
          for k in (KC_LO, KC)}
    p_ms = cuda_ms(lambda: frac_whole_ref(xp, skT, I, D, O, n_win,
                                          skT_lo=lo, kc=kc), reps=3,
                   warmup=1)
    w = (skT.double() + lo.double()).T.contiguous()[:, None, :]
    xp64 = xp.double()[:, None, :]
    lib_ms = cuda_ms(lambda: F.conv1d(xp64, w, stride=I), reps=3, warmup=1)
    del xp64, w
    C = xp.shape[0]
    nnz = int((skT != 0).sum().item()) + int((lo != 0).sum().item())
    flops = 2.0 * C * n_win * nnz
    nbytes = 4.0 * (C * ((n_win - 1) * I + D) + 2 * D * O + C * n_win * O)
    bound_ms, bound_by = bound(flops, nbytes, peak_f32, peak_bytes)
    print(f"timing {card}: {name} I={I} D={D} O={O} C={C} n_win={n_win}, "
          f"fold {kc}: kernel {ms[kc]:.3f} ms (fold {KC_LO}: "
          f"{ms[KC_LO]:.3f} ms, fold {KC}: {ms[KC]:.3f} ms), bound "
          f"{bound_ms:.3f} ms by {bound_by} ({flops:.3e} flop over the "
          f"{nnz} nonzeros of skT and skT_lo, {nbytes / 1e9:.3f} GB), plain "
          f"frac_whole_ref {p_ms:.3f} ms, f64 cuDNN conv1d {lib_ms:.3f} ms; "
          f"max rel err vs f64 plain {err:.3e} (tol {KERNEL_REL_TOL:g})")
    return {"name": name, "route": "cuda",
            "source": "r8brain_torch/csrc/frac_whole.cu",
            "replaces": "r8brain_tpu/ops/pallas_frac.py:111",
            "launches": launches, "max_abs_err": max_abs, "ms": ms[kc],
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def fused_high_path(dev, x, ref, skip, peak_f32, peak_bytes, card):
    """The fused flagship with precision="high" (the residual dot in the
    same kernel): counted, held at -141 dB, timed; returns its kernel
    record."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import fused
    from r8brain_torch.ops.pallas_frac import frac_whole

    rs = Resampler(SRC, DST, TB, ATTEN, precision="high", device=dev)
    frac_whole.launches = 0
    out = rs.oneshot(x)
    torch.cuda.synchronize()
    launches = frac_whole.launches
    check(tuple(out.shape) == (CHANNELS, rs.default_out_len(N_IN)),
          f"fused high oneshot shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "fused high output not finite")
    check(launches >= 1, "the fused high path never launched frac_whole")
    db = rms_db(out[:N_CMP].cpu().double().numpy()[:, skip:-skip]
                - ref[:, skip:-skip])
    print(f"fused high path: Resampler({SRC}, {DST}, {TB}, {ATTEN}, "
          f"precision='high') {CHANNELS} x {N_IN} -> {tuple(out.shape)}; "
          f"{N_CMP} channels vs port f64 CPU path {db:.2f} dB RMS (class "
          f"{CLASS_DB:g}); frac_whole launches {launches}")
    check(db <= CLASS_DB, f"fused high path {db:.2f} dB misses "
          f"{CLASS_DB:g} dB")
    del out
    one_ms = cuda_ms(lambda: rs.oneshot(x), reps=10)
    print(f"timing {card}: fused high oneshot {one_ms:.3f} ms = "
          f"{1e-6 * CHANNELS * N_IN / (one_ms * 1e-3):.1f} Mrops")
    calls = capture_calls(rs, x, fused, ("frac_whole",))
    rec = frac_lo_record("frac_whole[fused, skT_lo]", calls["frac_whole"],
                         launches, peak_f32, peak_bytes, card)
    del calls, rs
    torch.cuda.empty_cache()
    return rec


def ulps_of_max(y, r) -> float:
    """max |y - r| in ulps of max |r| (the ulp of r's dtype at max |r|)."""
    import torch

    m = float(r.abs().max().item())
    bits = 23 if r.dtype == torch.float32 else 52
    ulp = 2.0 ** (math.floor(math.log2(m)) - bits)
    return float((y.double() - r.double()).abs().max().item()) / ulp


def full_mantissa(g, shape, dtype, dev):
    """Uniform [-1, 1) samples drawn in float64 and rounded to ``dtype``.
    float32 ``torch.rand`` gives multiples of 2^-24, whose fold a + r is
    exact, so "high"'s fold errors would be zero."""
    import torch

    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
    return (u * 2 - 1).to(dtype)


def sym_high_gain(label, xp, ops, L_fs, nb, hop, lo, rows):
    """The gain of precision "high" on xp, kernel and model: the drop of
    each one's RMS error against the float64 function of "high" from its
    fast output to its high one, dB re full scale.  Checks that the model gains at least
    SYM_GAIN_MIN_DB and the kernel within SYM_GAIN_TOL_DB of the model;
    returns (kernel gain, model gain, kernel high dB)."""
    from r8brain_torch.ops.pallas_symconv import (sym_conv, sym_conv_ref,
                                                  sym_ops_high)

    want = sym_conv_ref(xp.double(), sym_ops_high(ops, lo, rows), L_fs, nb,
                        hop)
    db = {fn: (rms_db(fn(xp, ops, L_fs, nb, hop) - want),
               rms_db(fn(xp, ops, L_fs, nb, hop, lo, rows) - want))
          for fn in (sym_conv, sym_conv_ref)}
    gk = db[sym_conv][0] - db[sym_conv][1]
    gp = db[sym_conv_ref][0] - db[sym_conv_ref][1]
    check(gp >= SYM_GAIN_MIN_DB, f"sym_conv_ref {label}: 'high' gains "
          f"{gp:.3f} dB, under {SYM_GAIN_MIN_DB} dB")
    check(abs(gk - gp) <= SYM_GAIN_TOL_DB, f"sym_conv {label}: 'high' gains "
          f"{gk:.3f} dB ({db[sym_conv][0]:.3f} -> {db[sym_conv][1]:.3f}), "
          f"the plain model {gp:.3f} dB (tol {SYM_GAIN_TOL_DB} dB)")
    return gk, gp, db[sym_conv][1]


def check_sym_cases(dev) -> None:
    """sym_conv at every conv spec of the folded engine, float32 fast and
    high and float64, C = 13 and 37 frames (no multiple of any tile), on a
    row-strided full-mantissa input, against sym_conv_ref on the card;
    under "high" also its gain (sym_high_gain)."""
    import torch

    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.pallas_symconv import sym_conv, sym_conv_ref
    from r8brain_torch.ops.stages import ConvExec

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, gains = {}, []
    for cfg in SYM_CFGS:
        st = make_plan(*cfg, 0).stages[0]
        for dt, prec in ((torch.float32, "fast"), (torch.float32, "high"),
                         (torch.float64, "fast")):
            ex = ConvExec(st, dt, prec, engine="toeplitz_sym").to(dev)
            C, nb, hop = 13, 37, 256 * st.down
            L = (nb - 1) * hop + max(ex.sym_Lf)
            xp = full_mantissa(g, (C, L + 3), dt, dev)[:, 3:]
            args = (xp, ex.sym_ops, ex.sym_Lf, nb, hop, ex.sym_lo,
                    ex.sym_lo_rows)
            y, r = sym_conv(*args), sym_conv_ref(*args)
            torch.cuda.synchronize()
            u = ulps_of_max(y, r)
            key = str(dt).replace("torch.", "")
            check(u <= SYM_ULPS[key], f"sym_conv {cfg} {key} {prec}: "
                  f"{u:.2f} ulps of max |y| from plain")
            worst[(key, prec)] = max(worst.get((key, prec), 0.0), u)
            if ex.sym_lo is not None:
                gk, gp, _db = sym_high_gain(str(cfg), *args)
                gains.append(f"{gk:.3f}/{gp:.3f}")
    print(f"sym_conv: {len(SYM_CFGS)} conv specs x (f32 fast, f32 high, "
          f"f64), C=13, 37 frames, row-strided full-mantissa input, vs "
          f"sym_conv_ref: max ulps of max |y| {worst} (tol {SYM_ULPS}); "
          f"'high' gain kernel/model dB {', '.join(gains)} (model >= "
          f"{SYM_GAIN_MIN_DB}, kernel within {SYM_GAIN_TOL_DB})")


def check_dense_cases(dev) -> None:
    """dense_gemm at a ragged shape, both M tiles, one K loop and hop
    segments, against the float64 product on the card."""
    import torch

    from r8brain_torch.ops.scout import M_TILES, dense_gemm, dense_gemm_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn((1000, 700), generator=g, device=dev)
    B = torch.randn((700, 130), generator=g, device=dev)
    errs = {}
    for mt in M_TILES:
        for hop in (None, GEMM_HOP):
            c, r = dense_gemm(A, B, mt, hop), dense_gemm_ref(A, B, mt, hop)
            torch.cuda.synchronize()
            errs[(mt, hop)] = max_rel(c, r)
            check(errs[(mt, hop)] <= DENSE_REL_TOL, f"dense_gemm mt={mt} "
                  f"hop={hop}: max rel err {errs[(mt, hop)]:.3e}")
    print(f"dense_gemm 1000x700 @ 700x130 vs the f64 product: max rel err "
          f"by (mt, hop) {errs} (tol {DENSE_REL_TOL:g})")


def conv_library(ex, x_in, n_cyc: int):
    """The one PyTorch call that computes a conv stage's function on its
    input x_in: ``F.conv1d`` of x_in (shifted by s_min) with the
    superkernel rows at stride down, float32, TF32 off ([C, up, n_cyc],
    the phases not interleaved).  Returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.stages import _shifted

    down = ex.spec.down
    xp = _shifted(x_in, ex.s_min, (n_cyc - 1) * down + ex.D_direct,
                  torch.float32)
    w = ex.skT_direct.T.contiguous()[:, None, :]
    return lambda: F.conv1d(xp[:, None, :], w, stride=down)[:, :, :n_cyc]


def matmul_record(label, kernel, name, call, ex, x_in, launches, peaks,
                  card):
    """One conv-stage kernel call of a float32 stage chain (x_in: the
    stage's input): the kernel against its plain version at the path's
    shape, timed beside the plain version and F.conv1d; the bound counts
    the operator's nonzero entries (the dense count printed beside)."""
    import torch

    from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref
    from r8brain_torch.ops.pallas_symconv import sym_conv, sym_conv_ref

    peak_f32, peak_bytes = peaks
    args, kw = call
    xp, C = args[0], args[0].shape[0]
    if kernel == "sym_conv":
        fn, ref = sym_conv, sym_conv_ref
        _xp, ops, L_fs, nb, hop = args[:5]
        lo, rows = kw.get("lo"), kw.get("lo_rows")
        y, r = fn(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        err = ulps_of_max(y, r)
        check(err <= SYM_ULPS["float32"], f"{name}: {err:.2f} ulps of max "
              f"|y| from plain")
        tol = f"{err:.2f} ulps of max |y| (tol {SYM_ULPS['float32']})"
        if lo is not None:
            # the path's input is a multiple of 2^-24 (exact folds): hold
            # the gain at the path's shape on a full-mantissa input
            g = torch.Generator(device=xp.device).manual_seed(SEED)
            gk, gp, db = sym_high_gain(
                name, full_mantissa(g, tuple(xp.shape), xp.dtype, xp.device),
                ops, L_fs, nb, hop, lo, rows)
            tol += (f"; 'high' gain on full-mantissa input {gk:.3f} dB "
                    f"(model {gp:.3f}, tol {SYM_GAIN_TOL_DB}), high "
                    f"{db:.2f} dB re full scale vs its f64 function")
        Hps = [(L + 1) // 2 for L in L_fs]
        nnz = sum(int((ops[j, :, :hp] != 0).sum().item())
                  for j, hp in enumerate(Hps))
        dense = sum(2 * hp * ops.shape[3] for hp in Hps)
        if lo is not None:  # the fold-error dots and the residual rows
            nnz += nnz + int((lo != 0).sum().item())
            dense += dense + sum(n for ph in rows for _r0, n in ph) * \
                ops.shape[3]
        per_frame = 2.0 * C * nb
        span = (nb - 1) * hop + max(L_fs)
        op_bytes = 4.0 * (ops.numel() + (0 if lo is None else lo.numel()))
        n_out = nb * 256 * len(L_fs)
    else:
        fn, ref = frac_whole, frac_whole_ref
        _xp, skT, I, D, O, n_win = args
        lo = kw.get("skT_lo")
        y = fn(*args, **kw)
        r = ref(xp.double(), skT.double(), I, D, O, n_win, skT_lo=None
                if lo is None else lo.double())
        torch.cuda.synchronize()
        err = max_rel(y, r)
        check(err <= KERNEL_REL_TOL, f"{name}: max rel err {err:.3e} vs "
              f"f64 plain")
        tol = f"max rel err {err:.3e} vs f64 plain (tol {KERNEL_REL_TOL:g})"
        nnz = int((skT != 0).sum().item())
        nnz += 0 if lo is None else int((lo != 0).sum().item())
        dense = D * O * (1 if lo is None else 2)
        per_frame = 2.0 * C * n_win
        span = (n_win - 1) * I + D
        op_bytes = 4.0 * skT.numel() * (1 if lo is None else 2)
        n_out = n_win * O
    max_abs = float((y.double() - r.double()).abs().max().item())
    lib = conv_library(ex, x_in, -(-n_out // ex.spec.up))
    if kernel == "frac_whole":
        # the library call's accuracy beside the kernel's, both against
        # the float64 plain version (the direct engine's route choice)
        yl = lib().transpose(1, 2).reshape(C, -1)
        torch.cuda.synchronize()
        tol += (f"; vs f64 plain, RMS dB re full scale: kernel "
                f"{rms_db(y.double() - r):.2f}, F.conv1d "
                f"{rms_db(yl.double() - r):.2f}")
        del yl
    del y, r
    k_ms = cuda_ms(lambda: fn(*args, **kw), reps=10)
    p_ms = cuda_ms(lambda: ref(*args, **kw), reps=2, warmup=1)
    lib_ms = cuda_ms(lib, reps=3, warmup=1)
    flops, dflops = per_frame * nnz, per_frame * dense
    nbytes = 4.0 * C * span + op_bytes + 4.0 * C * n_out
    bound_ms, bound_by = bound(flops, nbytes, peak_f32, peak_bytes)
    dense_ms = bound(dflops, nbytes, peak_f32, peak_bytes)[0]
    print(f"timing {card}: {name} ({label}, C={C}) kernel {k_ms:.3f} ms "
          f"({dflops / k_ms * 1e-9:.1f} TFLOP/s of dense work), bound "
          f"{bound_ms:.3f} ms by {bound_by} ({flops:.3e} flop over the "
          f"operators' {nnz} nonzeros, {nbytes / 1e9:.3f} GB; dense "
          f"{dflops:.3e} flop, {dense_ms:.3f} ms), plain {p_ms:.3f} ms, "
          f"F.conv1d (f32, TF32 off) {lib_ms:.3f} ms; {tol}")
    src = {"sym_conv": "r8brain_torch/csrc/sym_conv.cu",
           "frac_whole": "r8brain_torch/csrc/frac_whole.cu"}[kernel]
    rep = {"sym_conv": "r8brain_tpu/ops/pallas_symconv.py:166",
           "frac_whole": "r8brain_tpu/ops/pallas_frac.py:111"}[kernel]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": max_abs, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def matmul_paths(dev, x, ref, skip, peaks, card):
    """The float32 stage chains (fused=False): each counted (launches set
    to 0 just before, read just after, and held to the engine's counts),
    checked against the port's float64 CPU path and timed; the conv-stage
    kernel call of the paths in MATMUL_RECORDS gets a kernel record."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import stages
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.pallas_symconv import sym_conv

    refs = {(SRC, DST, TB, ATTEN): (ref, skip)}
    x4 = x[:N_CMP].cpu().double()
    counters = {"frac_whole": frac_whole, "sym_conv": sym_conv}
    records = []
    for label, src, dst, tb, atten, engine, prec, want, bound_db in \
            MATMUL_PATHS:
        key = (src, dst, tb, atten)
        if key not in refs:
            r64 = Resampler(src, dst, tb, atten, dtype=torch.float64,
                            device="cpu").oneshot(x4).numpy()
            refs[key] = (r64, int(EDGE_S * dst))
        r64, sk = refs[key]
        rs = Resampler(src, dst, tb, atten, precision=prec, fused=False,
                       conv_engine=engine, device=dev)
        for fn in counters.values():
            fn.launches = 0
        out = rs.oneshot(x)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        check(tuple(out.shape) == (CHANNELS, rs.default_out_len(N_IN)),
              f"{label} oneshot shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{label} output not finite")
        check(got == want, f"path {label} launched {got}, want {want}")
        db = rms_db(out[:N_CMP].cpu().double().numpy()[:, sk:-sk]
                    - r64[:, sk:-sk])
        print(f"matmul path {label}: Resampler({src}, {dst}, {tb}, {atten}, "
              f"precision='{prec}', fused=False, conv_engine='{engine}') "
              f"{CHANNELS} x {N_IN} -> {tuple(out.shape)}; engines "
              f"{[e.engine for e in rs.execs]}; {N_CMP} channels vs port f64 "
              f"CPU path {db:.2f} dB re full scale (bound {bound_db:g}, "
              f"{EDGE_S * 1e3:g} ms edge skip); launches {got}")
        check(db <= bound_db, f"matmul path {label}: {db:.2f} dB misses "
              f"{bound_db:g} dB")
        del out
        reps = 2 if engine == "direct" else 5
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=reps, warmup=1)
        print(f"timing {card}: matmul path {label} oneshot {one_ms:.3f} ms "
              f"= {1e-6 * CHANNELS * N_IN / (one_ms * 1e-3):.1f} Mrops")
        if label in MATMUL_RECORDS:
            kernel, name = MATMUL_RECORDS[label]
            calls = capture_calls(rs, x, stages, (kernel,))
            T = max(N_IN, rs.in_len_for_out(rs.default_out_len(N_IN)))
            x_in = torch.nn.functional.pad(x, (0, T - N_IN))
            records.append(matmul_record(label, kernel, name, calls[kernel],
                                         rs.execs[0], x_in, got[kernel],
                                         peaks, card))
            del calls, x_in
        del rs
        torch.cuda.empty_cache()
    return records


def gemm_records(dev, peaks, card):
    """The scouting GEMM at the conv stage's Toeplitz shape, at both M
    tiles and with hop segments, beside its float64 plain version, float32
    torch.matmul (TF32 off) and the chain's own formulation (the toeplitz
    engine's frac_whole call on the un-materialized frames: C=1024, 171
    blocks at hop 256, L_f = K)."""
    import torch

    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.scout import dense_gemm, dense_gemm_ref

    peak_f32, peak_bytes = peaks
    g = torch.Generator(device=dev).manual_seed(SEED)
    M, K, N = GEMM_M, GEMM_K, GEMM_N
    A = torch.randn((M, K), generator=g, device=dev)
    B = torch.randn((K, N), generator=g, device=dev)
    flops = 2.0 * M * K * N
    nbytes = 4.0 * (M * K + K * N + M * N)
    bound_ms, bound_by = bound(flops, nbytes, peak_f32, peak_bytes)
    lib_ms = cuda_ms(lambda: torch.matmul(A, B), reps=10)
    nb = M // CHANNELS
    xp = torch.randn((CHANNELS, (nb - 1) * GEMM_HOP + K), generator=g,
                     device=dev)
    fw_ms = cuda_ms(lambda: frac_whole(xp, B, GEMM_HOP, K, N, nb), reps=10)
    print(f"timing {card}: GEMM {M}x{K} @ {K}x{N} ({flops:.3e} flop): "
          f"torch.matmul f32 (TF32 off) {lib_ms:.3f} ms "
          f"({flops / lib_ms * 1e-9:.1f} TFLOP/s); frac_whole on the "
          f"un-materialized frames (C={CHANNELS}, {nb} blocks, hop "
          f"{GEMM_HOP}) {fw_ms:.3f} ms ({flops / fw_ms * 1e-9:.1f} TFLOP/s)")
    del xp
    ref = dense_gemm_ref(A, B)
    p_ms = cuda_ms(lambda: dense_gemm_ref(A, B), reps=3, warmup=1)
    records = []
    for mt, hop, rep in ((512, None, "tools/exp_pallas_gemm.py:70"),
                         (176, None, "tools/exp_framed_kernel.py:99"),
                         (512, GEMM_HOP, "tools/exp_framed_kernel.py:99")):
        c = dense_gemm(A, B, mt, hop)
        torch.cuda.synchronize()
        err = max_rel(c, ref)
        check(err <= DENSE_REL_TOL, f"dense_gemm mt={mt} hop={hop} at the "
              f"conv shape: max rel err {err:.3e}")
        max_abs = float((c.double() - ref).abs().max().item())
        del c
        k_ms = cuda_ms(lambda: dense_gemm(A, B, mt, hop), reps=10)
        seg = "" if hop is None else f", K in hop-{hop} segments"
        print(f"timing {card}: dense_gemm mt={mt}{seg}: kernel {k_ms:.3f} "
              f"ms ({flops / k_ms * 1e-9:.1f} TFLOP/s), bound {bound_ms:.3f} "
              f"ms by {bound_by}, plain (f64 torch.matmul) {p_ms:.3f} ms; "
              f"max rel err {err:.3e} (tol {DENSE_REL_TOL:g})")
        records.append({
            "name": f"dense_gemm[mt={mt}{'' if hop is None else ', seg'}]",
            "route": "cuda", "source": "r8brain_torch/csrc/dense_gemm.cu",
            "replaces": rep, "launches": 0, "max_abs_err": max_abs,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
    del A, B, ref
    torch.cuda.empty_cache()
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from r8brain_torch import Resampler
    from r8brain_torch.ops.ozaki import (N_PARTS, framed_cheap,
                                         split_operator_host)
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed, ozaki_framed_ref

    # full fp32 everywhere: TF32 cannot hold the -141 dB class
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(f"device: {name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    peak_f32, peak_bf16, peak_f64, peak_bytes = next(
        (f, h, d, b) for k, f, h, d, b in PEAKS if k in name)

    build_kernels()

    x = torch.rand((CHANNELS, N_IN), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 2 - 1
    rs64 = Resampler(SRC, DST, TB, ATTEN, dtype=torch.float64, device="cpu")
    ref = rs64.oneshot(x[:N_CMP].cpu().double()).numpy()
    skip = int(EDGE_S * DST)

    kernels = [fast_path(dev, x, ref, skip, (peak_f32, peak_bf16, peak_bytes),
                         card),
               fused_high_path(dev, x, ref, skip, peak_f32, peak_bytes, card)]

    # the split-operand kernel: its lemma, then every variant vs plain at
    # the guarantee chain's two geometries and at an odd one
    lemma_pin(dev)
    rs_on, by_on = guarantee_chain(dev, x, ref, skip, carry=True)
    rs_off, by_off = guarantee_chain(dev, x, ref, skip, carry=False)
    conv, frac = rs_on.execs
    T_in = max(N_IN, rs_on.in_len_for_out(rs_on.default_out_len(N_IN)))
    M1 = conv.out_len(T_in)
    geos = {"conv": conv.geometry(M1), "frac": frac.geometry(frac.out_len(M1))}
    parts = {"conv": conv.oz_parts, "frac": frac.oz_parts}
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    t_odd = np.sinc((np.arange(599)[:, None] - 300
                     - rng.standard_normal((1, 100)) * 4) / 8)
    odd_parts = split_operator_host(t_odd)[0].to(dev)
    odd_geo = (599, 301, 100, 9)
    check_ozaki_variants("odd", odd_geo,
                         ozaki_case(dev, g, 13, *odd_geo, odd_parts),
                         odd_parts)
    cases, errs = {}, {}
    for k in ("conv", "frac"):
        cases[k] = ozaki_case(dev, g, CHANNELS, *geos[k], parts[k])
        errs[k] = check_ozaki_variants(f"{k} (guarantee chain shape)",
                                       geos[k], cases[k], parts[k])

    # every path's launches: each stage of each chain went through the kernel
    paths = {  # (stage, emit_pair): (run, replaced TPU kernel)
        ("conv", True): (by_on, "pallas_ozaki.py:263"),
        ("frac", True): (by_on, "pallas_ozaki.py:207"),
        ("conv", False): (by_off, "pallas_ozaki.py:317"),
        ("frac", False): (by_off, "pallas_ozaki.py:232")}
    launches = {}
    for (k, emit), (by, _r) in paths.items():
        L_f, hop, Kcols, _nb = geos[k]
        launches[(k, emit)] = by.get((hop, L_f, Kcols, False, emit), 0)
        check(launches[(k, emit)] >= 1,
              f"the guarantee chain (carry {'on' if emit else 'off'}) never "
              f"launched ozaki_framed at the {k} stage")

    # timing
    for carry, rs in ((True, rs_on), (False, rs_off)):
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        print(f"timing {card}: guarantee oneshot carry "
              f"{'on' if carry else 'off'} {one_ms:.3f} ms = "
              f"{1e-6 * CHANNELS * N_IN / (one_ms * 1e-3):.1f} Mrops")
    for k in ("conv", "frac"):
        L_f, hop, Kcols, nb = geos[k]
        xp, sx, xl, _p = cases[k]
        args = (xp, sx, parts[k], L_f, hop, Kcols, nb)
        w = parts[k].double().sum(dim=0).T.contiguous()[:, None, :]
        xp64 = xp.double()[:, None, :]
        lib_ms = cuda_ms(lambda: F.conv1d(xp64, w, stride=hop), reps=3,
                         warmup=1)
        del xp64
        for emit in (True, False):
            k_ms = cuda_ms(lambda: ozaki_framed(*args, emit_pair=emit),
                           reps=10)
            p_ms = cuda_ms(lambda: ozaki_framed_ref(*args, emit_pair=emit),
                           reps=2, warmup=1)
            # the operator is banded: the bound counts the slice products
            # of its nonzero entries only (the kernel multiplies it dense)
            C = xp.shape[0]
            nnz = int((parts[k] != 0).any(dim=0).sum().item())
            flops = 10 * 2.0 * C * nb * nnz
            dense = 10 * 2.0 * C * nb * L_f * Kcols
            nbytes = (4.0 * xp.numel() + 4 * C + 2 * N_PARTS * nnz
                      + (4.0 + 2 * emit) * C * nb * Kcols)
            bound_ms, bound_by = bound(flops, nbytes, peak_bf16, peak_bytes)
            print(f"timing {card}: ozaki_framed {k} emit_pair={emit} kernel "
                  f"{k_ms:.3f} ms ({dense / k_ms * 1e-9:.1f} bf16 TFLOP/s of "
                  f"dense slice products), bound {bound_ms:.3f} ms by "
                  f"{bound_by} ({flops:.3e} flop over the operator's {nnz} "
                  f"nonzeros of {L_f * Kcols}, {nbytes / 1e9:.3f} GB; dense "
                  f"operator {dense:.3e} flop, "
                  f"{bound(dense, nbytes, peak_bf16, peak_bytes)[0]:.3f} ms), "
                  f"plain ozaki_framed_ref {p_ms:.3f} ms, f64 cuDNN conv1d "
                  f"{lib_ms:.3f} ms")
            rep = paths[(k, emit)][1]
            kernels.append({
                "name": f"ozaki_framed[{k}, emit_pair={int(emit)}]",
                "route": "cuda", "source": "r8brain_torch/csrc/ozaki_framed.cu",
                "replaces": f"r8brain_tpu/ops/{rep}",
                "launches": launches[(k, emit)],
                "max_abs_err": errs[k][(False, emit)], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms})
    L_f, hop, Kcols, nb = geos["frac"]
    xl = cases["frac"][2]
    c_ms = cuda_ms(lambda: framed_cheap(xl, parts["frac"][0], nb, hop),
                   reps=10)
    print(f"timing {card}: framed_cheap (the frac stage's x_lo pass, plain "
          f"PyTorch) {c_ms:.3f} ms")
    del cases, rs_on, rs_off
    torch.cuda.empty_cache()

    # the df32-FFT engines: the kernel at every mode and size, then each
    # path counted, checked and timed with its kernels
    check_fft_cases(dev)
    kernels += fft_paths(dev, x, ref, skip, (peak_f32, peak_f64, peak_bytes),
                         card)

    # the float32 stage chains: the folded kernel and the scouting GEMM
    # against their plain versions, then each chain counted, checked and
    # timed with its conv-stage kernel call; then the scouting GEMM
    check_sym_cases(dev)
    check_dense_cases(dev)
    kernels += matmul_paths(dev, x, ref, skip, (peak_f32, peak_bytes), card)
    kernels += gemm_records(dev, (peak_f32, peak_bytes), card)

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
