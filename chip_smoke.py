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
* the guarantee chain, the same conversion with ``precision="high"``,
  ``conv_engine="ozaki"``, ``frac_engine="ozaki"``: conv and whole-frac
  stages on ``ozaki_framed`` with the df32 inter-stage carry, checked at
  -150 dB; and the same with the carry off (``R8BT_DF_CARRY=0``) at
  -141 dB.

Before the guarantee chain it pins the exactness lemma the split-operand
kernel rests on (a 256-deep tensor-core float32 accumulation of bf16 slice
products is exact).  Each path runs with the launch counts set to 0 just
before it and read just after.  Then it times each path, each kernel at
the path's shapes, its plain version and the one PyTorch call that
computes the same function.  Every phase prints one line; the line before
the last is the per-kernel JSON record and the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line,
when CUDA is unavailable, a kernel does not build or launch, or any check
fails.  Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
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

# (fp32 CUDA-core, dense bf16 tensor-core peak FLOP/s, HBM bytes/s) by SKU,
# at the full power limit (NVIDIA data sheets).  Substring match on the
# device name.
PEAKS = (("H100 PCIe", 51.2e12, 756e12, 2.0e12),
         ("H100 NVL", 60.0e12, 835e12, 3.9e12),
         ("H100", 67.0e12, 989e12, 3.35e12),
         ("H200", 67.0e12, 989e12, 4.8e12))


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

    names = ["frac_whole", "ozaki_framed"]
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
    peak_f32, peak_bf16, peak_bytes = next(
        (f, h, b) for k, f, h, b in PEAKS if k in name)

    build_kernels()

    x = torch.rand((CHANNELS, N_IN), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 2 - 1
    rs64 = Resampler(SRC, DST, TB, ATTEN, dtype=torch.float64, device="cpu")
    ref = rs64.oneshot(x[:N_CMP].cpu().double()).numpy()
    skip = int(EDGE_S * DST)

    kernels = [fast_path(dev, x, ref, skip, (peak_f32, peak_bf16, peak_bytes),
                         card)]

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
