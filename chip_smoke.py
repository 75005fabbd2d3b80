#!/usr/bin/env python3
"""Smoke test of the r8brain_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, and drives the port's paths through
``Resampler.oneshot`` on 1024 channels x 44100 samples (1 s) of full-scale
uniform float32 input:

* the fast flagship, 44.1 kHz -> 96 kHz ``precision="fast"``, fused, on
  ``frac_whole`` (the exact three-slice bf16 split on the tensor cores);
  checked at -141 dB against the port's float64 CPU path; and the same
  fused path with ``precision="high"`` (the residual slice);
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
  ``"toeplitz_sym"`` (the folded operators on ``sym_conv``, the same
  bf16 split on the tensor cores), ``"pallas"``
  (the B=64 mini-Toeplitz on ``frac_whole``) and ``"direct"`` (the
  superkernel on ``frac_whole``), each under ``"fast"`` and ``"high"``, and
  96 kHz -> 44.1 kHz with ``"toeplitz_sym"``, each checked at -141 dB
  under ``"fast"`` (``"direct"`` at -139.97 dB, 1 dB above the reference
  package's own chain on the CPU) and at -143 dB under ``"high"``;
* the half-band, cascade and polynomial plans with the default engines,
  on 1024 channels x 1 s of the source rate (0.25 s at 2.8224 MHz):
  44.1 kHz -> 192 kHz (fused pair, conv stage, half-band upsampler) fast
  and high, 192 kHz -> 44.1 kHz (half-band decimator, fused pair), PCM ->
  DSD64 44.1 kHz -> 2.8224 MHz (conv stage, the five half-band upsamplers
  as one cascade: ``frac_whole`` at O = 4096; its device memory peak
  held under 40 GB), SACD -> PCM 2.8224 MHz -> 96 kHz (three half-band
  decimators, fused pair) and 44.1 kHz -> 96001 Hz (conv, polynomial
  interpolator, conv) fast (the interpolator on ``poly_dot``, held to its
  plain version and to the banded contraction, timed beside its bound;
  again with TF32 on: bit-equal) and high (on ``torch.matmul`` in IEEE
  float32), each checked at -141 dB ("fast")
  or -143 dB ("high"); and their guarantee chains (44.1 kHz -> 192 kHz,
  44.1 kHz -> 96001 Hz, 192 kHz -> 44.1 kHz) with the carry on and off,
  at -150 and -141 dB.  Every kernel call shape these paths make that no
  earlier phase recorded is held to its plain version (``frac_whole`` in
  channel chunks against its model and its float64 product;
  ``ozaki_framed`` in every variant at each new geometry, the half-band
  ones among them) and gets a record;
* the functional transform ``resample_fn`` on 1024 channels x 1 s: the
  fast flagship, the ozaki guarantee chain (its gradient through the
  default-engine twin) and 44.1 kHz -> 96001 Hz (through the polynomial
  stage), each forward bit-equal to ``oneshot``, ``torch.func.grad`` of
  <w, f(x)> counted (the backward's launches are ``frac_whole``'s
  adjoint) and held at -130 dB relative to the float64 CPU gradient
  (the twin's also at -120 dB relative to its default chain's), the
  dot-product identity <w, f(x)> = <g, x> in float64, forward and
  forward + backward timed, and every adjoint call shape held to its
  plain model with a record;
* ``fused=True`` (the flagship with ``conv_engine="pallas"`` and with
  the ozaki engines) and ``fused="poly"`` (44.1 kHz -> 96001 Hz fast and
  high: ``FusedPolyExec``, its composite summed in float64), checked at
  -141 / -143 dB against the float64 CPU path and timed beside the
  default chain;
* the push-mode streams (``StreamResampler``) at the serving size of
  ``tools/bench_stream.py``, 1024 channels and ``block_len=8192``, each
  driven per block and in calls of 8 blocks: 44.1 kHz -> 96 kHz fast
  and its guarantee chain (-150 dB relative), each k-block output held
  bit-equal to the per-block output, 44.1 kHz -> 96001 Hz fast and high
  (the interpolator with one window base a block, and in spans of its
  groups a k-block call; a mid-stream checkpoint resumed bit for bit),
  44.1 kHz -> 352800.3 Hz fast and high (the suffix ring and its
  half-band stage; a chain of four executors, so its conv stages fold
  every 16 terms) and 44.1 kHz -> 96 kHz on the df32-FFT engine
  ``pallas_fft5`` (``df_fft_conv`` on each block), each checked against
  the float64 CPU path at -141 / -143 dB, every new kernel call shape (a
  block's window of H + L samples, the k windows as one [k*C, H+L]
  batch) held to its plain version with a record, the steady calls
  timed (ms a block, Mrops, real-time streams, the device's idle share);
  then ``oneshot(max_chunk=44100)`` on 30 s of 44.1 kHz -> 96001 Hz with
  its device memory peak.
* channel x time-block sharding (``r8brain_torch/parallel``): the fast
  flagship over the in-process mesh ch2 x t2 (each shard's fused pair on
  ``frac_whole``, one launch a shard), held at -125 dB against the
  unsharded oneshot on the card and at -141 dB against the float64 CPU
  path; the guarantee chain (ozaki engines, df32 carry inside each
  shard's chain) over ch2 x t2, -150 dB relative against the float64
  path, ``ozaki_framed`` twice a shard; its sharded stream (ch2 x t2,
  ``seg_len`` 8192, 16 calls, each call timed); 44.1 kHz -> 96001 Hz over t4 (the polynomial split chain,
  its gather-dot summed in df32 under ``"high"``: -141 dB re full scale;
  ``"fast"`` held to the reference's -115 dB relative); two processes on
  the card over gloo (mesh t2, the halos through pinned host buffers; a
  child that fails or outlives its time limit fails the run); and the
  port's ``dryrun_multichip(4)`` (the df32-FFT chain on ``df_fft_conv``).
  Every new kernel call shape of these runs is held to its plain version
  and gets a record.  The kernels are built before the two processes
  start, so they load the built libraries.
* the WAV converter (``r8brain_torch.cli.main``, in this process) on a
  300 s stereo 24-bit master written by the port's ``write_wav``
  (band-limited noise plus a sine, nothing clipping): 44.1 kHz -> 96 kHz
  whole-file ``"high"`` as float64 and as 24-bit PCM (the 24-bit file
  equal to the float64 run's samples through the same encoder),
  ``--stream``, ``--max-chunk 1048576`` and ``"fast"``; then a 96 kHz
  master to 44.1 kHz ``"high"``.  Each held at -141 dB re full scale
  against ``--precision native`` (the shared C++ engine in float64,
  built on the host while the kernels build; a failed build fails the
  phase), its frame count against floor(frames * dst / src), its wall
  time and ``--bench`` Mrops printed, ``frac_whole``'s launches counted
  and every new call shape (two rows of 13-29 M samples, the stream's
  and the chunks' windows) held to its plain version with a record;
  the whole-file conversion's parts (WAV decode, host design, copies,
  the chain, encode) timed apart.
* the acceptance layer (``tools/torch_*.py``): the differential fuzzer's
  first 64 draws (one channel of 2500-6000 samples each, random plans of
  the reference fuzzer's four ratio families, atten 49-218 dB, tb
  0.75-12, 15 % minimum phase) through every executor (the float64
  oracle, float32 fast, the guarantee chain, the stream at block_len
  2048 in random chunks, the native engine, "high", ``pallas_fft5`` and
  ``toeplitz_sym``), every pair held to its bound, every launch counted
  and every kernel call recorded; the fuzzer's pins and class pins; the
  quick float32 zerotest (62 ratios, n 12000, -135 dB band-limited); the
  fractional bank's SNR; the serving latency curve (1024 channels, block
  lengths 256 to 8192, 44.1 kHz -> 96 kHz and -> 96001 Hz); then every
  call shape of the sweep held to its kernel's plain version and each
  kernel's smallest shape timed beside its plain version and library
  call.
* the accuracy grid of the benchmark matrix (``ACCURACY_RUNS`` of
  ``tools/torch_bench_matrix.py``, the reference matrix's grid) but the
  rows an earlier phase runs: attenuation 109.56 / 136.45 / 218, tb 0.5
  and 45, minimum phase, 96 kHz -> 44.1 kHz at 218 dB, 44.1 kHz -> 48 kHz
  (at 180.15 and 136.45 dB), 44.1 kHz -> 96001 Hz at 136.45 and 218 dB,
  and both DSD64 directions, through ``tools/torch_chip_accuracy.py`` at
  its sizes (4 x 0.5 s; DSD 2 x 0.25 s and 2 x 0.05 s) with each row's
  configurations (fast, high, ozaki; fast and ozaki on the DSD rows),
  every cell printed and held to its class re full scale against the
  float64 oracle (-141 dB; the guarantee chain -150), the launches
  counted, every call shape held to its plain version and ``frac_whole``
  recorded at the grid's three new fused shapes (D = 3155, 2204, 2330).

First it pins how the tensor cores add bf16 products into float32
(``accumulation_pin``: 16- and 32-term sums through ``frac_whole``'s own
wgmma chain): exactly where the products lie on one grid, and within the
bound of a truncating float32 sum, with a census of the rounding, on the
floating slices of real data), and
holds every ``frac_whole`` call to its plain model (within 2^-21 of max
|y|), to its float64 product and, at 10^5 outputs or more, to no bias of
its own (``frac_beta``: beta within 0.02 of its model's; on
full-mantissa input at the flagship, HB-up, toeplitz and direct calls
within 0.02 of 0, ``check_frac_beta``), its band walk bit-equal to the
full walk at the fused flagship fast and "high", both toeplitz convs of
44.1k -> 96001, the half-band up and down stages, the direct stage and a
stream block, timed beside it (``check_frac_band``), and the residual
slice of each ``"high"`` call's shape (fused,
frac stage, ``direct``) with a planted ``skT_lo`` large enough that a
kernel which drops or misplaces the slice fails (``check_residual``).
Before the guarantee chain it pins the exactness lemma the
split-operand kernel rests on (a 256-deep tensor-core float32
accumulation of bf16 slice products is exact), on the kernel's own wgmma
path and on mma.sync; before the FFT engines it holds ``df_fft_conv`` in
every mode and at every size class (one CTA, four-step) to its plain
version; before the stage chains it holds ``sym_conv`` at every conv
spec of the folded engine (float32 fast and high on the tensor cores,
float64, the gain of ``"high"`` against its float64 function, and a
packing of another tiling refused) and the scouting GEMM ``dense_gemm``
(the TPU's HIGHEST dot as a three-slice bf16 split on the tensor cores)
to their plain versions.  Each path runs
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
# frac_whole (f32) vs its plain model frac_whole_ref (f32), of max |y|: the
# big-pair fold sums are exact in both, but the tensor cores add the small
# pairs into lo in their own order, truncated
MODEL_REL_TOL = 2.0**-21
# frac_whole's float32 error against its float64 function has no sign of
# its own: beta = mean(e * sign(y64)) / rms(e) (tensor cores truncating
# its big-pair fold sums read -0.40 to -0.50).  At every call of at least
# FRAC_BETA_MIN_N outputs the kernel's beta is held within FRAC_BETA_MAX
# of its plain model's (the kernel adds no bias of its own; the model's
# arithmetic may have a little on a given input and operator: +0.027 at
# the accuracy grid's 44.1k -> 96001 second conv, 4 rows), and on
# full-mantissa input at the flagship, HB-up and toeplitz calls within
# FRAC_BETA_MAX of 0 (check_frac_beta)
FRAC_BETA_MAX, FRAC_BETA_MIN_N = 0.02, 10**5
F64_REL_TOL = 1e-12    # frac_whole (f64) vs frac_whole_ref (f64)
# frac_whole's residual slice x0*bf16(skT_lo): the real residual moves y by
# ~2^-25 of its size, inside MODEL_REL_TOL, so it is held at each "high"
# call's shape with an skT_lo planted at RESIDUAL_SCALE of the call's
# operator: that moves the model by at least RESIDUAL_MOVE * MODEL_REL_TOL
# of max |y|, and the kernel's own contribution (with the slice minus
# without) must match the model's within RESIDUAL_REL_TOL of it.  The
# 8-column tile's ride-along pairs x1*skT_lo stay ~2^-24 of y
RESIDUAL_SCALE, RESIDUAL_MOVE, RESIDUAL_REL_TOL = 2.0**-15, 8.0, 0.25
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
# df_fft_conv against its plain version in every mode at every size of
# the register-resident kernel (128 .. 8192) and at the four-step sizes:
# (mode, n, head, C, n_frames), C * n_frames odd outside poly mode
FFT_CASES = ([(mode, 1 << b, 0 if mode == "frames" else (1 << b) // 4,
               *((3, 4) if mode == "poly" else (5, 3)))
              for b in range(7, 14) for mode in ("frames", "framed", "poly")]
             + [("frames", n, 0, 5, 3) for n in (16384, 65536)]
             + [("poly", 16384, 4096, 3, 4)])

# sym_conv vs sym_conv_ref, in ulps of max |y|: float32, the big pair's
# step sums are exact in both (their lead slices on fixed grids), but the
# small pairs and lo add in their own order (frac_whole's MODEL_REL_TOL);
# float64, the FMA kernel and the model's matmuls add the terms in their
# own order
SYM_ULPS = {"float32": 4, "float64": 16}
# precision "high" moves sym_conv's output by about an ulp, inside
# SYM_ULPS, so it is held by its gain: the drop, in dB, of the RMS error
# against the float64 function of "high" (sym_ops_high) from the fast
# output to the high one, on full-mantissa input.  The split model gains
# 2.5 to 3.5 dB at every spec; the kernel's gain must be within
# SYM_GAIN_TOL_DB of the model's, so a kernel missing either part fails
SYM_GAIN_MIN_DB, SYM_GAIN_TOL_DB = 0.3, 0.1
# sym_conv's float32 error against its own float64 function has no sign
# of its own: |beta| = |mean(e * sign(y64)) / rms(e)| at most this (its
# big-pair step sums are exact; tensor cores truncating them read -0.21
# to -0.30)
SYM_BETA_MAX = 0.02
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
# the paths whose conv-stage frac_whole call gets the residual check (the
# 8-column tile's residual slice; the fused and frac-stage calls get it
# with their records)
RESIDUAL_PATHS = ("direct/high",)

# the half-band, cascade and polynomial paths (default engines): (label,
# src, dst, seconds of input, precision, frac_whole launches a oneshot,
# poly_dot launches a oneshot, bound dB re full scale)
STAGE_PATHS = (
    ("44.1k->192k fast", 44100, 192000, 1.0, "fast", 3, 0, CLASS_DB),
    ("44.1k->192k high", 44100, 192000, 1.0, "high", 3, 0, HIGH_CHAIN_DB),
    ("192k->44.1k fast", 192000, 44100, 1.0, "fast", 2, 0, CLASS_DB),
    ("44.1k->2.8224M fast", 44100, 2822400, 1.0, "fast", 2, 0, CLASS_DB),
    ("2.8224M->96k fast", 2822400, 96000, 0.25, "fast", 4, 0, CLASS_DB),
    ("44.1k->96001 fast", 44100, 96001, 1.0, "fast", 2, 1, CLASS_DB),
    ("44.1k->96001 high", 44100, 96001, 1.0, "high", 2, 0, HIGH_CHAIN_DB))
# the guarantee chains of those plans: (label, src, dst), each with the
# df32 carry on and off
OZ_PATHS = (("44.1k->192k", 44100, 192000), ("44.1k->96001", 44100, 96001),
            ("192k->44.1k", 192000, 44100))
# frac_whole and ozaki_framed call shapes whose records come from earlier
# phases: (I, D, O, slices, fold) and (hop, L_f, Kcols)
FRAC_SHAPES_SEEN = {(294, 1027, 640, 3, 32), (294, 1027, 640, 4, 32),
                    (256, 964, 512, 3, 32)}
OZ_GEOS_SEEN = {(256, 964, 512), (147, 170, 160)}
PEAK_GB = 40.0  # device memory a path may take (PCM -> DSD64: 11.6 GB out)

# the push-mode stream phases (tools/bench_stream.py's serving size):
# 1024 channels, block_len 8192, k blocks a batched call; each stream
# drives STREAM_CALLS k-block calls, or as many single blocks, then the
# steady calls are timed.  (label, src, dst, Resampler keywords, bound dB,
# bound relative to the output's RMS (else re full scale), interpolator
# paths the k-block calls must take)
STREAM_BLOCK, STREAM_K, STREAM_CALLS = 8192, 8, 2
STREAM_PATHS = (
    ("44.1k->96k fast", 44100, 96000, {}, CLASS_DB, False, None),
    ("44.1k->96k guarantee", 44100, 96000,
     dict(precision="high", conv_engine="ozaki", frac_engine="ozaki"),
     OZ_CARRY_DB, True, None),
    ("44.1k->96001 fast", 44100, 96001, {}, CLASS_DB, False, "spans"),
    ("44.1k->96001 high", 44100, 96001, dict(precision="high"),
     HIGH_CHAIN_DB, False, "spans"),
    ("44.1k->352800.3 fast", 44100, 352800.3, {}, CLASS_DB, False,
     "spans"),
    ("44.1k->352800.3 high", 44100, 352800.3, dict(precision="high"),
     HIGH_CHAIN_DB, False, "spans"),
    ("44.1k->96k pallas_fft5", 44100, 96000,
     dict(precision="high", fused=False, conv_engine="pallas_fft5"),
     CLASS_DB, False, None))
# the TPU kernel that a stream's df_fft_conv call of each mode replaces
FFT_REPLACES = {"poly": "r8brain_tpu/ops/pallas_dfft5.py:763",
                "framed": "r8brain_tpu/ops/pallas_dfft5.py:693",
                "frames": "r8brain_tpu/ops/pallas_dfft5.py:623"}
# the chunked oneshot: seconds of input, max_chunk, channels held against
# the float64 CPU path over the whole length
CHUNKED_S, CHUNKED_MAX, CHUNKED_CMP = 30, 44100, 1

# the functional transform (resample_fn): the card's gradient against the
# float64 CPU gradient, relative to its RMS; a twin chain's gradient
# against the default chain's, relative; the dot-product identity <w,
# f(x)> = <g, x> in float64, relative to sum |w * f(x)| (the float32
# roundings of f(x) and g leave ~1e-11 of it; a wrong adjoint, ~1e-4)
GRAD_DB, TWIN_GRAD_DB, DOT_REL_TOL = -130.0, -120.0, 1e-9
# the functional phases: (label, src, dst, Resampler keywords, the
# keywords of the default chain whose gradient a twin chain's is held to,
# or None for a chain that differentiates through its own kernels)
FUNC_PATHS = (
    ("flagship fast", SRC, DST, {}, None),
    ("ozaki guarantee", SRC, DST,
     dict(precision="high", conv_engine="ozaki", frac_engine="ozaki"),
     dict(precision="high")),
    ("44.1k->96001 fast", 44100, 96001, {}, None))
# fused=True with the ozaki engines: the fused "high" operator (skT_lo)
# replaces the guarantee chain, as in the reference, and holds -150 dB re
# full scale, which the "fast" fused pair (no skT_lo) misses
FUSED_OZAKI_DB = -150.0
# fused=True (the pair fused whatever the engines) and fused="poly" at
# 44.1k -> 96001: (label, src, dst, Resampler keywords, bound dB re full
# scale, executors)
# the sharding phases: sharded against the unsharded oneshot on the card,
# float32 (tests/test_sharding_f32.py:24); the polynomial split chain's
# "fast" bound against the float64 path, relative
# (tests/test_sharding.py:131); the sharded stream's segment and calls;
# the two processes' time limit, seconds
SHARD_PARITY_DB = -125.0
SHARD_POLY_FAST_DB = -115.0
SHARD_SEG, SHARD_CALLS = 8192, 16
SHARD_PROC_TIMEOUT = 300
# the TPU kernel a sharded path's df_fft_conv call replaces ("fft" makes
# the call of pallas_fft)
SHARD_FFT_REPLACES = "r8brain_tpu/ops/pallas_dfft.py:269"
# the CLI phase: a stereo 24-bit master of CLI_SECONDS at each source rate
# (band-limited noise to CLI_BAND Hz plus a CLI_TONE Hz sine, each at
# CLI_PEAK peak, so that neither the file nor the resampler's overshoot
# clips), converted by r8brain_torch.cli.main; the outputs held against
# the native float64 engine's at CLASS_DB re full scale past EDGE_S
CLI_SECONDS, CLI_BAND, CLI_TONE, CLI_PEAK = 300, 20000.0, 997.0, 0.45
# the acceptance phase: the differential fuzzer's first ACC_TRIALS draws
# with every executor (tools/torch_fuzz.py; one channel of 2500-6000
# samples, the reference's sizes), its pins, the quick f32 zerotest (62
# ratios, n 12000), the fractional bank's SNR, and the serving latency
# curve (1024 channels) on a rational and a polynomial plan
ACC_TRIALS = 64
LAT_CHANNELS, LAT_BLOCKS, LAT_ITERS = 1024, (256, 1024, 4096, 8192), 16
LAT_DSTS = (96000, 96001)
# the kernels whose every call shape the sweep holds to its plain version:
# kernel -> the modules that call it
ACC_KERNELS = {"frac_whole": ("operators",), "ozaki_framed": ("operators",),
               "df_fft_conv": ("stages",), "sym_conv": ("stages",)}
# the accuracy-grid phase: the rows of tools/torch_bench_matrix.py's
# ACCURACY_RUNS (the reference matrix's grid) that no earlier phase runs
# (the flagship, 44.1k -> 96001 and 96k -> 44.1k at 180.15 dB run above),
# through tools/torch_chip_accuracy.py at its sizes (4 x 0.5 s; the DSD
# rows 2 x 0.25 s and 2 x 0.05 s), each configuration held to its class
# re full scale against the float64 oracle (torch_chip_accuracy.CLASS_DB)
GRID_SKIP = ("acc_flagship", "acc_poly", "acc_down")
# the kernels the grid launches (its rows run no df32-FFT configuration:
# those are the flagship row's, which fft_paths runs)
GRID_KERNELS = ("frac_whole", "ozaki_framed")
# the fused frac_whole shapes of the grid that get a record, by D: tb 0.5
# (I=294, O=640), 96k -> 44.1k at 218 dB (I=320, O=147), the SACD fused
# stage (I=147, O=40, 2 rows)
GRID_FRAC_D = (3155, 2204, 2330)
FUSED_PATHS = (
    ("fused=True pallas", SRC, DST, dict(fused=True, conv_engine="pallas"),
     CLASS_DB, ["FusedUpExec"]),
    ("fused=True ozaki", SRC, DST,
     dict(fused=True, precision="high", conv_engine="ozaki",
          frac_engine="ozaki"), FUSED_OZAKI_DB, ["FusedUpExec"]),
    ("fused=poly fast", 44100, 96001, dict(fused="poly"), CLASS_DB,
     ["FusedPolyExec", "ConvExec"]),
    ("fused=poly high", 44100, 96001, dict(fused="poly", precision="high"),
     HIGH_CHAIN_DB, ["FusedPolyExec", "ConvExec"]))

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


def best_form(simt, split):
    """(ms, by, form): the smaller of a kernel's CUDA-core and split-form
    bounds, each (ms, by)."""
    if simt == split:  # both bound by the same bytes
        return simt + ("either form",)
    return min(simt + ("CUDA cores",), split + ("bf16 split",))


def frac_bounds(R, nnz, nnz_lo, io_bytes, D, O, peaks):
    """The least time of a frac_whole call, the smaller of its two forms':
    float32 FMA on the CUDA cores (2 R nnz flop, plus the residual dot's,
    over the fp32 peak; the operator read in float32) and the split form
    on the tensor cores (6 bf16 products a term, and one more over the
    residual's nonzeros, over the bf16 peak; the operator read as 3 or 4
    bf16 slices), each the larger of its operations and bytes time.
    nnz_lo is None without skT_lo.  Returns ((ms, by, form), the CUDA-core
    (ms, by), the split (ms, by))."""
    peak_f32, peak_bf16, peak_bytes = peaks
    lo = nnz_lo is not None
    simt = bound(2.0 * R * (nnz + (nnz_lo or 0)),
                 io_bytes + 4.0 * D * O * (2 if lo else 1), peak_f32,
                 peak_bytes)
    split = bound(2.0 * R * (6 * nnz + (nnz_lo or 0)),
                  io_bytes + 2.0 * D * O * (4 if lo else 3), peak_bf16,
                  peak_bytes)
    return best_form(simt, split), simt, split


def sym_bounds(R, nnz, nnz_lo, io_bytes, op_elems, packed_elems, peaks):
    """The least time of a sym_conv call (R frames, nnz nonzero entries of
    the folded operators), the smaller of its two forms': float32 FMA on
    the CUDA cores (2 R nnz flop, under "high" (nnz_lo not None) plus the
    fold-error dots over the operators and the residual rows' nonzeros,
    over the fp32 peak; the operators read in float32) and the split form
    on the tensor cores (6 bf16 products a nonzero term, under "high" one
    more for the fold errors and one for the residual rows, over the bf16
    peak; the packed bf16 slices read).  Returns ((ms, by, form), the
    CUDA-core (ms, by), the split (ms, by))."""
    peak_f32, peak_bf16, peak_bytes = peaks
    extra = 0 if nnz_lo is None else nnz + nnz_lo
    simt = bound(2.0 * R * (nnz + extra), io_bytes + 4.0 * op_elems,
                 peak_f32, peak_bytes)
    split = bound(2.0 * R * (6 * nnz + extra), io_bytes + 2.0 * packed_elems,
                  peak_bf16, peak_bytes)
    return best_form(simt, split), simt, split


def build_kernels() -> None:
    from r8brain_torch.ops import _cuda

    names = ["frac_whole", "ozaki_framed", "df_fft_conv", "sym_conv",
             "dense_gemm", "poly_dot"]
    t0 = time.perf_counter()
    _cuda.build(names)
    print(f"build: {', '.join(names)} {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _cuda.build_logs.get(name, "").splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "C75", "arning")):
                print(f"  ptxas {name}: {line.strip()}")


def beta_sums(y, y64):
    """(sum of e * sign(y64), sum of e^2, count) of e = y - y64, to add up
    over chunks for frac_beta."""
    e = y.double() - y64
    return (float((e * y64.sign()).sum().item()),
            float(e.square().sum().item()), e.numel())


def beta_of(sums):
    """The bias statistic mean(e * sign(y64)) / rms(e) from beta_sums
    (added over chunks), 0 where e is all zero."""
    es, e2, n = sums
    return es / n / math.sqrt(e2 / n) if e2 > 0 else 0.0


def frac_beta(label, sums, model_sums):
    """(kernel's, model's) bias statistic (beta_of) from their beta_sums;
    where the call has FRAC_BETA_MIN_N outputs or more the kernel's is
    held within FRAC_BETA_MAX of the model's."""
    bk, bm = beta_of(sums), beta_of(model_sums)
    if sums[2] >= FRAC_BETA_MIN_N:
        check(abs(bk - bm) <= FRAC_BETA_MAX, f"{label}: beta {bk:+.4f}, "
              f"its model's {bm:+.4f} ({sums[2]} outputs): more than "
              f"{FRAC_BETA_MAX} apart")
    return bk, bm


def check_frac_beta(dev) -> None:
    """frac_whole's bias at the flagship's fused call, the half-band
    upsampler's, the toeplitz conv stage's and its direct form's, "fast"
    and "high", on 1024 channels of full-mantissa input
    (tools/torch_frac_beta.py's calls, as tests/test_torch_cuda.py::
    test_frac_whole_unbiased): |beta| at most FRAC_BETA_MAX."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_frac_beta

    from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for label, I, D, O, n_win, parts, p64, kc, band in torch_frac_beta.calls(
            dev):
        xp = full_mantissa(g, (CHANNELS, (n_win - 1) * I + D),
                           torch.float32, dev)
        y64 = frac_whole_ref(xp.double(), p64, I, D, O, n_win)
        bk, bm = frac_beta(f"frac_whole beta {label}",
                           beta_sums(frac_whole(xp, parts, I, D, O, n_win,
                                                kc, band), y64),
                           beta_sums(frac_whole_ref(xp, parts, I, D, O,
                                                    n_win, kc, band), y64))
        check(abs(bk) <= FRAC_BETA_MAX, f"frac_whole {label}: beta "
              f"{bk:+.4f} over {FRAC_BETA_MAX}")
        out.append(f"{label} {bk:+.4f} ({bm:+.4f})")
    print(f"frac_whole beta, {CHANNELS} channels of full-mantissa input, "
          f"kernel (model): {', '.join(out)} (kernel within "
          f"{FRAC_BETA_MAX} of 0 and of its model)")


def check_frac_band() -> None:
    """frac_whole walking each column tile's band against the full walk
    (tools/torch_frac_band.py): y bit-equal at every call of its LABELS,
    1024 channels, the folds walked and both timed in turns."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_frac_band

    check(torch_frac_band.main(["--reps", "5"]) == 0,
          "frac_whole's band walk differs from the full walk")


def check_frac_model(label, y, model, ref64):
    """frac_whole's float32 output y against its plain model (within
    MODEL_REL_TOL of max |y|) and the float64 product (KERNEL_REL_TOL),
    and its bias (frac_beta); returns (max abs err vs float64, rel err vs
    model, rel err vs f64, beta, the model's beta)."""
    scale = float(ref64.abs().max().item())
    err_m = float((y.double() - model.double()).abs().max().item()) / scale
    max_abs = float((y.double() - ref64).abs().max().item())
    check(err_m <= MODEL_REL_TOL, f"{label}: {err_m:.3e} of max |y| from "
          f"the plain model (tol {MODEL_REL_TOL:.2e})")
    check(max_abs / scale <= KERNEL_REL_TOL, f"{label}: max rel err "
          f"{max_abs / scale:.3e} vs f64 plain")
    beta, beta_m = frac_beta(label, beta_sums(y, ref64),
                             beta_sums(model, ref64))
    return max_abs, err_m, max_abs / scale, beta, beta_m


def exec_parts(ex):
    """The packed operator of the executor ``ex`` (ops/operators.py), or
    None."""
    return getattr(getattr(ex, "op", None), "parts", None)


def exec_operator(ex, parts):
    """(skT, skT_lo) of the executor ``ex`` whose packed operator a path's
    frac_whole call got as ``parts``: the float64 checks and the residual
    check read the operator that the executor packed."""
    if exec_parts(ex) is parts:
        return ex.op.hi, ex.op.lo
    raise SmokeFailure("a frac_whole call got an operator that is no "
                       "buffer of its executor")


def check_residual(label, xp, skT, I, D, O, n_win, kc, start=0):
    """frac_whole's residual slice at one call's shape: the call's input
    (read from window origin ``start``) and operator with an skT_lo planted at RESIDUAL_SCALE of it (Gaussian
    factors).  The kernel with the slice against its model within
    MODEL_REL_TOL of max |y|, the slice moving the model by at least
    RESIDUAL_MOVE times that, and the kernel's own contribution of the
    slice (with minus without) against the model's within
    RESIDUAL_REL_TOL.  A kernel that drops or misplaces the slice fails."""
    import torch

    from r8brain_torch.ops.pallas_frac import (frac_whole, frac_whole_ref,
                                               operator_band, operator_parts)

    g = torch.Generator(device=xp.device).manual_seed(SEED)
    lo = skT * torch.randn(skT.shape, generator=g, device=xp.device)
    with_lo = operator_parts(skT, lo * RESIDUAL_SCALE)
    bare = operator_parts(skT)
    y = frac_whole(xp, with_lo, I, D, O, n_win, kc=kc,
                   band=operator_band(with_lo), start=start).double()
    dy = y - frac_whole(xp, bare, I, D, O, n_win, kc=kc,
                        band=operator_band(bare), start=start).double()
    m = frac_whole_ref(xp, with_lo, I, D, O, n_win, kc=kc,
                       start=start).double()
    dm = m - frac_whole_ref(xp, bare, I, D, O, n_win, kc=kc,
                            start=start).double()
    torch.cuda.synchronize()
    scale = float(m.abs().max().item())
    moved = float(dm.abs().max().item())
    err = float((y - m).abs().max().item()) / scale
    err_d = float((dy - dm).abs().max().item()) / moved
    print(f"frac_whole residual slice at {label} (I={I} D={D} O={O} C="
          f"{xp.shape[0]} n_win={n_win} fold {kc}), skT_lo planted at "
          f"{RESIDUAL_SCALE:g} of skT: moves the model by {moved / scale:.3e}"
          f" of max |y| (>= {RESIDUAL_MOVE:g} x {MODEL_REL_TOL:.2e}); kernel "
          f"{err:.3e} of max |y| from the model, its own contribution "
          f"{err_d:.3e} of the model's (tol {RESIDUAL_REL_TOL:g})")
    check(moved >= RESIDUAL_MOVE * MODEL_REL_TOL * scale,
          f"{label}: the planted residual moves y by only "
          f"{moved / scale:.3e} of max |y|")
    check(err <= MODEL_REL_TOL, f"{label} with the planted residual: "
          f"{err:.3e} of max |y| from the model")
    check(err_d <= RESIDUAL_REL_TOL, f"{label}: the kernel's residual "
          f"contribution is {err_d:.3e} off the model's")


def fast_path(dev, x, ref, skip, peaks, card):
    """The fast flagship's phases: frac_whole vs its plain model and the
    float64 product (both folds, with their dB on the card), the path
    itself (counted), its accuracy and timings.  Returns the kernel
    record."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch import Resampler
    from r8brain_torch.ops.pallas_frac import (KC, KC_LO, frac_whole,
                                               frac_whole_ref, operator_band,
                                               operator_parts)

    rs = Resampler(SRC, DST, TB, ATTEN, device=dev)
    ex = rs.execs[0]
    I, D, O, parts, band = ex.p_in, ex.D, ex.p_out, ex.op.parts, ex.op.band
    # the window count oneshot gives the kernel (its zero-flush pad)
    T = max(N_IN, rs.in_len_for_out(rs.default_out_len(N_IN)))
    n_win = -(-rs.out_len_for_in(T) // O)
    L = (n_win - 1) * I + D
    g = torch.Generator(device=dev).manual_seed(SEED)
    xp = torch.rand((CHANNELS, L), generator=g, device=dev) * 2 - 1
    ref64 = frac_whole_ref(xp.double(), operator_parts(ex.op.hi.double()), I,
                           D, O, n_win)
    for kc in (KC_LO, KC):
        y = frac_whole(xp, parts, I, D, O, n_win, kc=kc, band=band)
        model = frac_whole_ref(xp, parts, I, D, O, n_win, kc=kc, band=band)
        torch.cuda.synchronize()
        m_abs, err_m, err, beta, beta_m = check_frac_model(
            f"flagship fold {kc}", y, model, ref64)
        if kc == KC:
            max_abs = m_abs
        check(abs(beta) <= FRAC_BETA_MAX, f"flagship fold {kc}: beta "
              f"{beta:+.4f} over {FRAC_BETA_MAX}")
        print(f"frac_whole flagship I={I} D={D} O={O} C={CHANNELS} "
              f"n_win={n_win}, fold {kc}: {rms_db(y.double() - ref64):.2f} "
              f"dB re full scale vs f64 plain (model "
              f"{rms_db(model.double() - ref64):.2f}); max rel err "
              f"{err:.3e} (tol {KERNEL_REL_TOL:g}), {err_m:.3e} of max |y| "
              f"from the model (tol {MODEL_REL_TOL:.2e}); beta {beta:+.4f} "
              f"(model {beta_m:+.4f}, kernel within {FRAC_BETA_MAX})")
        del y, model
    del ref64

    Io, Do, Oo, Co, no = 147, 171, 160, 13, 37
    xo = torch.rand((Co, (no - 1) * Io + Do + 5), generator=g, device=dev)
    xo = xo * 2 - 1
    so = torch.randn((Do, Oo), generator=g, device=dev)
    slo = torch.randn((Do, Oo), generator=g, device=dev) * 2.0**-24
    po = operator_parts(so, slo)
    yo = frac_whole(xo, po, Io, Do, Oo, no, band=operator_band(po))
    mo = frac_whole_ref(xo, po, Io, Do, Oo, no)
    po64 = operator_parts(so.double(), slo.double())
    ro = frac_whole_ref(xo.double(), po64, Io, Do, Oo, no)
    yo64 = frac_whole(xo.double(), po64, Io, Do, Oo, no)
    torch.cuda.synchronize()
    _a, erro_m, erro, _b, _bm = check_frac_model("odd geometry", yo, mo, ro)
    erro64 = max_rel(yo64, ro)
    print(f"frac_whole odd I={Io} D={Do} O={Oo} C={Co} n_win={no} with "
          f"skT_lo: max rel err f32 {erro:.3e} (tol {KERNEL_REL_TOL:g}), "
          f"{erro_m:.3e} from the model, f64 {erro64:.3e} (tol "
          f"{F64_REL_TOL:g})")
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
    ms = {k: cuda_ms(lambda: frac_whole(xp, parts, I, D, O, n_win, kc=k,
                                        band=band),
                     reps=20)
          for k in (KC_LO, KC)}
    p_ms = cuda_ms(lambda: frac_whole_ref(xp, parts, I, D, O, n_win,
                                          band=band),
                   reps=3, warmup=1)
    w = ex.op.hi.T.contiguous()[:, None, :]
    lib_ms = cuda_ms(lambda: F.conv1d(xp[:, None, :], w, stride=I), reps=10)
    R = CHANNELS * n_win
    io = 4.0 * (CHANNELS * L + R * O)
    # the operator's nonzero entries: the work the function needs (the
    # kernel multiplies the operator dense)
    nnz = int((ex.op.hi != 0).sum().item())
    (bound_ms, bound_by, form), simt, split = frac_bounds(R, nnz, None, io,
                                                          D, O, peaks)
    dense = frac_bounds(R, D * O, None, io, D, O, peaks)
    flops, dflops = 2.0 * R * nnz, 2.0 * R * D * O
    print(f"timing {card}: frac_whole kernel {ms[KC]:.3f} ms "
          f"({flops / ms[KC] * 1e-9:.1f} TFLOP/s of the function's nonzero "
          f"products, {dflops / ms[KC] * 1e-9:.1f} dense; fold {KC_LO}: "
          f"{ms[KC_LO]:.3f} ms), bound {bound_ms:.3f} ms by {bound_by} "
          f"({form}; CUDA cores {simt[0]:.3f} ms by {simt[1]}, bf16 split "
          f"{split[0]:.3f} ms by {split[1]}; {flops:.3e} flop over the "
          f"operator's {nnz} nonzeros of {D * O}, {io / 1e9:.3f} GB of "
          f"signal in and out; dense: {dense[0][0]:.3f} ms, CUDA cores "
          f"{dense[1][0]:.3f}), plain frac_whole_ref {p_ms:.3f} ms, cuDNN "
          f"conv1d (TF32 off) {lib_ms:.3f} ms")
    return {"name": "frac_whole", "route": "cuda",
            "source": "r8brain_torch/csrc/frac_whole.cu",
            "replaces": "r8brain_tpu/ops/pallas_frac.py:111",
            "launches": launches, "max_abs_err": max_abs, "ms": ms[KC],
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def accumulation_pin(dev, skT) -> None:
    """How the tensor cores add bf16 x bf16 products into float32: 16- and
    32-term sums through the kernel's own wgmma chain, a fold each, on
    input k/256 (uniform k, |k| <= 255), which the kernel's grid split
    leaves as it is (x1 = x2 = 0):

    * on lead slices that lie on one grid, the flagship operator scaled to
      255/256 of its largest |tap| and rounded to 2^-8: every pair but
      x0*s0 is zero and each output is one fold's sum, its products on
      the grid 2^-16 and under 2^21 of it in sum, so exact in float32.
      Every output must equal the float64 sum (the tensor cores truncate
      an inexact sum; the kernel's grids leave them none);
    * on floating slices of real data, the flagship operator's split3
      lead slice, 16 or 32 taps at a time, as the residual slice
      bf16(skT_lo) of an operator whose skT is zero: every pair but
      x0*bf16(skT_lo) is zero, and the tensor cores add its products into
      lo as they add the small pairs, so each output is one chain of
      products not on one grid.  Held to the bound of a recursive float32
      sum that truncates, (terms - 1) * 2^-23 * sum |products|; printed:
      max and RMS error in float32 ulps of sum |products| (the sum itself
      may cancel), how many outputs equal the float64 sum rounded once,
      and which way the inexact ones round, so that a change in how the
      tensor cores round shows here."""
    import torch

    from r8brain_torch.ops.pallas_frac import (frac_whole, operator_band,
                                               operator_parts, split3)

    s0 = torch.round(skT / skT.abs().max() * 255) / 256
    sf = split3(skT)[0]
    D, O = s0.shape
    g = torch.Generator(device=dev).manual_seed(SEED)
    C, n_win = 16, 128
    for terms in (16, 32):
        x0 = torch.randint(-255, 256, (C, n_win * terms), generator=g,
                           device=dev).float() / 256
        xw = x0.double().reshape(C, n_win, terms)
        n_all = n_exact = n = n_rn = n_f64 = n_inexact = n_down = 0
        worst, sq = 0.0, 0.0
        for d0 in range(0, D - terms + 1, terms):
            op = s0[d0 : d0 + terms].contiguous()
            p = operator_parts(op)
            y = frac_whole(x0, p, terms, terms, O, n_win, kc=terms,
                           band=operator_band(p))
            y = y.double().reshape(C, n_win, O)
            n_exact += int((y == xw @ op.double()).sum().item())
            n_all += y.numel()

            of = sf[d0 : d0 + terms].contiguous()
            p = operator_parts(torch.zeros_like(of), of)
            y = frac_whole(x0, p, terms, terms, O, n_win, kc=terms,
                           band=operator_band(p))
            y = y.double().reshape(C, n_win, O)
            exact = xw @ of.double()
            mag = xw.abs() @ of.double().abs()
            check(bool(((y - exact).abs()
                        <= (terms - 1) * 2.0**-23 * mag).all()),
                  f"accumulation pin: {terms}-term sum at taps {d0}.. "
                  f"outside the truncating float32 bound")
            rn = exact.float().double()
            keep = mag != 0
            ulp = torch.exp2(torch.floor(torch.log2(mag[keep])) - 23)
            e = (y - exact)[keep] / ulp
            worst = max(worst, float(e.abs().max().item()))
            sq += float(e.square().sum().item())
            n += int(keep.sum().item())
            inexact = y != exact
            n_inexact += int(inexact.sum().item())
            n_down += int((inexact & (y.abs() < exact.abs())).sum().item())
            n_rn += int((y == rn).sum().item())
            n_f64 += int((exact == rn).sum().item())
        print(f"accumulation pin: {terms}-term wgmma bf16 -> f32 sums of "
              f"products on one grid (flagship s0 and uniform x0, each "
              f"rounded to 2^-8), {n_all} outputs: {n_exact} equal to the "
              f"f64 sum")
        check(n_exact == n_all, f"accumulation pin: {n_all - n_exact} of "
              f"{n_all} {terms}-term sums of products on one grid inexact")
        share_down = n_down / max(1, n_inexact)
        mode = ("truncating (toward zero)" if share_down > 0.9 else
                "to nearest (errors symmetric)"
                if 0.4 <= share_down <= 0.6 else "neither")
        print(f"accumulation pin: {terms}-term wgmma bf16 -> f32 sums into "
              f"lo, {n} outputs (flagship split3 s0 as bf16(skT_lo) x "
              f"uniform x0 on 2^-8): vs the f64 sum, max {worst:.3f} ulps "
              f"of sum |products|, RMS {math.sqrt(sq / max(1, n)):.4f}; "
              f"{100 * n_rn / n_all:.3f} % equal to it rounded once to f32 "
              f"({100 * n_f64 / n_all:.3f} % of the f64 sums exact in f32); "
              f"of the {n_inexact} inexact outputs {100 * share_down:.2f} % "
              f"toward zero: {mode}")


def lemma_pin(dev) -> None:
    """The exactness lemma on the card's tensor cores: for every kept
    slice pair (p, q) and every operand kind of
    ``pallas_ozaki.lemma_operands`` (worst case: every product 256 x 256
    units, rows of one sign summing to exactly 2^24; random units; the
    split of Gaussian data; mixed magnitude: one 2^16 product among
    products of 1), a 256-deep float32 accumulation of bf16 slice
    products equals the float64 product bit for bit: on ozaki_framed's own
    wgmma path (``wgmma_dot``: the packed operator through a bulk copy, A
    from registers, m64n128k16, 16 k16 steps chained into one
    accumulator) and on mma.sync m16n8k16 (``mma_dot``)."""
    import torch

    from r8brain_torch.ops import ozaki
    from r8brain_torch.ops.pallas_ozaki import (lemma_operands, mma_dot,
                                                wgmma_dot)

    n = 0
    for p in range(ozaki.N_PARTS):
        for q in range(ozaki.N_DIAG - p):
            for kind, (a, b) in lemma_operands(SEED, p, q).items():
                want = a.double() @ b.double()
                parts = torch.zeros((ozaki.N_PARTS, *b.shape),
                                    dtype=torch.bfloat16)
                parts[q] = b
                got = {"wgmma": wgmma_dot(a.to(dev), parts.to(dev))[q],
                       "mma.sync": mma_dot(a.to(dev), b.to(dev))}
                for probe, y in got.items():
                    y = y.double().cpu()
                    check(torch.equal(y, want),
                          f"lemma pin: {probe} accumulation inexact at "
                          f"slice pair ({p}, {q}), {kind}: max |diff| "
                          f"{(y - want).abs().max().item():.3e}")
                n += 1
    M, K = a.shape
    print(f"lemma pin: {n} cases (10 slice pairs x 4 operand kinds, "
          f"{M}x{K} @ {K}x{b.shape[1]}), wgmma m64n128k16 (16 k16 steps "
          f"chained into one accumulator, the kernel's path) and mma.sync "
          f"m16n8k16 bf16 -> f32 accumulation, each bit-equal to the f64 "
          f"product")


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


def check_ozaki_variants(label, geo, case, parts, packed):
    """Every (has_lo, emit_pair) variant of ozaki_framed (on the operator
    as ``packed``) against ozaki_framed_ref on the card and against the
    float64 product.
    Returns {variant: max |kernel - plain|}."""
    import torch

    from r8brain_torch.ops.pallas_ozaki import ozaki_framed, ozaki_framed_ref

    L_f, hop, Kcols, n_blocks = geo
    xp, sx, xl, (p_x, p_l) = case
    errs, dbs = {}, []
    for has_lo, emit in VARIANTS:
        lo = xl if has_lo else None
        args = (xp, sx, parts, L_f, hop, Kcols, n_blocks)
        y = ozaki_framed(*args, x_lo=lo, emit_pair=emit, packed=packed)
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
    print(f"df_fft_conv: {len(FFT_CASES)} cases (every mode at n=128.."
          f"8192, frames n=16384/65536, poly n=16384; odd C*n_frames, "
          f"row-strided input) vs df_fft_conv_ref: max rel err {worst:.3e} "
          f"(tol {FFT_REL_TOL:.2e})")


def held(name, args):
    """A kernel call's arguments as the replays here keep them: a
    frac_whole call's input (the stage's input, which it reads in place)
    copied at the same strides and storage offset mod 4, so at the same
    alignment, since the program may write into that storage after the
    call (a stream's ring); any other call's as they are."""
    x = args[0]
    if name != "frac_whole" or x.numel() == 0 or x.stride(1) != 1:
        return args
    off = x.storage_offset() % 4
    span = (x.shape[0] - 1) * x.stride(0) + x.shape[1]
    buf = x.new_empty(off + span)
    buf[off:] = x.as_strided((span,), (1,), x.storage_offset())
    return (buf.as_strided(x.shape, x.stride(), off),) + tuple(args[1:])


def capture_calls(rs, x, modules, names=("df_fft_conv", "frac_whole")):
    """Run rs.oneshot(x) once with the kernel wrappers ``names`` that
    ``modules`` call recorded: the arguments each kernel gets on this
    path (held)."""
    calls = {}
    real = {(m, k): getattr(m, k) for m in modules for k in names
            if hasattr(m, k)}

    def recorder(k, fn):
        def rec(*args, **kw):
            if k not in calls:
                calls[k] = (held(k, args), kw)
            return fn(*args, **kw)
        return rec

    try:
        for (m, k), fn in real.items():
            setattr(m, k, recorder(k, fn))
        rs.oneshot(x)
    finally:
        for (m, k), fn in real.items():
            setattr(m, k, fn)
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


def fft_record(label, call, replaces, launches, peaks, card):
    """One df_fft_conv call of a path against its plain version and the
    library route (float64 torch.fft), timed, with its bound.  Returns the
    kernel record."""
    import torch

    from r8brain_torch.ops.pallas_dfft import df_fft_conv, df_fft_conv_ref

    _peak_f32, _peak_bf16, peak_f64, peak_bytes = peaks
    (u, plan, n_frames, head), _kw = call
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
    return {"name": f"df_fft_conv[{label}: {mode}, n={n}]", "route": "cuda",
            "source": "r8brain_torch/csrc/df_fft_conv.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def fft_paths(dev, x, ref, skip, peaks, card):
    """The df32-FFT engines' paths: each counted (launches set to 0 just
    before, read just after), checked at -141 dB against the port's
    float64 CPU path and timed with its kernel calls.  Returns the kernel
    records."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import operators, stages
    from r8brain_torch.ops.pallas_dfft import df_fft_conv
    from r8brain_torch.ops.pallas_frac import frac_whole

    peak_f32, peak_bf16, _peak_f64, peak_bytes = peaks
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

        calls = capture_calls(rs, x, (stages, operators))
        records.append(fft_record(label, calls["df_fft_conv"], replaces,
                                  by.get(want, 0), peaks, card))
        if label == "poly":
            records.append(frac_record(
                "frac_whole[frac stage, skT_lo]", calls["frac_whole"],
                rs.execs[1], n_fw, (peak_f32, peak_bf16, peak_bytes), card,
                expect_lo=True))
        del calls, rs
        torch.cuda.empty_cache()
    return records


def fused_high_path(dev, x, ref, skip, peaks, card):
    """The fused flagship with precision="high" (the residual dot in the
    same kernel): counted, held at -141 dB, timed; returns its kernel
    record."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import operators
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
    calls = capture_calls(rs, x, (operators,), ("frac_whole",))
    rec = frac_record("frac_whole[fused, skT_lo]", calls["frac_whole"],
                      rs.execs[0], launches, peaks, card, expect_lo=True)
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


def sym_high_gain(label, xp, ex, L_fs, nb, hop):
    """The gain of precision "high" on xp, kernel and model, for the
    "high" executor ``ex``: the drop of each one's RMS error against the
    float64 function of "high" from its fast output (the operators packed
    without the residual) to its high one (``ex.sym_parts``), dB re full
    scale.  Checks that the model gains at least SYM_GAIN_MIN_DB and the
    kernel within SYM_GAIN_TOL_DB of the model; returns (kernel gain,
    model gain, kernel high dB)."""
    from r8brain_torch.ops.pallas_symconv import (sym_conv, sym_conv_ref,
                                                  sym_ops_high, sym_parts)

    ops, lo, rows = ex.sym_ops, ex.sym_lo, ex.sym_lo_rows
    want = sym_conv_ref(xp.double(), sym_ops_high(ops, lo, rows), L_fs, nb,
                        hop)
    fast = sym_parts(ops)
    db = {fn: (rms_db(fn(xp, fast, L_fs, nb, hop) - want),
               rms_db(fn(xp, ex.sym_parts, L_fs, nb, hop) - want))
          for fn in (sym_conv, sym_conv_ref)}
    gk = db[sym_conv][0] - db[sym_conv][1]
    gp = db[sym_conv_ref][0] - db[sym_conv_ref][1]
    check(gp >= SYM_GAIN_MIN_DB, f"sym_conv_ref {label}: 'high' gains "
          f"{gp:.3f} dB, under {SYM_GAIN_MIN_DB} dB")
    check(abs(gk - gp) <= SYM_GAIN_TOL_DB, f"sym_conv {label}: 'high' gains "
          f"{gk:.3f} dB ({db[sym_conv][0]:.3f} -> {db[sym_conv][1]:.3f}), "
          f"the plain model {gp:.3f} dB (tol {SYM_GAIN_TOL_DB} dB)")
    return gk, gp, db[sym_conv][1]


def sym_beta(y, y64) -> float:
    """The bias statistic of y's error against y64: mean(e * sign(y64)) /
    rms(e), 0 for an unbiased sum, negative for one truncated toward
    zero."""
    e = y.double() - y64
    return ((e * y64.sign()).mean() / e.square().mean().sqrt()).item()


def check_sym_cases(dev) -> None:
    """sym_conv at every conv spec of the folded engine, float32 fast and
    high and float64, C = 13 and 37 frames (no multiple of any tile), on a
    row-strided full-mantissa input, against sym_conv_ref on the card;
    in float32 the bias of kernel and model against their float64
    function (sym_beta, the kernel's held to SYM_BETA_MAX); under "high"
    also its gain (sym_high_gain); and a packing of another tiling
    refused."""
    import torch

    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.pallas_symconv import (sym_conv, sym_conv_ref,
                                                  sym_ops_high)
    from r8brain_torch.ops.stages import ConvExec

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, gains, betas = {}, [], []
    for cfg in SYM_CFGS:
        st = make_plan(*cfg, 0).stages[0]
        for dt, prec in ((torch.float32, "fast"), (torch.float32, "high"),
                         (torch.float64, "fast")):
            ex = ConvExec(st, dt, prec, engine="toeplitz_sym").to(dev)
            C, nb, hop = 13, 37, 256 * st.down
            L = (nb - 1) * hop + max(ex.sym_Lf)
            xp = full_mantissa(g, (C, L + 3), dt, dev)[:, 3:]
            args = (xp, ex.sym_parts, ex.sym_Lf, nb, hop)
            y, r = sym_conv(*args), sym_conv_ref(*args)
            torch.cuda.synchronize()
            u = ulps_of_max(y, r)
            key = str(dt).replace("torch.", "")
            check(u <= SYM_ULPS[key], f"sym_conv {cfg} {key} {prec}: "
                  f"{u:.2f} ulps of max |y| from plain")
            worst[(key, prec)] = max(worst.get((key, prec), 0.0), u)
            if ex.sym_lo is not None:
                gk, gp, _db = sym_high_gain(str(cfg), xp, ex, *args[2:])
                gains.append(f"{gk:.3f}/{gp:.3f}")
            if dt == torch.float32:
                ops64 = (sym_ops_high(ex.sym_ops, ex.sym_lo, ex.sym_lo_rows)
                         if ex.sym_lo is not None else ex.sym_ops.double())
                y64 = sym_conv_ref(xp.double(), ops64, *args[2:])
                bk, bp = sym_beta(y, y64), sym_beta(r, y64)
                betas.append(f"{prec} {bk:+.4f}/{bp:+.4f}")
                check(abs(bk) <= SYM_BETA_MAX, f"sym_conv {cfg} {prec}: "
                      f"beta {bk:+.4f} (model {bp:+.4f}), over "
                      f"{SYM_BETA_MAX}")
                other = ex.sym_parts[:, :2].contiguous()
                try:
                    sym_conv(xp, other, *args[2:])
                except ValueError:
                    pass
                else:
                    raise SmokeFailure("sym_conv took a packing of another "
                                       "tiling")
    print(f"sym_conv: {len(SYM_CFGS)} conv specs x (f32 fast, f32 high, "
          f"f64), C=13, 37 frames, row-strided full-mantissa input, vs "
          f"sym_conv_ref: max ulps of max |y| {worst} (tol {SYM_ULPS}); "
          f"'high' gain kernel/model dB {', '.join(gains)} (model >= "
          f"{SYM_GAIN_MIN_DB}, kernel within {SYM_GAIN_TOL_DB}); beta "
          f"kernel/model {', '.join(betas)} (kernel within "
          f"{SYM_BETA_MAX}); a packing of another tiling refused")


def check_dense_cases(dev) -> None:
    """dense_gemm at a ragged shape, both M tiles (the same result), one K
    loop and hop segments (256, and 48, which folds mid k-tile), a K no
    multiple of 4 and a misaligned A, against the float64 product on the
    card."""
    import torch

    from r8brain_torch.ops.scout import M_TILES, dense_gemm, dense_gemm_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn((1000, 700), generator=g, device=dev)
    B = torch.randn((700, 130), generator=g, device=dev)
    errs, outs = {}, {}
    for mt in M_TILES:
        for hop in (None, GEMM_HOP, 48):
            c, r = dense_gemm(A, B, mt, hop), dense_gemm_ref(A, B, mt, hop)
            torch.cuda.synchronize()
            errs[(mt, hop)] = max_rel(c, r)
            outs[(mt, hop)] = c
            check(errs[(mt, hop)] <= DENSE_REL_TOL, f"dense_gemm mt={mt} "
                  f"hop={hop}: max rel err {errs[(mt, hop)]:.3e}")
    for hop in (None, GEMM_HOP, 48):
        check(torch.equal(outs[(M_TILES[0], hop)], outs[(M_TILES[1], hop)]),
              f"dense_gemm hop={hop}: the result depends on mt")
    # K no multiple of 4 (A padded by the wrapper), a misaligned view
    A7 = torch.randn((300, 701), generator=g, device=dev)
    B7 = torch.randn((701, 130), generator=g, device=dev)
    big = torch.randn((300 * 700 + 1,), generator=g, device=dev)
    for label, a, b in (("K=701", A7, B7),
                        ("misaligned A", big[1:].view(300, 700), B)):
        e = max_rel(dense_gemm(a, b), dense_gemm_ref(a, b))
        check(e <= DENSE_REL_TOL, f"dense_gemm {label}: max rel err {e:.3e}")
        errs[label] = e
    print(f"dense_gemm 1000x700 @ 700x130 (and 300x701 @ 701x130, a "
          f"misaligned A) vs the f64 product: max rel err by (mt, hop) "
          f"{errs} (tol {DENSE_REL_TOL:g}); equal across mt")


def conv_library(ex, x_in, n_cyc: int):
    """The one PyTorch call that computes a conv stage's function on its
    input x_in: ``F.conv1d`` of x_in (shifted by s_min) with the
    superkernel rows at stride down, float32, TF32 off ([C, up, n_cyc],
    the phases not interleaved).  Returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.framing import shifted

    down = ex.spec.down
    xp = shifted(x_in, ex.s_min, (n_cyc - 1) * down + ex.D_direct,
                 torch.float32)
    w = ex.skT_direct.T.contiguous()[:, None, :]
    return lambda: F.conv1d(xp[:, None, :], w, stride=down)[:, :, :n_cyc]


def matmul_record(label, kernel, name, call, ex, x_in, launches, peaks,
                  card):
    """One conv-stage kernel call of a float32 stage chain (x_in: the
    stage's input): the kernel against its plain version at the path's
    shape (frac_whole: its float32 model and its float64 product), timed
    beside the plain version and F.conv1d; the bound counts the operator's
    nonzero entries (the dense count printed beside), the smaller of its
    CUDA-core and split forms' (frac_bounds, sym_bounds)."""
    import torch

    from r8brain_torch.ops.pallas_frac import (frac_whole, frac_whole_ref,
                                               operator_parts)
    from r8brain_torch.ops.pallas_symconv import sym_conv, sym_conv_ref

    peak_f32, _bf16, peak_bytes = peaks
    args, kw = call
    xp, C = args[0], args[0].shape[0]
    if kernel == "sym_conv":
        fn, ref = sym_conv, sym_conv_ref
        _xp, parts, L_fs, nb, hop = args
        ops, lo, rows = ex.sym_ops, ex.sym_lo, ex.sym_lo_rows
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
                ex, L_fs, nb, hop)
            tol += (f"; 'high' gain on full-mantissa input {gk:.3f} dB "
                    f"(model {gp:.3f}, tol {SYM_GAIN_TOL_DB}), high "
                    f"{db:.2f} dB re full scale vs its f64 function")
        Hps = [(L + 1) // 2 for L in L_fs]
        nnz_main = sum(int((ops[j, :, :hp] != 0).sum().item())
                       for j, hp in enumerate(Hps))
        nnz_lo = None if lo is None else int((lo != 0).sum().item())
        nnz = nnz_main + (0 if lo is None else nnz_main + nnz_lo)
        dense = sum(2 * hp * ops.shape[3] for hp in Hps)
        if lo is not None:  # the fold-error dots and the residual rows
            dense += dense + sum(n for ph in rows for _r0, n in ph) * \
                ops.shape[3]
        per_frame = 2.0 * C * nb
        span = (nb - 1) * hop + max(L_fs)
        op_bytes = 4.0 * (ops.numel() + (0 if lo is None else lo.numel()))
        n_out = nb * 256 * len(L_fs)
    else:
        fn, ref = frac_whole, frac_whole_ref
        _xp, parts, I, D, O, n_win = args
        skT, lo = exec_operator(ex, parts)
        y, model = fn(*args, **kw), ref(*args, **kw)
        r = ref(xp.double(), operator_parts(
            skT.double(), None if lo is None else lo.double()), I, D, O,
            n_win, start=kw.get("start", 0))
        torch.cuda.synchronize()
        _a, err_m, err, beta, _bm = check_frac_model(name, y, model, r)
        del model
        tol = (f"max rel err {err:.3e} vs f64 plain (tol "
               f"{KERNEL_REL_TOL:g}), {err_m:.3e} of max |y| from the "
               f"model (tol {MODEL_REL_TOL:.2e}), beta {beta:+.4f}")
        nnz_main = int((skT != 0).sum().item())
        nnz_lo = None if lo is None else int((lo != 0).sum().item())
        nnz = nnz_main + (nnz_lo or 0)
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
    dense_ms = bound(dflops, nbytes, peak_f32, peak_bytes)[0]
    io = 4.0 * C * span + 4.0 * C * n_out
    if kernel == "sym_conv":
        best, simt, split = sym_bounds(C * nb, nnz_main, nnz_lo, io,
                                       op_bytes / 4, parts.numel(), peaks)
    else:
        best, simt, split = frac_bounds(C * n_win, nnz_main, nnz_lo, io, D,
                                        O, peaks)
    bound_ms, bound_by, form = best
    form += (f"; CUDA cores {simt[0]:.3f} ms by {simt[1]}, bf16 split "
             f"{split[0]:.3f} ms by {split[1]}")
    print(f"timing {card}: {name} ({label}, C={C}) kernel {k_ms:.3f} ms "
          f"({dflops / k_ms * 1e-9:.1f} TFLOP/s of dense work), bound "
          f"{bound_ms:.3f} ms by {bound_by} ({form}; {flops:.3e} flop over "
          f"the operators' {nnz} nonzeros, {nbytes / 1e9:.3f} GB; dense fp32 "
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
    from r8brain_torch.ops import operators, stages
    from r8brain_torch.ops.pallas_frac import KC, frac_whole
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
        if label in RESIDUAL_PATHS:
            (xp, parts, I, D, O, n_win), kw = capture_calls(
                rs, x, (operators,), ("frac_whole",))["frac_whole"]
            skT, _lo = exec_operator(rs.execs[0], parts)
            check_residual(f"the {label} conv stage", xp, skT, I, D, O,
                           n_win, kw.get("kc", KC), kw.get("start", 0))
            del xp, parts
        if label in MATMUL_RECORDS:
            kernel, name = MATMUL_RECORDS[label]
            calls = capture_calls(rs, x, (stages, operators), (kernel,))
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
    torch.matmul (TF32 off; its own error against the float64 product
    printed beside the kernel's) and the chain's own formulation (the
    toeplitz engine's frac_whole call on the un-materialized frames:
    C=1024, 171 blocks at hop 256, L_f = K).  The bound is the smaller of
    the CUDA-core form (2MKN float32 FMA flop over the fp32 peak, A, B and
    C in float32) and the split form (the six bf16 slice products, 6 *
    2MKN flop over the bf16 peak; A and C in float32, B as three bf16
    slices), each the larger of its operations and bytes time."""
    import torch

    from r8brain_torch.ops.pallas_frac import (frac_whole, operator_band,
                                               operator_parts)
    from r8brain_torch.ops.scout import dense_gemm, dense_gemm_ref

    peak_f32, peak_bf16, peak_bytes = peaks
    g = torch.Generator(device=dev).manual_seed(SEED)
    M, K, N = GEMM_M, GEMM_K, GEMM_N
    A = torch.randn((M, K), generator=g, device=dev)
    B = torch.randn((K, N), generator=g, device=dev)
    flops = 2.0 * M * K * N
    io = 4.0 * (M * K + M * N)
    simt = bound(flops, io + 4.0 * K * N, peak_f32, peak_bytes)
    split = bound(6 * flops, io + 2.0 * 3 * K * N, peak_bf16, peak_bytes)
    bound_ms, bound_by, form = best_form(simt, split)
    lib_ms = cuda_ms(lambda: torch.matmul(A, B), reps=10)
    nb = M // CHANNELS
    xp = torch.randn((CHANNELS, (nb - 1) * GEMM_HOP + K), generator=g,
                     device=dev)
    parts = operator_parts(B)
    band = operator_band(parts)
    fw_ms = cuda_ms(lambda: frac_whole(xp, parts, GEMM_HOP, K, N, nb,
                                       band=band),
                    reps=10)
    del xp, parts, band
    ref = dense_gemm_ref(A, B)
    lib_err = max_rel(torch.matmul(A, B), ref)
    print(f"timing {card}: GEMM {M}x{K} @ {K}x{N} ({flops:.3e} flop): "
          f"torch.matmul f32 (TF32 off) {lib_ms:.3f} ms "
          f"({flops / lib_ms * 1e-9:.1f} TFLOP/s, max rel err {lib_err:.3e}"
          f" vs the f64 product); frac_whole on the un-materialized frames "
          f"(C={CHANNELS}, {nb} blocks, hop {GEMM_HOP}; the bf16 split form "
          f"with two_sum folds) {fw_ms:.3f} ms "
          f"({flops / fw_ms * 1e-9:.1f} TFLOP/s of the function)")
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
              f"ms ({flops / k_ms * 1e-9:.1f} TFLOP/s of the function, "
              f"{6 * flops / k_ms * 1e-9:.1f} bf16 TFLOP/s of slice products;"
              f" B split and packed in the call), {lib_ms / k_ms:.2f}x "
              f"torch.matmul; bound {bound_ms:.3f} ms by {bound_by} "
              f"({form}; CUDA cores {simt[0]:.3f} ms, bf16 split "
              f"{split[0]:.3f} ms), plain (f64 torch.matmul) {p_ms:.3f} ms; "
              f"max rel err {err:.3e} (torch.matmul {lib_err:.3e}; tol "
              f"{DENSE_REL_TOL:g})")
        records.append({
            "name": f"dense_gemm[mt={mt}{'' if hop is None else ', seg'}]",
            "route": "cuda", "source": "r8brain_torch/csrc/dense_gemm.cu",
            "replaces": rep, "launches": 0, "max_abs_err": max_abs,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
    del A, B, ref
    torch.cuda.empty_cache()
    return records


def uniform_input(dev, n: int):
    """CHANNELS x n full-scale uniform float32 from SEED, on dev."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    return torch.rand((CHANNELS, n), generator=g, device=dev) * 2 - 1


def f64_reference(src, dst, x):
    """The port's float64 CPU path on x's first N_CMP channels."""
    import torch

    from r8brain_torch import Resampler

    return Resampler(src, dst, TB, ATTEN, dtype=torch.float64,
                     device="cpu").oneshot(x[:N_CMP].cpu().double()).numpy()


def record_run(fn, modules, name):
    """fn() with every call of the kernel wrapper ``name`` that
    ``modules`` make recorded, in order, as (args, kw) (held); the wrapper
    itself still runs (and counts).  Returns (fn's result, calls)."""
    calls = []
    real = getattr(modules[0], name)

    def rec(*args, **kw):
        calls.append((held(name, args), kw))
        return real(*args, **kw)

    try:
        for m in modules:
            setattr(m, name, rec)
        out = fn()
    finally:
        for m in modules:
            setattr(m, name, real)
    return out, calls


def record_calls(rs, x, modules, name):
    """record_run of rs.oneshot(x)."""
    return record_run(lambda: rs.oneshot(x), modules, name)


def owner(rs, parts):
    """The executor of rs that holds the packed operator ``parts``."""
    for ex in rs.execs:
        if exec_parts(ex) is parts:
            return ex
    raise SmokeFailure("a kernel call got an operator of no executor")


def channel_chunks(C: int, per_channel: int, budget: int = 1 << 28):
    """Channel ranges whose float32 temporaries of per_channel elements a
    channel stay under ``budget`` elements (the plain versions hold
    several at once)."""
    step = max(1, budget // max(1, per_channel))
    return [(c0, min(C, c0 + step)) for c0 in range(0, C, step)]


def library_call(ex, xp, skT, I, dtype):
    """(function of no arguments, what it is): the one PyTorch call that
    computes a frac_whole or ozaki_framed call's function on its input
    xp, TF32 off: the half-band kernel (4*nt - 1 taps) by
    F.conv_transpose1d at stride 2 (up) or F.conv1d at stride 2 (down),
    the cascade's composite by F.conv_transpose1d at stride U, else the
    operator's columns by F.conv1d at stride I."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.hb_cascade import _hb_full_kernel, compose_run

    kind = type(ex).__name__
    u = xp.to(dtype)[:, None, :]
    if kind in ("HBUpExec", "HBDownExec"):
        w = torch.from_numpy(_hb_full_kernel(ex.spec)).to(xp.device, dtype)
        if kind == "HBUpExec":
            return (lambda: F.conv_transpose1d(u, w[None, None], stride=2),
                    f"F.conv_transpose1d ({w.numel()} taps, stride 2)")
        return (lambda: F.conv1d(u, w[None, None], stride=2),
                f"F.conv1d ({w.numel()} taps, stride 2)")
    if kind == "HBUpCascadeExec":
        Gc, _S, U = compose_run(ex.specs)
        w = torch.from_numpy(Gc).to(xp.device, dtype)[None, None]
        return (lambda: F.conv_transpose1d(u, w, stride=U),
                f"F.conv_transpose1d (composite, {Gc.size} taps, stride "
                f"{U})")
    w = skT.to(dtype).T.contiguous()[:, None, :]
    return (lambda: F.conv1d(u, w, stride=I),
            f"F.conv1d ({w.shape[0]} columns of {w.shape[2]}, stride {I})")


def frac_record(name, call, ex, launches, peaks, card,
                expect_lo: bool = False):
    """One frac_whole call of a path (``ex`` made it), replayed as the path
    made it (on the stage's input read in place from its window origin
    ``start``): against its plain
    model (within MODEL_REL_TOL of max |y|) and its float64 product
    (KERNEL_REL_TOL), in channel chunks, its bias held (frac_beta); with
    skT_lo (which ``expect_lo``
    requires) its residual slice held with a planted skT_lo
    (check_residual) and the kernel timed at both fold lengths; timed beside the plain version (the same chunks)
    and library_call (float32; float64 of skT + skT_lo with skT_lo) on
    the call's framed copy.  The
    bound counts the operator's nonzero entries (frac_bounds)."""
    import torch

    from r8brain_torch.ops.framing import shifted
    from r8brain_torch.ops.pallas_frac import (KC, KC_LO, frac_whole,
                                               frac_whole_ref, operator_parts)

    (xp, parts, I, D, O, n_win), kw = call
    kc, band, start = kw.get("kc", KC), kw["band"], kw.get("start", 0)
    skT, lo = exec_operator(ex, parts)
    if expect_lo:
        check(lo is not None, f"{name}: the call has no skT_lo")
    C = xp.shape[0]
    chunks = channel_chunks(C, n_win * O)
    y = frac_whole(xp, parts, I, D, O, n_win, kc=kc, band=band, start=start)
    p64 = operator_parts(skT.double(), None if lo is None else lo.double())
    e_m = e_r = scale = 0.0
    sums = sums_m = (0.0, 0.0, 0)
    for c0, c1 in chunks:
        m = frac_whole_ref(xp[c0:c1], parts, I, D, O, n_win, kc=kc,
                           band=band, start=start).double()
        r = frac_whole_ref(xp[c0:c1].double(), p64, I, D, O, n_win,
                           start=start)
        yc = y[c0:c1].double()
        e_m = max(e_m, float((yc - m).abs().max().item()))
        e_r = max(e_r, float((yc - r).abs().max().item()))
        scale = max(scale, float(r.abs().max().item()))
        sums = tuple(a + b for a, b in zip(sums, beta_sums(yc, r)))
        sums_m = tuple(a + b for a, b in zip(sums_m, beta_sums(m, r)))
        del m, r, yc
    db = 10.0 * math.log10(sums[1] / y.numel() + 1e-300)
    beta, beta_m = frac_beta(name, sums, sums_m)
    del y
    torch.cuda.empty_cache()
    err_m, err = e_m / scale, e_r / scale
    check(err_m <= MODEL_REL_TOL, f"{name}: {err_m:.3e} of max |y| from "
          f"the plain model (tol {MODEL_REL_TOL:.2e})")
    check(err <= KERNEL_REL_TOL, f"{name}: max rel err {err:.3e} vs f64 "
          f"plain")
    if lo is not None:
        check_residual(name, xp, skT, I, D, O, n_win, kc, start)
    ms = {k: cuda_ms(lambda: frac_whole(xp, parts, I, D, O, n_win, kc=k,
                                        band=band, start=start),
                     reps=10)
          for k in ((KC_LO, KC) if lo is not None else (kc,))}
    k_ms = ms[kc]
    p_ms = cuda_ms(lambda: [frac_whole_ref(xp[c0:c1], parts, I, D, O, n_win,
                                           kc=kc, band=band, start=start)
                            for c0, c1 in chunks],
                   reps=2, warmup=1)
    lib_dt = torch.float32 if lo is None else torch.float64
    lib, lib_what = library_call(
        ex, shifted(xp, start, (n_win - 1) * I + D, xp.dtype),
        skT if lo is None else skT.double() + lo.double(), I, lib_dt)
    lib_ms = cuda_ms(lib, reps=3, warmup=1)
    torch.cuda.empty_cache()
    R = C * n_win
    nnz = int((skT != 0).sum().item())
    nnz_lo = None if lo is None else int((lo != 0).sum().item())
    io = 4.0 * (C * ((n_win - 1) * I + D) + R * O)
    (bound_ms, bound_by, form), simt, split = frac_bounds(R, nnz, nnz_lo, io,
                                                          D, O, peaks)
    folds = "".join(f", fold {k}: {t:.3f} ms" for k, t in ms.items()
                    if k != kc)
    print(f"timing {card}: {name} I={I} D={D} O={O} C={C} n_win={n_win}, "
          f"fold {kc}{', skT_lo' if lo is not None else ''}: kernel "
          f"{k_ms:.3f} ms{folds}, bound {bound_ms:.3f} ms by {bound_by} "
          f"({form}; "
          f"CUDA cores {simt[0]:.3f} ms by {simt[1]}, bf16 split "
          f"{split[0]:.3f} ms by {split[1]}; over the operator's {nnz} "
          f"nonzeros of {D * O}), plain frac_whole_ref {p_ms:.3f} ms "
          f"({len(chunks)} channel chunks), {lib_what} "
          f"{'f32' if lo is None else 'f64'} {lib_ms:.3f} ms; "
          f"{db:.2f} dB re full scale vs f64 plain, max rel err {err:.3e} "
          f"(tol {KERNEL_REL_TOL:g}), {err_m:.3e} of max |y| from the model "
          f"(tol {MODEL_REL_TOL:.2e}), beta {beta:+.4f} (model "
          f"{beta_m:+.4f})")
    return {"name": name, "route": "cuda",
            "source": "r8brain_torch/csrc/frac_whole.cu",
            "replaces": "r8brain_tpu/ops/pallas_frac.py:111",
            "launches": launches, "max_abs_err": e_r, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def poly_parts_ms(ex, v, reps: int = 5):
    """A "high" polynomial stage's contractions timed apart over its
    cached state (the operators of input ``v``'s last apply): the main
    product in IEEE float32 (what "fast" runs), in float64 on the
    chunks' spans (what "high" runs), and the spline residual pass."""
    import torch.nn.functional as F

    from r8brain_torch.ops.stages import _ieee_fp32, banded_contract

    S, W = ex.S, ex.W
    chunks, need_len, pad_l = list(ex._state.values())[-1]
    xp = F.pad(v, (pad_l, max(0, need_len - (v.shape[1] + pad_l))))
    span = -(-W // S) * S

    def main32():
        with _ieee_fp32():
            for A, nloc, ops in chunks:
                banded_contract(xp[:, A:], ops["R"], nloc, S, W)

    def main64():
        for A, nloc, ops in chunks:
            banded_contract(xp[:, A : A + nloc * S + span].double(),
                            ops["R64"], nloc, S, W)

    def resid():
        for A, nloc, ops in chunks:
            banded_contract(xp[:, A:], ops["R_lo"], nloc, S, W)

    return {k: cuda_ms(f, reps=reps) for k, f in
            (("f32 main", main32), ("f64 main", main64),
             ("spline residual", resid))}, len(chunks)


def poly_dot_record(label, ex, v, m, card, launches):
    """poly_dot at the polynomial stage's seam call
    (tools/torch_poly_dot.py seam_call): one launch a stage call, within
    ``abs_bound`` of its plain version and of the banded contraction it
    replaces, timed beside the bytes' bound, the plain version and the
    library yardstick (the stage on the banded contraction).  launches:
    the kernel's launches in the path's own first oneshot (stage_paths),
    the record's count."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_poly_dot

    sc = torch_poly_dot.seam_call(ex, v, m)
    shape = " ".join(f"{k}={x}" for k, x in sc["shape"].items())
    check(sc["launches"] == 1 and sc["same_shape"], f"{label}: poly_dot "
          f"launched {sc['launches']} times a stage call, shapes equal to "
          f"the banded contraction's: {sc['same_shape']}")
    check(sc["of_bound_plain"] <= 1.0 and sc["of_bound_banded"] <= 1.0,
          f"{label}: poly_dot at {sc['of_bound_plain']:.3f} / "
          f"{sc['of_bound_banded']:.3f} of abs_bound from its plain version "
          f"/ the banded contraction")
    print(f"timing {card}: poly_dot ({label}, {shape}) kernel "
          f"{sc['kernel_ms']:.4f} ms, bound {sc['bound_ms']:.4f} ms by bytes "
          f"({sc['mbytes']:.1f} MB), plain poly_dot_ref {sc['plain_ms']:.3f} "
          f"ms, the stage on the banded contraction {sc['banded_ms']:.3f} ms; "
          f"{sc['of_bound_plain']:.3f} / {sc['of_bound_banded']:.3f} of "
          f"abs_bound from the plain version / the banded contraction")
    return {"name": f"poly_dot[{label}]", "route": "cuda",
            "source": "r8brain_torch/csrc/poly_dot.cu",
            "replaces": "none (r8brain_tpu/ops/stages.py FracPolyExec is XLA)",
            "launches": launches, "max_abs_err": sc["max_abs"],
            "ms": sc["kernel_ms"], "plain_ms": sc["plain_ms"],
            "bound_ms": sc["bound_ms"], "bound_by": "bytes",
            "library_ms": sc["banded_ms"]}


def stage_paths(dev, peaks, card):
    """The half-band, cascade and polynomial paths (STAGE_PATHS), each
    counted (frac_whole's and poly_dot's launches set to 0 just before,
    read just after, and held to the path's counts), checked against the
    port's float64 CPU path and timed; PCM -> DSD64's device memory peak held under PEAK_GB; the
    polynomial stage timed alone (under "fast" its ``poly_dot`` record,
    ``poly_dot_record``) and the fast chain run again with TF32 on
    (bit-equal: its polynomial stage runs no matmul).  Every
    frac_whole call shape no earlier phase recorded gets a record
    (frac_record)."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import operators
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.poly_dot import poly_dot

    refs, records, seen = {}, [], set(FRAC_SHAPES_SEEN)
    for label, src, dst, secs, prec, want, want_pd, bound_db in STAGE_PATHS:
        n = int(round(src * secs))
        x = uniform_input(dev, n)
        if (src, dst, n) not in refs:
            refs[(src, dst, n)] = f64_reference(src, dst, x)
        r64, sk = refs[(src, dst, n)], int(EDGE_S * dst)
        rs = Resampler(src, dst, TB, ATTEN, precision=prec, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frac_whole.launches = poly_dot.launches = 0
        t0 = time.perf_counter()
        out, calls = record_calls(rs, x, (operators,), "frac_whole")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got, got_pd = frac_whole.launches, poly_dot.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        out_len = rs.default_out_len(n)
        check(tuple(out.shape) == (CHANNELS, out_len),
              f"{label} oneshot shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{label} output not finite")
        check(got == want == len(calls), f"path {label} launched frac_whole "
              f"{got} times ({len(calls)} calls), want {want}")
        check(got_pd == want_pd, f"path {label} launched poly_dot {got_pd} "
              f"times, want {want_pd}")
        db = rms_db(out[:N_CMP].cpu().double().numpy()[:, sk:-sk]
                    - r64[:, sk:-sk])
        print(f"stage path {label}: Resampler({src}, {dst}, {TB}, {ATTEN}, "
              f"precision='{prec}') {CHANNELS} x {n} -> {tuple(out.shape)}; "
              f"executors {[type(e).__name__ for e in rs.execs]}; {N_CMP} "
              f"channels vs port f64 CPU path {db:.2f} dB re full scale "
              f"(bound {bound_db:g}, {EDGE_S * 1e3:g} ms edge skip); "
              f"frac_whole launches {got}, poly_dot {got_pd}; device memory "
              f"peak {peak:.2f} GB")
        check(db <= bound_db, f"stage path {label}: {db:.2f} dB misses "
              f"{bound_db:g} dB")
        check(peak <= PEAK_GB, f"stage path {label}: {peak:.2f} GB of "
              f"device memory (limit {PEAK_GB:g})")
        if "96001 fast" in label:
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                out_tf32 = rs.oneshot(x)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            check(torch.equal(out_tf32, out), f"{label}: TF32 on changes "
                  f"the output")
            print(f"stage path {label} with TF32 on: bit-equal")
            del out_tf32
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        print(f"timing {card}: stage path {label} oneshot {one_ms:.3f} ms = "
              f"{1e-6 * CHANNELS * n / (one_ms * 1e-3):.1f} Mrops")
        poly = [e for e in rs.execs if type(e).__name__ == "FracPolyExec"]
        if poly:
            print(f"timing {card}: stage path {label} first oneshot "
                  f"(the polynomial stage's state built, host clock) "
                  f"{first_s * 1e3:.1f} ms, cached {one_ms:.3f} ms")
        del out
        if poly:
            i = list(rs.execs).index(poly[0])
            T = max(n, rs.in_len_for_out(out_len))
            v, m = torch.nn.functional.pad(x, (0, T - n)), T
            for e in rs.execs[:i]:
                v, m = e.apply_v(v, m)
            p_ms = cuda_ms(lambda: poly[0].apply_v(v, m), reps=5)
            print(f"timing {card}: {label} polynomial stage ("
                  f"{'poly_dot' if prec == 'fast' else 'banded'}, "
                  f"S={poly[0].S} G={poly[0].G} W={poly[0].W}) "
                  f"{p_ms:.3f} ms")
            if prec == "fast":
                records.append(poly_dot_record(label, poly[0], v, m, card,
                                               got_pd))
            if prec == "high":
                parts_ms, n_chunks = poly_parts_ms(poly[0], v)
                print(f"timing {card}: {label} polynomial stage by part "
                      f"({n_chunks} chunks): " + ", ".join(
                          f"{k} {t:.3f} ms" for k, t in parts_ms.items()))
            del v
        for args, kw in calls:
            _xp, parts, I, D, O, _nw = args
            shape = (I, D, O, parts.shape[2] - (parts.shape[3] == 8),
                     kw.get("kc", 32))
            if shape in seen:
                continue
            seen.add(shape)
            ex = owner(rs, parts)
            kind = {"HBUpExec": "HB up", "HBDownExec": "HB down",
                    "HBUpCascadeExec": f"cascade U={getattr(ex, 'U', 0)}",
                    "FusedUpExec": "fused", "ConvExec": "toeplitz conv"}[
                type(ex).__name__]
            n_shape = sum(1 for a, k in calls if a[2:5] == (I, D, O))
            records.append(frac_record(
                f"frac_whole[{kind}, {label}]", (args, kw), ex, n_shape,
                peaks, card))
        del calls, rs, x
        torch.cuda.empty_cache()
    return records


def ozaki_record(name, rep, geo, case, parts, packed, has_lo, emit,
                 launches, err, lib, peaks, card):
    """ozaki_framed at one geometry and variant, timed beside its plain
    version and ``lib`` (a (function, what) pair, float64); the bound
    counts the slice products of the operator's nonzero entries (the
    kernel multiplies it dense)."""
    from r8brain_torch.ops.ozaki import N_PARTS
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed, ozaki_framed_ref

    peak_f32, peak_bf16, peak_bytes = peaks
    L_f, hop, Kcols, nb = geo
    xp, sx, xl, _p = case
    lo = xl if has_lo else None
    args = (xp, sx, parts, L_f, hop, Kcols, nb)
    k_ms = cuda_ms(lambda: ozaki_framed(*args, x_lo=lo, emit_pair=emit,
                                        packed=packed), reps=10)
    p_ms = cuda_ms(lambda: ozaki_framed_ref(*args, x_lo=lo, emit_pair=emit),
                   reps=2, warmup=1)
    lib_fn, lib_what = lib
    lib_ms = cuda_ms(lib_fn, reps=3, warmup=1)
    C = xp.shape[0]
    nnz = int((parts != 0).any(dim=0).sum().item())
    flops = (10 + has_lo) * 2.0 * C * nb * nnz
    dense = 10 * 2.0 * C * nb * L_f * Kcols
    nbytes = (4.0 * xp.numel() + 4 * C + 2 * N_PARTS * nnz
              + 2.0 * has_lo * xp.numel() + (4.0 + 2 * emit) * C * nb * Kcols)
    bound_ms, bound_by = bound(flops, nbytes, peak_bf16, peak_bytes)
    print(f"timing {card}: {name} (L_f={L_f} hop={hop} Kcols={Kcols} "
          f"n_blocks={nb} C={C}, x_lo={has_lo}, emit_pair={emit}) kernel "
          f"{k_ms:.3f} ms ({dense / k_ms * 1e-9:.1f} bf16 TFLOP/s of dense "
          f"slice products), bound {bound_ms:.3f} ms by {bound_by} "
          f"({flops:.3e} flop over the operator's {nnz} nonzeros of "
          f"{L_f * Kcols}, {nbytes / 1e9:.3f} GB; dense operator "
          f"{dense:.3e} flop, "
          f"{bound(dense, nbytes, peak_bf16, peak_bytes)[0]:.3f} ms), plain "
          f"ozaki_framed_ref {p_ms:.3f} ms, {lib_what} f64 {lib_ms:.3f} ms")
    return {"name": name, "route": "cuda",
            "source": "r8brain_torch/csrc/ozaki_framed.cu",
            "replaces": f"r8brain_tpu/ops/{rep}", "launches": launches,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def ozaki_replaces(ex, has_lo: bool, emit: bool) -> str:
    """The TPU kernel an ozaki_framed call of executor ``ex`` in variant
    (x_lo, emit_pair) replaces: the frac stage's dense kernels, the other
    stages' framed ones."""
    if type(ex).__name__ == "FracWholeExec":
        return "pallas_ozaki.py:207" if emit else "pallas_ozaki.py:232"
    return ("pallas_ozaki.py:263" if has_lo or emit else
            "pallas_ozaki.py:317")


def ozaki_paths(dev, peaks, card):
    """The guarantee chains of OZ_PATHS, carry on and off: counted (every
    ozaki_framed call recorded with its geometry), held to -150 / -141 dB
    relative to the port's float64 CPU path, timed.  Each geometry no
    earlier phase checked (the half-band ones among them) gets every
    variant held to ozaki_framed_ref and the float64 product
    (check_ozaki_variants), and a record per variant the paths run."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops import operators
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed

    refs, runs = {}, []
    for label, src, dst in OZ_PATHS:
        x = uniform_input(dev, src)
        if (src, dst) not in refs:
            refs[(src, dst)] = f64_reference(src, dst, x)
        r64, sk = refs[(src, dst)], int(EDGE_S * dst)
        r64s = r64[:, sk:-sk]
        for carry in (True, False):
            old = os.environ.get("R8BT_DF_CARRY")
            os.environ["R8BT_DF_CARRY"] = "1" if carry else "0"
            try:
                rs = Resampler(src, dst, TB, ATTEN, precision="high",
                               conv_engine="ozaki", frac_engine="ozaki",
                               device=dev)
            finally:
                if old is None:
                    del os.environ["R8BT_DF_CARRY"]
                else:
                    os.environ["R8BT_DF_CARRY"] = old
            check(rs.df_carry == carry, f"{label}: df_carry is "
                  f"{rs.df_carry}")
            ozaki_framed.launches = 0
            ozaki_framed.launches_by.clear()
            out, calls = record_calls(rs, x, (operators,), "ozaki_framed")
            torch.cuda.synchronize()
            by = dict(ozaki_framed.launches_by)
            n_st = sum(type(e).__name__ != "FracPolyExec" for e in rs.execs)
            check(ozaki_framed.launches == len(calls) == n_st,
                  f"guarantee {label} carry={carry}: {ozaki_framed.launches}"
                  f" ozaki_framed launches, want one a stage ({n_st})")
            check(tuple(out.shape) == (CHANNELS, rs.default_out_len(src)),
                  f"guarantee {label} shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"guarantee {label} "
                  f"output not finite")
            d = out[:N_CMP].cpu().double().numpy()[:, sk:-sk] - r64s
            db = rms_db(d) - rms_db(r64s)
            bound_db = OZ_CARRY_DB if carry else OZ_NOCARRY_DB
            print(f"guarantee chain {label}, carry {'on' if carry else 'off'}"
                  f": Resampler({src}, {dst}, {TB}, {ATTEN}, precision="
                  f"'high', conv_engine='ozaki', frac_engine='ozaki') "
                  f"{CHANNELS} x {src} -> {tuple(out.shape)}; executors "
                  f"{[type(e).__name__ + ':' + e.engine for e in rs.execs]}; "
                  f"{N_CMP} channels vs port f64 CPU path {db:.2f} dB "
                  f"relative (bound {bound_db:g}); ozaki_framed launches by "
                  f"(hop, L_f, Kcols, has_lo, emit_pair) {by}")
            check(db <= bound_db, f"guarantee {label} carry={carry}: "
                  f"{db:.2f} dB misses {bound_db:g} dB")
            del out
            one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
            print(f"timing {card}: guarantee {label} oneshot carry "
                  f"{'on' if carry else 'off'} {one_ms:.3f} ms = "
                  f"{1e-6 * CHANNELS * src / (one_ms * 1e-3):.1f} Mrops")
            runs.append((f"{label}, carry {'on' if carry else 'off'}", rs,
                         calls, by))
        del x
    records, geos = [], {}
    g = torch.Generator(device=dev).manual_seed(SEED)
    for run_label, rs, calls, by in runs:
        for args, kw in calls:
            _xp, _sx, parts, L_f, hop, Kcols, nb = args
            if (hop, L_f, Kcols) in OZ_GEOS_SEEN:
                continue
            key = (hop, L_f, Kcols, kw.get("x_lo") is not None,
                   bool(kw.get("emit_pair")))
            ex = owner(rs, parts)
            if (hop, L_f, Kcols) not in geos:
                geo = (L_f, hop, Kcols, nb)
                case = ozaki_case(dev, g, CHANNELS, *geo, parts)
                errs = check_ozaki_variants(
                    f"{type(ex).__name__} ({run_label})", geo, case, parts,
                    kw["packed"])
                geos[(hop, L_f, Kcols)] = (geo, case, errs, set())
            geo, case, errs, done = geos[(hop, L_f, Kcols)]
            if key[3:] in done:
                continue
            done.add(key[3:])
            kind = type(ex).__name__
            rep = ozaki_replaces(ex, key[3], key[4])
            lib = library_call(ex, case[0], parts.double().sum(dim=0), hop,
                               torch.float64)
            records.append(ozaki_record(
                f"ozaki_framed[{kind}, {run_label}]", rep, geo, case, parts,
                kw["packed"], key[3], key[4], by.get(key, 0),
                errs[key[3:]], lib, peaks, card))
        torch.cuda.empty_cache()
    del runs, geos
    torch.cuda.empty_cache()
    return records


def stream_drive(st, x, k: int):
    """The stream st over x in calls of k whole blocks (k = 1:
    process_block_device, else process_blocks_device); the outputs
    concatenated."""
    import torch

    L = st.block
    if k == 1:
        outs = [st.process_block_device(x[:, i : i + L])
                for i in range(0, x.shape[1], L)]
    else:
        outs = [st.process_blocks_device(x[:, i : i + k * L])
                for i in range(0, x.shape[1], k * L)]
    return torch.cat(outs, dim=1)


def device_busy_ms(fn, reps: int):
    """Device time of fn() a call, ms: every kernel's time that
    torch.profiler traces over ``reps`` calls, summed (None when it
    traces none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / reps if busy > 0 else None


def stream_timing(label, st, xb, k: int, src, card):
    """Steady calls of k blocks (xb) timed with CUDA events after a
    warm-up call: ms a block, Mrops (1e-6 x channels x input samples /
    s), real-time streams (channels x block seconds / s), and the device's
    idle share (1 - the profiler's kernel time / the events' time)."""
    C, L = xb.shape[0], st.block
    if k == 1:
        def fn():
            st.process_block_device(xb)
    else:
        def fn():
            st.process_blocks_device(xb)
    reps = max(2, 16 // k)
    ms = cuda_ms(fn, reps=reps, warmup=1)
    busy = device_busy_ms(fn, reps)
    idle = "not measured" if busy is None else \
        f"{100.0 * (1.0 - busy / ms):.1f} %"
    busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
    how = "per block" if k == 1 else f"k={k} blocks a call"
    print(f"timing {card}: stream {label}, {how}: {ms:.3f} ms a call, "
          f"{ms / k:.3f} ms a block of {C} x {L}, "
          f"{1e-6 * C * L * k / (ms * 1e-3):.1f} Mrops, "
          f"{C * (L / src) * k / (ms * 1e-3):.0f} real-time streams; "
          f"device busy {busy_s} a call, idle {idle}")


def stream_frac_records(label, rs, calls, seen, peaks, card):
    """A record (frac_record) for each frac_whole call shape of a stream
    run that no earlier stream phase recorded: the operator (I, D, O,
    slices, fold), its window count and whether its rows are one block's
    channels or several blocks batched (a k-block call, or the suffix
    ring's whole blocks; held at the first row count the run gave it);
    launches: the run's calls of that shape."""
    records = []
    for args, kw in calls:
        xp, parts, I, D, O, n_win = args
        batch = xp.shape[0] > CHANNELS
        shape = (I, D, O, parts.shape[2] - (parts.shape[3] == 8),
                 kw.get("kc", 32), n_win, batch)
        if shape in seen:
            continue
        seen.add(shape)
        ex = owner(rs, parts)
        kind = {"HBUpExec": "HB up", "HBDownExec": "HB down",
                "FusedUpExec": "fused", "ConvExec": "toeplitz conv",
                "FracWholeExec": "frac stage"}[type(ex).__name__]
        n_shape = sum(1 for a, _k in calls if a[2:6] == (I, D, O, n_win)
                      and (a[0].shape[0] > CHANNELS) == batch)
        records.append(frac_record(
            f"frac_whole[{kind}, stream {label}, "
            f"{'blocks batched' if batch else 'one block'}, n_win={n_win}]",
            (args, kw), ex, n_shape, peaks, card))
    return records


def stream_ozaki_records(label, rs, calls, seen, dev, peaks, card):
    """Each ozaki_framed geometry of a guarantee stream run that no
    earlier stream phase checked (hop, L_f, Kcols, n_blocks, one block or
    several batched): every variant against its plain version and the
    float64 product at the call's row count (check_ozaki_variants), and
    a record (ozaki_record) for each variant the run made."""
    import torch

    records = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for args, kw in calls:
        xp, _sx, parts, L_f, hop, Kcols, nb = args
        batch = xp.shape[0] > CHANNELS
        key = (hop, L_f, Kcols, nb, batch)
        var = (kw.get("x_lo") is not None, bool(kw.get("emit_pair")))
        if key + var in seen:
            continue
        seen.add(key + var)
        ex = owner(rs, parts)
        geo = (L_f, hop, Kcols, nb)
        case = ozaki_case(dev, g, xp.shape[0], *geo, parts)
        errs = check_ozaki_variants(
            f"{type(ex).__name__} (stream {label}, "
            f"{'blocks batched' if batch else 'one block'})", geo, case,
            parts, kw["packed"])
        rep = ozaki_replaces(ex, *var)
        n_key = sum(1 for a, k_ in calls if tuple(a[3:7]) == geo
                    and (a[0].shape[0] > CHANNELS) == batch
                    and (k_.get("x_lo") is not None,
                         bool(k_.get("emit_pair"))) == var)
        lib = library_call(ex, case[0], parts.double().sum(dim=0), hop,
                           torch.float64)
        records.append(ozaki_record(
            f"ozaki_framed[{type(ex).__name__}, stream {label}, "
            f"{'blocks batched' if batch else 'one block'}, n_blocks={nb}]",
            rep, geo, case, parts, kw["packed"], var[0], var[1], n_key,
            errs[var], lib, peaks, card))
        del case
        torch.cuda.empty_cache()
    return records


def stream_fft_records(label, calls, seen, peaks, card):
    """A record (fft_record) for each df_fft_conv call shape of a stream
    run that no earlier stream phase recorded: (mode, n, head, frames a
    row, rows); launches: the run's calls of that shape."""
    records = []
    for args, kw in calls:
        u, plan, n_frames, head = args
        shape = (plan.mode(head), plan.n, head, n_frames, u.shape[0])
        if shape in seen:
            continue
        seen.add(shape)
        n_shape = sum(1 for a, _k in calls
                      if (a[1].mode(a[3]), a[1].n, a[3], a[2], a[0].shape[0])
                      == shape)
        batch = u.shape[0] > CHANNELS
        records.append(fft_record(
            f"stream {label}, {'blocks batched' if batch else 'one block'}, "
            f"{n_frames} frames", (args, kw), FFT_REPLACES[shape[0]],
            n_shape, peaks, card))
    return records


def stream_paths(dev, peaks, peaks64, card):
    """The push-mode stream phases (STREAM_PATHS) on CHANNELS channels,
    block_len STREAM_BLOCK: each stream driven per block and in calls of
    STREAM_K blocks, each run counted (launch counts set to 0 just before
    it and read just after; every kernel call recorded), checked against
    the port's float64 CPU oneshot on N_CMP channels, k-block output held
    bit-equal to per-block output on the rational plans (the polynomial
    plans' agreement printed), the interpolator's path checked (one window base
    per block; spans per k-block call).  Every new kernel call shape gets
    a record; the steady calls are timed; 44.1k -> 96001 fast resumes a
    mid-stream checkpoint bit for bit.  Then the chunked oneshot."""
    import torch

    from r8brain_torch import Resampler, StreamResampler
    from r8brain_torch.ops import operators, stages
    from r8brain_torch.ops.pallas_dfft import df_fft_conv
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed

    records, seen_f, seen_o, seen_d = [], set(), set(), set()
    for label, src, dst, kw, bound_db, rel, tail_path in STREAM_PATHS:
        rs = Resampler(src, dst, TB, ATTEN, device=dev, **kw)
        streams = {k: StreamResampler(rs, STREAM_BLOCK)
                   for k in (1, STREAM_K)}
        L = streams[1].block
        n = STREAM_K * STREAM_CALLS * L
        x = uniform_input(dev, n)
        ref = Resampler(src, dst, TB, ATTEN, dtype=torch.float64,
                        device="cpu").oneshot(
            x[:N_CMP].cpu().double()).numpy()
        sk = int(EDGE_S * dst)
        ys, runs = {}, {}
        fft = "conv_engine" in kw and "fft" in kw["conv_engine"]
        for k, st in streams.items():
            frac_whole.launches = 0
            ozaki_framed.launches = 0
            df_fft_conv.launches = 0
            ((y, dcalls), ocalls), fcalls = record_run(
                lambda: record_run(
                    lambda: record_run(lambda: stream_drive(st, x, k),
                                       (stages,), "df_fft_conv"),
                    (operators,), "ozaki_framed"),
                (operators,), "frac_whole")
            torch.cuda.synchronize()
            got_f, got_o = frac_whole.launches, ozaki_framed.launches
            got_d = df_fft_conv.launches
            check(got_f == len(fcalls) and got_o == len(ocalls)
                  and got_f + got_o > 0, f"stream {label} k={k}: "
                  f"frac_whole {got_f} / ozaki_framed {got_o} launches for "
                  f"{len(fcalls)} / {len(ocalls)} calls")
            check(got_d == len(dcalls) and (got_d > 0) == fft,
                  f"stream {label} k={k}: df_fft_conv {got_d} launches "
                  f"for {len(dcalls)} calls")
            m = y.shape[1]
            check(y.shape[0] == CHANNELS and m > sk, f"stream {label} "
                  f"k={k} output shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"stream {label} k={k} "
                  f"output not finite")
            d = y[:N_CMP, sk:m].cpu().double().numpy() - ref[:, sk:m]
            db = rms_db(d) - (rms_db(ref[:, sk:m]) if rel else 0.0)
            tail = streams[k]._tail
            paths = dict(tail.paths) if tail is not None else {}
            print(f"stream {label}, {'per block' if k == 1 else f'k={k}'}: "
                  f"StreamResampler(Resampler({src}, {dst}, {TB}, {ATTEN}"
                  f"{''.join(f', {a}={b!r}' for a, b in kw.items())}), "
                  f"{STREAM_BLOCK}) block {L}, {CHANNELS} x {n} -> "
                  f"{tuple(y.shape)} in {n // (k * L)} calls; {N_CMP} "
                  f"channels vs port f64 CPU oneshot {db:.2f} dB "
                  f"{'relative' if rel else 're full scale'} (bound "
                  f"{bound_db:g}); launches frac_whole {got_f}, "
                  f"ozaki_framed {got_o}, df_fft_conv {got_d}; "
                  f"interpolator paths {paths}")
            check(db <= bound_db, f"stream {label} k={k}: {db:.2f} dB "
                  f"misses {bound_db:g}")
            if tail_path is not None:
                want = "single" if k == 1 else tail_path
                check(set(paths) == {want}, f"stream {label} k={k}: "
                      f"interpolator paths {paths}, want only {want}")
            ys[k], runs[k] = y, (fcalls, ocalls, dcalls)
        y1, yk = ys[1], ys[STREAM_K]
        m = min(y1.shape[1], yk.shape[1])
        same = y1.shape == yk.shape and torch.equal(y1, yk)
        diff = float((y1[:, :m].double() - yk[:, :m].double()).abs().max()
                     .item()) / float(y1[:, :m].abs().max().item())
        print(f"stream {label}: k={STREAM_K} output vs per-block output: "
              f"{'bit-equal' if same else f'max rel diff {diff:.3e}'}")
        if streams[1]._mode == "period":  # a rational plan
            check(same, f"stream {label}: k-block output not bit-equal to "
                  f"per-block output")
        del ys, y1, yk
        for k in (1, STREAM_K):
            fcalls, ocalls, dcalls = runs[k]
            records += stream_frac_records(label, rs, fcalls, seen_f,
                                           peaks, card)
            records += stream_ozaki_records(label, rs, ocalls, seen_o, dev,
                                            peaks, card)
            records += stream_fft_records(label, dcalls, seen_d, peaks64,
                                          card)
        del runs, fcalls, ocalls, dcalls
        torch.cuda.empty_cache()
        if label == "44.1k->96001 fast":
            # a mid-stream checkpoint, resumed in a fresh stream
            st = streams[STREAM_K]
            xk = x[:, : STREAM_K * L]
            ckpt = st.get_state()
            a = st.process_blocks_device(xk)
            st2 = StreamResampler(rs, STREAM_BLOCK)
            st2.set_state(ckpt)
            b = st2.process_blocks_device(xk)
            check(torch.equal(a, b), f"stream {label}: the resumed "
                  f"checkpoint's output differs")
            mb = sum(v.nbytes for v in _arrays(ckpt)) / 1e6
            print(f"stream {label}: checkpoint after {STREAM_CALLS} calls "
                  f"(host arrays, {mb:.1f} MB) resumed in a fresh stream: "
                  f"next call bit-equal")
            del a, b, st2
        for k, st in streams.items():
            stream_timing(label, st, x[:, : k * L], k, src, card)
        del streams, x, rs
        torch.cuda.empty_cache()
    chunked_oneshot(dev, card)
    return records


def _arrays(state):
    """The host arrays of a stream checkpoint."""
    for v in state.values():
        if isinstance(v, dict):
            yield from _arrays(v)
        elif hasattr(v, "nbytes"):
            yield v


def chunked_oneshot(dev, card):
    """oneshot(max_chunk=CHUNKED_MAX) on CHUNKED_S seconds of 44.1 kHz ->
    96001 Hz, CHANNELS channels (the input on the card): its shape, its
    first CHUNKED_CMP channels against the port's float64 CPU oneshot over
    the whole length, its time (host clock) and its device memory peak
    beside the input and the output it must hold."""
    import torch

    from r8brain_torch import Resampler

    src, dst = 44100, 96001
    n = CHUNKED_S * src
    rs = Resampler(src, dst, TB, ATTEN, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    x = uniform_input(dev, n)
    out_len = rs.default_out_len(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    y = rs.oneshot(x, max_chunk=CHUNKED_MAX)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(tuple(y.shape) == (CHANNELS, out_len), f"chunked oneshot shape "
          f"{tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "chunked oneshot not finite")
    ref = Resampler(src, dst, TB, ATTEN, dtype=torch.float64,
                    device="cpu").oneshot(
        x[:CHUNKED_CMP].cpu().double()).numpy()
    sk = int(EDGE_S * dst)
    db = rms_db(y[:CHUNKED_CMP].cpu().double().numpy()[:, sk:-sk]
                - ref[:, sk:-sk])
    out_gb = y.numel() * y.element_size() / 1e9
    in_gb = x.numel() * x.element_size() / 1e9
    print(f"chunked oneshot: Resampler({src}, {dst}, {TB}, {ATTEN})."
          f"oneshot(x, max_chunk={CHUNKED_MAX}) on {CHANNELS} x {n} "
          f"({CHUNKED_S} s) -> {tuple(y.shape)}; {CHUNKED_CMP} channel(s) "
          f"vs port f64 CPU oneshot over the whole length {db:.2f} dB re "
          f"full scale (bound {CLASS_DB:g})")
    print(f"timing {card}: chunked oneshot {secs * 1e3:.1f} ms (host "
          f"clock) = {1e-6 * CHANNELS * n / secs:.1f} Mrops; device memory "
          f"peak {peak / 1e9:.2f} GB: the {in_gb:.2f} GB input, the "
          f"{out_gb:.2f} GB output, {held / 1e9:.2f} GB that earlier phases "
          f"hold, working set {(peak - base) / 1e9 - out_gb:.2f} GB")
    check(db <= CLASS_DB, f"chunked oneshot: {db:.2f} dB misses "
          f"{CLASS_DB:g}")
    check(peak / 1e9 <= PEAK_GB, f"chunked oneshot: {peak / 1e9:.2f} GB")
    del x, y
    torch.cuda.empty_cache()


def adjoint_record(name, call, ex, launches, peaks, card):
    """frac_whole's adjoint at one backward call's shape (``call``: the
    rows C and the forward's operator, I, D, O, n_win and fold; the kernel
    runs on I' = O, D' = ceil(D/I)*O, O' = I against the re-blocked
    operator, as the backward launches it) on a seeded upstream gradient;
    ``launches``: that call shape's launches in the gradient run.  Against
    its plain model
    (within MODEL_REL_TOL of max |xbar|) and its float64 product
    (KERNEL_REL_TOL) in channel chunks, its bias held (frac_beta), timed
    beside the plain version and
    the library call F.conv_transpose1d (float32, TF32 off, in
    library_call's layout: the transpose of its F.conv1d).  Returns the
    kernel record."""
    import torch
    import torch.nn.functional as F

    from r8brain_torch.ops.pallas_frac import (_adjoint_operator,
                                               adjoint_geometry,
                                               adjoint_parts, frac_whole,
                                               frac_whole_ref, operator_parts)

    C, parts, I, D, O, n_win, kc = call
    skT, lo = exec_operator(ex, parts)
    Ia, Da, Oa, K = adjoint_geometry(I, D, O)
    # the operator and band the backward launches against
    adj, band = _adjoint_operator(parts, I, D, O)
    adj64 = adjoint_parts(operator_parts(
        skT.double(), None if lo is None else lo.double()), I, D, O)
    dev = parts.device
    n_adj = n_win + K - 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    gy = torch.rand((C, n_win * O), generator=g, device=dev) * 2 - 1
    # the backward reads gy in place, (K-1)*O zeros on each side
    g0 = -(K - 1) * O
    chunks = channel_chunks(C, n_adj * Oa)
    y = frac_whole(gy, adj, Ia, Da, Oa, n_adj, kc=kc, band=band, start=g0)
    e_m = e_r = scale = 0.0
    sums = sums_m = (0.0, 0.0, 0)
    for c0, c1 in chunks:
        m = frac_whole_ref(gy[c0:c1], adj, Ia, Da, Oa, n_adj, kc=kc,
                           band=band, start=g0)
        r = frac_whole_ref(gy[c0:c1].double(), adj64, Ia, Da, Oa, n_adj,
                           start=g0)
        yc = y[c0:c1].double()
        e_m = max(e_m, float((yc - m.double()).abs().max().item()))
        e_r = max(e_r, float((yc - r).abs().max().item()))
        scale = max(scale, float(r.abs().max().item()))
        sums = tuple(a + b for a, b in zip(sums, beta_sums(yc, r)))
        sums_m = tuple(a + b for a, b in zip(sums_m, beta_sums(m, r)))
        del m, r, yc
    beta, beta_m = frac_beta(name, sums, sums_m)
    del y
    err_m, err = e_m / scale, e_r / scale
    check(err_m <= MODEL_REL_TOL, f"{name}: {err_m:.3e} of max |xbar| from "
          f"the plain model (tol {MODEL_REL_TOL:.2e})")
    check(err <= KERNEL_REL_TOL, f"{name}: max rel err {err:.3e} vs f64")
    k_ms = cuda_ms(lambda: frac_whole(gy, adj, Ia, Da, Oa, n_adj, kc=kc,
                                      band=band, start=g0),
                   reps=10)
    p_ms = cuda_ms(lambda: [frac_whole_ref(gy[c0:c1], adj, Ia, Da, Oa,
                                           n_adj, kc=kc, band=band,
                                           start=g0)
                            for c0, c1 in chunks], reps=2, warmup=1)
    u = gy.reshape(C, n_win, O).transpose(1, 2).contiguous()
    wt = skT.float().T.contiguous()[:, None, :]
    lib_ms = cuda_ms(lambda: F.conv_transpose1d(u, wt, stride=I), reps=3,
                     warmup=1)
    del u, gy
    torch.cuda.empty_cache()
    R = C * n_adj
    nnz = int((skT != 0).sum().item())
    nnz_lo = None if lo is None else int((lo != 0).sum().item())
    io = 4.0 * (C * ((n_adj - 1) * Ia + Da) + R * Oa)
    (bound_ms, bound_by, form), simt, split = frac_bounds(R, nnz, nnz_lo, io,
                                                          Da, Oa, peaks)
    print(f"timing {card}: {name} I'={Ia} D'={Da} O'={Oa} C={C} "
          f"n_win={n_adj} (forward I={I} D={D} O={O}), fold {kc}"
          f"{', skT_lo' if lo is not None else ''}: kernel {k_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms by {bound_by} ({form}; CUDA cores "
          f"{simt[0]:.3f} ms by {simt[1]}, bf16 split {split[0]:.3f} ms by "
          f"{split[1]}; over the operator's {nnz} nonzeros of {Da * Oa}), "
          f"plain frac_whole_ref {p_ms:.3f} ms ({len(chunks)} channel "
          f"chunks), F.conv_transpose1d f32 {lib_ms:.3f} ms; max rel err "
          f"{err:.3e} vs f64 (tol {KERNEL_REL_TOL:g}), {err_m:.3e} of max "
          f"|xbar| from the model (tol {MODEL_REL_TOL:.2e}), beta "
          f"{beta:+.4f} (model {beta_m:+.4f}); adjoint launches a gradient "
          f"{launches}")
    return {"name": name, "route": "cuda",
            "source": "r8brain_torch/csrc/frac_whole.cu",
            "replaces": "r8brain_tpu/ops/pallas_frac.py:111",
            "launches": launches, "max_abs_err": e_r, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def record_adjoints(fn):
    """fn() with every backward call of frac_whole recorded: (rows, the
    forward's operator buffer, I, D, O, n_win, fold, the kernel launches
    the call made).  Returns (fn's result, calls)."""
    from r8brain_torch.ops import pallas_frac
    from r8brain_torch.ops.pallas_frac import _operator, frac_whole

    calls, real = [], pallas_frac._adjoint

    def rec(gy, parts, I, D, O, n_win, kc, *span):
        before = frac_whole.launches
        out = real(gy, parts, I, D, O, n_win, kc, *span)
        calls.append((gy.shape[0], _operator(parts), I, D, O, n_win, kc,
                      frac_whole.launches - before))
        return out

    pallas_frac._adjoint = rec
    try:
        return fn(), calls
    finally:
        pallas_frac._adjoint = real


def operator_owner(rs, parts):
    """(executor of rs, its packed operator buffer) for ``parts``: the
    buffer itself or, for an operator of a twin (the same plan and class
    on the default engines), the buffer of rs that holds the same
    values."""
    import torch

    for ex in rs.execs:
        b = exec_parts(ex)
        if b is parts or (isinstance(b, torch.Tensor)
                          and b.shape == parts.shape
                          and b.dtype == parts.dtype
                          and torch.equal(b, parts)):
            return ex, b
    raise SmokeFailure("a backward frac_whole call got an operator of no "
                       "executor")


def grad_fn(f, w):
    """x -> grad_x <w, f(x)> (torch.func.grad)."""
    import torch

    return torch.func.grad(lambda v: (w * f(v)).sum())


def functional_paths(dev, peaks, card):
    """The functional transform (FUNC_PATHS) at CHANNELS x 1 s: resample_fn
    bit-equal to oneshot; torch.func.grad of <w, f(x)> for a seeded w,
    counted (launch counts set to 0 just before it, read just after: the
    backward's frac_whole launches are the adjoint's, each backward call
    recorded), held against the float64 CPU gradient on N_CMP channels
    (GRAD_DB relative), a twin chain's also against its default chain's
    on the card (TWIN_GRAD_DB), and the dot-product identity
    (DOT_REL_TOL); forward and forward plus backward timed.  Each adjoint
    call shape of that gradient run gets a record (adjoint_record) with
    its launches in the run.  Returns the records."""
    import torch

    from r8brain_torch import Resampler, resample_fn
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed

    records, seen = [], set()
    for label, src, dst, kw, twin_kw in FUNC_PATHS:
        x = uniform_input(dev, int(src))
        rs = Resampler(src, dst, TB, ATTEN, device=dev, **kw)
        f = resample_fn(rs, x.shape[1])
        y = f(x)
        check(torch.equal(y, rs.oneshot(x)), f"functional {label}: "
              f"resample_fn's forward is not bit-equal to oneshot")
        g_w = torch.Generator(device=dev).manual_seed(SEED + 1)
        w = torch.rand(y.shape, generator=g_w, device=dev) * 2 - 1
        gfun = grad_fn(f, w)
        frac_whole.launches = frac_whole.adjoint_launches = 0
        ozaki_framed.launches = 0
        g, adj_calls = record_adjoints(lambda: gfun(x))
        torch.cuda.synchronize()
        n_fw, n_adj = frac_whole.launches, frac_whole.adjoint_launches
        n_oz = ozaki_framed.launches
        check(sum(c[-1] for c in adj_calls) == n_adj, f"functional {label}:"
              f" the backward calls launched {[c[-1] for c in adj_calls]},"
              f" the adjoint count is {n_adj}")
        check(tuple(g.shape) == tuple(x.shape)
              and bool(torch.isfinite(g).all()), f"functional {label}: "
              f"gradient shape {tuple(g.shape)} or not finite")
        check(n_adj >= 1, f"functional {label}: the gradient never "
              f"launched frac_whole's adjoint")
        if twin_kw is not None:
            check(n_oz >= 1, f"functional {label}: the forward never "
                  f"launched ozaki_framed")
        # the float64 CPU gradient (the twin's plan and precision class)
        rs64 = Resampler(src, dst, TB, ATTEN, dtype=torch.float64,
                         device="cpu")
        wc = w[:N_CMP].cpu().double()
        g64 = grad_fn(resample_fn(rs64, x.shape[1]), wc)(
            x[:N_CMP].cpu().double())
        gc = g[:N_CMP].cpu().double()
        db64 = rms_db(gc - g64) - rms_db(g64)
        lhs = float((w.double() * y.double()).sum().item())
        rhs = float((g.double() * x.double()).sum().item())
        l1 = float((w.double() * y.double()).abs().sum().item())
        dot = abs(lhs - rhs) / l1
        line = (f"functional {label}: resample_fn(Resampler({src}, {dst}, "
                f"{TB}, {ATTEN}{''.join(f', {a}={b!r}' for a, b in kw.items())}"
                f"), {x.shape[1]}) on {CHANNELS} x {x.shape[1]}: forward "
                f"bit-equal to oneshot; torch.func.grad vs the float64 CPU "
                f"gradient on {N_CMP} channels {db64:.2f} dB relative (bound "
                f"{GRAD_DB:g}); <w, f(x)> - <g, x> = {abs(lhs - rhs):.3e}: "
                f"{dot:.3e} of sum |w f(x)| (tol {DOT_REL_TOL:g}), "
                f"{abs(lhs - rhs) / abs(lhs):.3e} of |<w, f(x)>|; launches "
                f"in the gradient: frac_whole {n_fw} ({n_adj} adjoint), "
                f"ozaki_framed {n_oz}")
        if twin_kw is not None:
            rs_d = Resampler(src, dst, TB, ATTEN, device=dev, **twin_kw)
            f_d = resample_fn(rs_d, x.shape[1])
            g_d = grad_fn(f_d, w)(x)
            db_t = rms_db((g - g_d).double()) - rms_db(g_d)
            line += (f"; twin gradient vs the default chain's on the card "
                     f"{db_t:.2f} dB relative (bound {TWIN_GRAD_DB:g})")
            check(db_t <= TWIN_GRAD_DB, f"functional {label}: twin gradient "
                  f"{db_t:.2f} dB from the default chain's")
            del g_d
        else:
            rs_d, f_d = rs, f
        print(line)
        check(db64 <= GRAD_DB, f"functional {label}: gradient "
              f"{db64:.2f} dB from the float64 gradient")
        check(dot <= DOT_REL_TOL, f"functional {label}: the dot-product "
              f"identity misses by {dot:.3e}")
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        f_ms = cuda_ms(lambda: f(x), reps=5, warmup=1)
        g_ms = cuda_ms(lambda: gfun(x), reps=5, warmup=1)
        print(f"timing {card}: functional {label}: oneshot {one_ms:.3f} ms, "
              f"resample_fn forward {f_ms:.3f} ms, forward + backward "
              f"(torch.func.grad) {g_ms:.3f} ms = {g_ms / one_ms:.2f} x the "
              f"oneshot")
        del y, g, g64, gc
        # each adjoint call shape of the gradient run (a twin's operators
        # are its default chain's, by value), with its launches there
        for C, parts, I, D, O, n_win, kc, _n in adj_calls:
            key = (I, D, O, n_win, parts.shape[2], kc)
            if key in seen:
                continue
            seen.add(key)
            ex, buf = operator_owner(rs_d, parts)
            n_key = sum(c[-1] for c in adj_calls
                        if c[2:7] == (I, D, O, n_win, kc))
            records.append(adjoint_record(
                f"frac_whole adjoint[{type(ex).__name__} I={I} D={D} O={O}"
                f"{', skT_lo' if parts.shape[2] == 4 else ''}, {label}"
                f"{', twin' if twin_kw is not None else ''}]",
                (C, buf, I, D, O, n_win, kc), ex, n_key, peaks, card))
        del adj_calls, x, w, rs, rs_d, f, f_d, gfun
        torch.cuda.empty_cache()
    return records


def fused_paths(dev, card):
    """fused=True and fused="poly" (FUSED_PATHS) through oneshot on
    CHANNELS x 1 s: the executor list, counted (frac_whole launched),
    held against the port's float64 CPU path on N_CMP channels, timed
    beside the default chain of the same plan and precision; the first
    call (for fused="poly" its operator build) on the host clock."""
    import torch

    from r8brain_torch import Resampler
    from r8brain_torch.ops.pallas_frac import frac_whole

    refs = {}
    for label, src, dst, kw, bound_db, names in FUSED_PATHS:
        x = uniform_input(dev, int(src))
        if (src, dst) not in refs:
            refs[(src, dst)] = f64_reference(src, dst, x)
        ref, sk = refs[(src, dst)], int(EDGE_S * dst)
        rs = Resampler(src, dst, TB, ATTEN, device=dev, **kw)
        got = [type(e).__name__ for e in rs.execs]
        check(got == names, f"{label}: executors {got}, want {names}")
        t0 = time.perf_counter()
        rs.oneshot(x)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        frac_whole.launches = 0
        out = rs.oneshot(x)
        torch.cuda.synchronize()
        launches = frac_whole.launches
        check(bool(torch.isfinite(out).all()), f"{label}: not finite")
        check(launches >= 1, f"{label}: never launched frac_whole")
        db = rms_db(out[:N_CMP].cpu().double().numpy()[:, sk:-sk]
                    - ref[:, sk:-sk])
        rel = db - rms_db(ref[:, sk:-sk])
        line = (f"fused path {label}: Resampler({src}, {dst}, {TB}, {ATTEN}"
                f"{''.join(f', {a}={b!r}' for a, b in kw.items())}) -> "
                f"{got}, {CHANNELS} x {x.shape[1]} -> {tuple(out.shape)}; "
                f"{N_CMP} channels vs port f64 CPU path {db:.2f} dB re full "
                f"scale ({rel:.2f} relative; bound {bound_db:g}); frac_whole "
                f"launches {launches}; first call {first_ms:.1f} ms (host "
                f"clock)")
        del out
        print(line)
        check(db <= bound_db, f"{label}: {db:.2f} dB misses {bound_db:g}")
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        kw_d = {k: v for k, v in kw.items() if k == "precision"}
        rs_d = Resampler(src, dst, TB, ATTEN, device=dev, **kw_d)
        d_ms = cuda_ms(lambda: rs_d.oneshot(x), reps=5, warmup=1)
        print(f"timing {card}: fused path {label} oneshot {one_ms:.3f} ms = "
              f"{1e-6 * CHANNELS * x.shape[1] / (one_ms * 1e-3):.1f} Mrops; "
              f"the default chain ({[type(e).__name__ for e in rs_d.execs]}"
              f") {d_ms:.3f} ms in the same run")
        del x, rs, rs_d
        torch.cuda.empty_cache()


def frac_shape_records(label, rs, fcalls, seen, peaks, card,
                       launches=None):
    """A record (frac_record) for each frac_whole call shape of a run that
    no earlier run of its phase recorded: (operator, fold, windows,
    rows).  ``rs`` owns the operators (a dict or list of resamplers is
    searched in turn); launches: the run's calls of that shape, or
    ``launches[shape]`` where the calls ran in other processes."""
    records = []
    owners = list(rs.values()) if isinstance(rs, dict) else (
        list(rs) if isinstance(rs, (list, tuple)) else [rs])
    for args, kw in fcalls:
        xp, parts, I, D, O, n_win = args
        key = ("frac", I, D, O, parts.shape[2] - (parts.shape[3] == 8),
               kw.get("kc", 32), n_win, xp.shape[0])
        if key in seen:
            continue
        seen.add(key)
        ex = None
        for r in owners:
            try:
                ex = owner(r, parts)
                break
            except SmokeFailure:
                continue
        check(ex is not None, f"{label}: a frac_whole call got an operator "
              f"of no executor")
        kind = {"HBUpExec": "HB up", "HBDownExec": "HB down",
                "FusedUpExec": "fused", "ConvExec": "toeplitz conv",
                "FracWholeExec": "frac stage"}[type(ex).__name__]
        n_shape = launches[key] if launches is not None else sum(
            1 for a, k_ in fcalls if a[2:6] == (I, D, O, n_win)
            and a[0].shape[0] == xp.shape[0] and a[1] is parts)
        records.append(frac_record(
            f"frac_whole[{kind}, {label}, C={xp.shape[0]}, D={D}, "
            f"n_win={n_win}]", (args, kw), ex, n_shape, peaks, card))
    return records


def shard_records(label, rs, fcalls, dcalls, seen, peaks, peaks64, card,
                  launches=None, rows=None):
    """A record for each frac_whole (frac_shape_records) and df_fft_conv
    (fft_record) call shape of a sharded run that no earlier sharding
    phase recorded: (operator, fold, windows, rows) and (mode, n, head,
    frames, rows); with ``rows``, only the calls of that many rows (a
    shard's, where the run also made unsharded calls)."""
    if rows is not None:
        fcalls = [c for c in fcalls if c[0][0].shape[0] == rows]
        dcalls = [c for c in dcalls if c[0][0].shape[0] == rows]
    records = frac_shape_records(f"sharded {label}", rs, fcalls, seen, peaks,
                                 card, launches)
    for args, kw in dcalls:
        u, plan, n_frames, head = args
        key = ("fft", plan.mode(head), plan.n, head, n_frames, u.shape[0])
        if key in seen:
            continue
        seen.add(key)
        n_shape = sum(1 for a, _k in dcalls
                      if (a[1].mode(a[3]), a[1].n, a[3], a[2],
                          a[0].shape[0]) == key[1:])
        records.append(fft_record(
            f"sharded {label}, C={u.shape[0]}, {n_frames} frames",
            (args, kw), SHARD_FFT_REPLACES, n_shape, peaks64, card))
    return records


def shard_ozaki_records(label, rs, ocalls, seen, dev, peaks, card):
    """Each ozaki_framed geometry of a sharded guarantee run (L_f, hop,
    Kcols, n_blocks, rows) and variant (x_lo, emit_pair) that no earlier
    sharding phase checked: every variant against its plain version and
    the float64 product (check_ozaki_variants), and a record
    (ozaki_record) for each variant the run made; launches: the run's
    calls of that geometry and variant."""
    import torch

    records = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for args, kw in ocalls:
        xp, _sx, parts, L_f, hop, Kcols, nb = args
        geo = (L_f, hop, Kcols, nb)
        var = (kw.get("x_lo") is not None, bool(kw.get("emit_pair")))
        key = ("ozaki", *geo, xp.shape[0]) + var
        if key in seen:
            continue
        seen.add(key)
        ex = owner(rs, parts)
        case = ozaki_case(dev, g, xp.shape[0], *geo, parts)
        errs = check_ozaki_variants(
            f"{type(ex).__name__} (sharded {label}, C={xp.shape[0]})", geo,
            case, parts, kw["packed"])
        rep = ozaki_replaces(ex, *var)
        n_key = sum(1 for a, k_ in ocalls if tuple(a[3:7]) == geo
                    and a[0].shape[0] == xp.shape[0]
                    and (k_.get("x_lo") is not None,
                         bool(k_.get("emit_pair"))) == var)
        lib = library_call(ex, case[0], parts.double().sum(dim=0), hop,
                           torch.float64)
        records.append(ozaki_record(
            f"ozaki_framed[{type(ex).__name__}, sharded {label}, "
            f"C={xp.shape[0]}, n_blocks={nb}]", rep, geo, case, parts,
            kw["packed"], var[0], var[1], n_key, errs[var], lib, peaks,
            card))
        del case
        torch.cuda.empty_cache()
    return records


def on_card(args) -> bool:
    """Whether a recorded kernel call's input lies on the card (the
    float64 CPU references run the plain versions and launch nothing)."""
    return args[0].is_cuda


def shard_run(fn):
    """fn() with the launch counts set to 0 just before and read just
    after, every frac_whole and df_fft_conv call on the card recorded:
    (result, frac_whole calls, df_fft_conv calls, frac_whole launches,
    df_fft_conv launches)."""
    import torch

    from r8brain_torch.ops import operators, stages
    from r8brain_torch.ops.pallas_dfft import df_fft_conv
    from r8brain_torch.ops.pallas_frac import frac_whole

    frac_whole.launches = 0
    df_fft_conv.launches = 0
    (y, dcalls), fcalls = record_run(
        lambda: record_run(fn, (stages,), "df_fft_conv"),
        (operators,), "frac_whole")
    torch.cuda.synchronize()
    fcalls = [c for c in fcalls if on_card(c[0])]
    dcalls = [c for c in dcalls if on_card(c[0])]
    nf, nd = frac_whole.launches, df_fft_conv.launches
    check(nf == len(fcalls) and nd == len(dcalls), f"launches frac_whole "
          f"{nf} / df_fft_conv {nd} for {len(fcalls)} / {len(dcalls)} calls")
    return y, fcalls, dcalls, nf, nd


def shard_timing(card, label, fn_s, fn_u, n_in):
    """The sharded call and the unsharded oneshot timed with CUDA events:
    ms and Mrops."""
    s_ms = cuda_ms(fn_s, reps=5, warmup=1)
    u_ms = cuda_ms(fn_u, reps=5, warmup=1)
    print(f"timing {card}: sharded {label} {s_ms:.3f} ms = "
          f"{1e-6 * CHANNELS * n_in / (s_ms * 1e-3):.1f} Mrops; unsharded "
          f"oneshot {u_ms:.3f} ms = "
          f"{1e-6 * CHANNELS * n_in / (u_ms * 1e-3):.1f} Mrops (in-process "
          f"shards run one after another on one card: the halo recompute "
          f"and the host staging, not scaling)")


def shard_child(rank: int, port: int, q) -> None:
    """One of the two processes of the two-process phase: rank ``rank`` of
    a gloo group on the one card, mesh t2.  The fast flagship on
    CHANNELS x N_IN (this rank loads only its piece), then two
    sharded-stream calls; rank 1 sends its pieces to rank 0, which holds
    them against the unsharded oneshot.  Puts (rank, results) on q."""
    import traceback

    res = {}
    try:
        import torch
        import torch.distributed as dist

        from r8brain_torch import (Mesh, Resampler, ShardedResampler,
                                   ShardedStreamResampler)

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        mesh = Mesh((2,), ("t",), group=dist.group.WORLD)
        rs = Resampler(SRC, DST, TB, ATTEN, device=dev)
        srs = ShardedResampler(rs, mesh)
        x = uniform_input(dev, N_IN)
        rows, t_in, t_out = srs.shard_slices(CHANNELS, N_IN)
        xl = x[rows, t_in].contiguous()

        def one():
            return srs.oneshot(xl, n_in=N_IN, channels=CHANNELS)

        y, fcalls, _d, nf, _nd = shard_run(one)
        res["launches"] = nf
        res["shapes"] = [("frac", a[2], a[3], a[4],
                          a[1].shape[2] - (a[1].shape[3] == 8),
                          k.get("kc", 32), a[5], a[0].shape[0])
                         for a, k in fcalls]
        res["ms"] = cuda_ms(one, reps=5, warmup=1)
        ss = ShardedStreamResampler(rs, mesh, seg_len=SHARD_SEG)
        xs = uniform_input(dev, 2 * ss.block)
        srows, st_in = ss.shard_slices(CHANNELS)
        ys, counts = [], []
        for b in range(2):
            ys.append(ss.process_block(
                xs[srows, b * ss.block + st_in.start :
                   b * ss.block + st_in.stop]))
            counts.append(ss._counts[1])
        ys = torch.cat(ys, dim=1)
        torch.cuda.synchronize()
        if rank == 1:
            dist.send(y.cpu().contiguous(), 0)
            dist.send(ys.cpu().contiguous(), 0)
        else:
            _r, _ti, t_out1 = srs.shard_slices(CHANNELS, N_IN, rank=1)
            y1 = torch.empty((CHANNELS, t_out1.stop - t_out1.start))
            dist.recv(y1, 1)
            ys1 = torch.empty((CHANNELS, sum(c[1] for c in counts)))
            dist.recv(ys1, 1)
            full = torch.cat([y, y1.to(dev)], dim=1)
            y_un = rs.oneshot(x)
            res["oneshot_db"] = rms_db(full.double() - y_un.double())
            res["shape_ok"] = tuple(full.shape) == tuple(y_un.shape)
            # the stream's output, in time order: each call's rank-0
            # piece, then rank 1's
            pieces, a0, a1 = [], 0, 0
            for c0, c1 in counts:
                pieces += [ys[:, a0 : a0 + c0], ys1[:, a1 : a1 + c1].to(dev)]
                a0, a1 = a0 + c0, a1 + c1
            yst = torch.cat(pieces, dim=1)
            ref_s = rs.oneshot(xs, rs.default_out_len(2 * ss.block))
            res["stream_db"] = rms_db(yst.double()
                                      - ref_s[:, : yst.shape[1]].double())
            res["stream_out"] = int(yst.shape[1])
            res["un_ms"] = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        res["error"] = traceback.format_exc()
        q.put((rank, res))
        raise
    q.put((rank, res))


def shard_processes(dev, card, peaks, peaks64, seen):
    """Phase 4: two processes on the one card (torch.multiprocessing,
    spawn, gloo), mesh t2, the time halos crossing the process boundary
    through pinned host buffers.  A child that fails or outlives
    SHARD_PROC_TIMEOUT fails the phase.  The children's frac_whole call
    shapes are the in-process t2 run's: recorded from that run."""
    import queue
    import socket

    import torch
    import torch.multiprocessing as mp

    from r8brain_torch import Mesh, Resampler, ShardedResampler

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=shard_child, args=(r, port, q))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res, err = {}, None
    try:
        while len(res) < 2 and err is None:
            left = SHARD_PROC_TIMEOUT - (time.perf_counter() - t0)
            try:
                r, out = q.get(timeout=max(1.0, left))
            except queue.Empty:
                err = f"no result within {SHARD_PROC_TIMEOUT} s"
                break
            res[r] = out
            if "error" in out:
                err = f"rank {r} failed:\n{out['error']}"
        for p in procs:
            p.join(timeout=0 if err else 60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    secs = time.perf_counter() - t0
    check(err is None, f"two-process phase: {err}")
    check(all(p.exitcode == 0 for p in procs), f"two-process phase: exit "
          f"codes {[p.exitcode for p in procs]}")
    r0 = res[0]
    check(r0["shape_ok"], "two-process phase: output shape")
    print(f"sharded two processes (gloo, mesh t2, halos through pinned host "
          f"buffers): flagship {CHANNELS} x {N_IN} vs unsharded oneshot "
          f"{r0['oneshot_db']:.2f} dB (bound {SHARD_PARITY_DB:g}); two "
          f"stream calls ({r0['stream_out']} outputs) "
          f"{r0['stream_db']:.2f} dB; frac_whole launches by rank "
          f"{[res[r]['launches'] for r in (0, 1)]}; {secs:.1f} s with "
          f"start-up")
    check(r0["oneshot_db"] <= SHARD_PARITY_DB and r0["stream_db"]
          <= SHARD_PARITY_DB, "two-process phase misses its bound")
    check(all(res[r]["launches"] >= 1 for r in (0, 1)), "two-process "
          f"phase: a rank never launched frac_whole")
    print(f"timing {card}: sharded two processes oneshot, rank 0 / 1 "
          f"{r0['ms']:.3f} / {res[1]['ms']:.3f} ms = "
          f"{1e-6 * CHANNELS * N_IN / (max(r0['ms'], res[1]['ms']) * 1e-3):.1f}"
          f" Mrops; unsharded oneshot {r0['un_ms']:.3f} ms (two processes "
          f"share one card, halos cross the host: not scaling)")
    # the children's call shapes, recorded from the in-process t2 run
    rs = Resampler(SRC, DST, TB, ATTEN, device=dev)
    x = uniform_input(dev, N_IN)
    _y, fcalls, dcalls, _nf, _nd = shard_run(
        lambda: ShardedResampler(rs, Mesh((2,), ("t",))).oneshot(x))
    shapes = [("frac", a[2], a[3], a[4],
               a[1].shape[2] - (a[1].shape[3] == 8), k.get("kc", 32), a[5],
               a[0].shape[0]) for a, k in fcalls]
    child = sorted(tuple(k) for r in (0, 1) for k in res[r]["shapes"])
    check(sorted(shapes) == child, f"two-process phase: the children's "
          f"call shapes {child} are not the in-process t2 run's {shapes}")
    launches = {}
    for k in child:
        launches[k] = launches.get(k, 0) + 1
    recs = shard_records("two processes, t2", rs, fcalls, dcalls, seen,
                         peaks, peaks64, card, launches=launches)
    del x, rs
    torch.cuda.empty_cache()
    return recs


def sharding_paths(dev, peaks, peaks64, card):
    """The sharding phases (parallel/): (1) the fast flagship over the
    in-process mesh ch2 x t2 on the card, then its guarantee chain
    (ozaki engines) over the same mesh; (2) 44.1k -> 96001 over t4 (the
    polynomial split chain), "high" and "fast"; (3) the sharded stream,
    ch2 x t2, SHARD_CALLS calls; (4) two processes on the card over gloo
    (shard_processes); (5) the port's dry run, dryrun_multichip(4).
    Each run counted (launch counts set to 0 just before, read just
    after), held against the unsharded oneshot on the card and the
    float64 CPU path, timed; every new kernel call shape held to its
    plain version with a record."""
    import torch

    from r8brain_torch import (Mesh, Resampler, ShardedResampler,
                               ShardedStreamResampler)
    from r8brain_torch.parallel.dryrun import dryrun_multichip

    records, seen = [], set()
    sk = int(EDGE_S * DST)

    # (1) the flagship over ch2 x t2
    x = uniform_input(dev, N_IN)
    rs = Resampler(SRC, DST, TB, ATTEN, device=dev)
    srs = ShardedResampler(rs, Mesh((2, 2)))
    y_un = rs.oneshot(x)
    y, fcalls, dcalls, nf, _nd = shard_run(lambda: srs.oneshot(x))
    check(tuple(y.shape) == tuple(y_un.shape) and
          bool(torch.isfinite(y).all()), f"sharded flagship shape "
          f"{tuple(y.shape)} or not finite")
    par = rms_db(y.double() - y_un.double())
    ref = f64_reference(SRC, DST, x)
    db = rms_db(y[:N_CMP].cpu().double().numpy()[:, sk:-sk]
                - ref[:, sk:-sk])
    print(f"sharded flagship: ShardedResampler(Resampler({SRC}, {DST}), "
          f"Mesh ch2 x t2), {CHANNELS} x {N_IN} -> {tuple(y.shape)}; vs "
          f"unsharded oneshot {par:.2f} dB (bound {SHARD_PARITY_DB:g}); "
          f"{N_CMP} channels vs port f64 CPU path {db:.2f} dB re full "
          f"scale (class {CLASS_DB:g}); frac_whole launches {nf}")
    check(par <= SHARD_PARITY_DB and db <= CLASS_DB,
          "sharded flagship misses its bound")
    check(nf >= 4, f"sharded flagship: {nf} frac_whole launches, want one "
          f"a shard (4)")
    shard_timing(card, "flagship ch2 x t2", lambda: srs.oneshot(x),
                 lambda: rs.oneshot(x), N_IN)
    records += shard_records("ch2 x t2", rs, fcalls, dcalls, seen, peaks,
                             peaks64, card)
    del y, y_un, fcalls, srs

    # (1b) the guarantee chain over ch2 x t2: each shard's chain on
    # ozaki_framed with the df32 carry
    from r8brain_torch.ops import operators
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed

    rs_g = Resampler(SRC, DST, TB, ATTEN, precision="high",
                     conv_engine="ozaki", frac_engine="ozaki", device=dev)
    srs_g = ShardedResampler(rs_g, Mesh((2, 2)))
    y_un = rs_g.oneshot(x)
    ozaki_framed.launches = 0
    (y, _f, _d, _nf, _nd), ocalls = record_run(
        lambda: shard_run(lambda: srs_g.oneshot(x)), (operators,),
        "ozaki_framed")
    ocalls = [c for c in ocalls if on_card(c[0])]
    no = ozaki_framed.launches
    check(rs_g.df_carry and no == len(ocalls) and no >= 8, f"sharded "
          f"guarantee chain: carry {rs_g.df_carry}, {no} ozaki_framed "
          f"launches for {len(ocalls)} calls, want two a shard")
    par = rms_db(y.double() - y_un.double())
    d = y[:N_CMP].cpu().double().numpy()[:, sk:-sk] - ref[:, sk:-sk]
    rel = rms_db(d) - rms_db(ref[:, sk:-sk])
    print(f"sharded guarantee chain: ShardedResampler(Resampler({SRC}, "
          f"{DST}, precision='high', conv_engine='ozaki', "
          f"frac_engine='ozaki'), Mesh ch2 x t2), {CHANNELS} x {N_IN} -> "
          f"{tuple(y.shape)}; vs unsharded oneshot {par:.2f} dB (bound "
          f"{SHARD_PARITY_DB:g}); {N_CMP} channels vs port f64 CPU path "
          f"{rel:.2f} dB relative (bound {OZ_CARRY_DB:g}); ozaki_framed "
          f"launches {no}")
    check(par <= SHARD_PARITY_DB and rel <= OZ_CARRY_DB,
          "sharded guarantee chain misses its bound")
    shard_timing(card, "guarantee chain ch2 x t2",
                 lambda: srs_g.oneshot(x), lambda: rs_g.oneshot(x), N_IN)
    records += shard_ozaki_records("guarantee ch2 x t2", rs_g, ocalls, seen,
                                   dev, peaks, card)
    del y, y_un, ocalls, srs_g, rs_g
    torch.cuda.empty_cache()

    # (3) the sharded stream, ch2 x t2, on the same resampler
    ss = ShardedStreamResampler(rs, Mesh((2, 2)), seg_len=SHARD_SEG)
    n = SHARD_CALLS * ss.block
    xs = uniform_input(dev, n)
    y_un = rs.oneshot(xs)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(SHARD_CALLS + 1)]

    def drive():
        outs = []
        ev[0].record()
        for i in range(SHARD_CALLS):
            outs.append(ss.process_block(
                xs[:, i * ss.block : (i + 1) * ss.block]))
            ev[i + 1].record()
        return torch.cat(outs, dim=1)

    ys, fcalls, dcalls, nf, _nd = shard_run(drive)
    call_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(SHARD_CALLS)]
    par = rms_db(ys.double() - y_un[:, : ys.shape[1]].double())
    print(f"sharded stream: ShardedStreamResampler(flagship, Mesh ch2 x "
          f"t2, seg_len={SHARD_SEG}) block {ss.block}, {SHARD_CALLS} calls "
          f"on {CHANNELS} x {n} -> {tuple(ys.shape)}; vs unsharded oneshot "
          f"{par:.2f} dB (bound {SHARD_PARITY_DB:g}); frac_whole launches "
          f"{nf}")
    check(par <= SHARD_PARITY_DB, "sharded stream misses its bound")
    check(nf >= 4 * SHARD_CALLS, f"sharded stream: {nf} frac_whole "
          f"launches for {SHARD_CALLS} calls of 4 shards")
    steady = sorted(call_ms[1:])[len(call_ms[1:]) // 2]
    print(f"timing {card}: sharded stream ch2 x t2 per call (ms) "
          f"{', '.join(f'{t:.3f}' for t in call_ms)}; steady median "
          f"{steady:.3f} ms = "
          f"{1e-6 * CHANNELS * ss.block / (steady * 1e-3):.1f} Mrops; "
          f"unsharded oneshot of the same {n} samples "
          f"{cuda_ms(lambda: rs.oneshot(xs), reps=3, warmup=1):.3f} ms")
    records += shard_records("stream ch2 x t2", rs, fcalls, dcalls, seen,
                             peaks, peaks64, card)
    del ss, xs, ys, y_un, fcalls, rs, x
    torch.cuda.empty_cache()

    # (2) 44.1k -> 96001, the polynomial split chain over t4
    dst = 96001
    x = uniform_input(dev, N_IN)
    ref = f64_reference(SRC, dst, x)
    sk = int(EDGE_S * dst)
    for precision in ("high", "fast"):
        rs = Resampler(SRC, dst, TB, ATTEN, precision=precision, device=dev)
        srs = ShardedResampler(rs, Mesh((4,), ("t",)))
        y_un = rs.oneshot(x)
        y, fcalls, dcalls, nf, _nd = shard_run(lambda: srs.oneshot(x))
        check(srs._poly is not None and tuple(y.shape) == tuple(y_un.shape)
              and bool(torch.isfinite(y).all()), f"sharded poly "
              f"{precision}: not the split chain, shape or not finite")
        par = rms_db(y.double() - y_un.double())
        d = y[:N_CMP].cpu().double().numpy()[:, sk:-sk] - ref[:, sk:-sk]
        db = rms_db(d)
        rel = db - rms_db(ref[:, sk:-sk])
        bound_db = CLASS_DB if precision == "high" else SHARD_POLY_FAST_DB
        print(f"sharded poly {precision}: ShardedResampler(Resampler({SRC},"
              f" {dst}, precision={precision!r}), Mesh t4) split chain, "
              f"{CHANNELS} x {N_IN} -> {tuple(y.shape)}; vs unsharded "
              f"oneshot {par:.2f} dB (bound {SHARD_PARITY_DB:g}); {N_CMP} "
              f"channels vs port f64 CPU path {db:.2f} dB re full scale, "
              f"{rel:.2f} relative (bound {bound_db:g} "
              f"{'re full scale' if precision == 'high' else 'relative'});"
              f" frac_whole launches {nf}")
        check(par <= SHARD_PARITY_DB and (db if precision == "high"
                                          else rel) <= bound_db,
              f"sharded poly {precision} misses its bound")
        check(nf >= 4, f"sharded poly {precision}: {nf} frac_whole launches")
        shard_timing(card, f"poly t4 {precision}", lambda: srs.oneshot(x),
                     lambda: rs.oneshot(x), N_IN)
        records += shard_records(f"poly t4 {precision}", rs, fcalls, dcalls,
                                 seen, peaks, peaks64, card)
        del y, y_un, fcalls, srs, rs
        torch.cuda.empty_cache()
    del x

    # (4) two processes on the card
    records += shard_processes(dev, card, peaks, peaks64, seen)

    # (5) the port's dry run on the card
    built = {}
    out, fcalls, dcalls, nf, nd = shard_run(
        lambda: dryrun_multichip(4, device=dev, resamplers=built))
    print(f"sharded dry run: dryrun_multichip(4) on the card, mesh "
          f"{out['mesh']}: 24-bit preset (high, fft) vs unsharded "
          f"{out['preset24']['vs_unsharded_db']:.2f} dB, vs f64 "
          f"{out['preset24']['vs_f64_rel_db']:.2f} dB relative; stream "
          f"{out['stream']['vs_unsharded_db']:.2f} dB; 44.1k -> 96001 "
          f"{out['poly']['vs_unsharded_db']:.2f} / "
          f"{out['poly']['vs_f64_rel_db']:.2f} dB; launches frac_whole "
          f"{nf}, df_fft_conv {nd}")
    # the shards' calls: C_loc = 2 rows of the ch2 x t2 mesh (the run's
    # unsharded comparisons make calls of 4)
    check(all(any(a[0].shape[0] == 2 for a, _k in calls)
              for calls in (fcalls, dcalls)), "the dry run's shards never "
          "launched frac_whole or df_fft_conv")
    records += shard_records("dry run", built, fcalls, dcalls, seen, peaks,
                             peaks64, card, rows=2)
    return records


def cli_master(dev, rate: int, path: str) -> int:
    """Write the phase's stereo 24-bit master at ``rate`` (CLI_SECONDS)
    with the port's write_wav: per channel, white noise from SEED low-passed
    to CLI_BAND on the card and scaled to CLI_PEAK peak, plus a CLI_TONE
    sine at CLI_PEAK.  Returns its frame count."""
    import torch

    from r8brain_torch.io import write_wav

    n = CLI_SECONDS * rate
    g = torch.Generator(device=dev).manual_seed(SEED)
    spec = torch.fft.rfft(torch.randn((2, n), generator=g, device=dev))
    spec[:, int(CLI_BAND * n / rate) + 1 :] = 0
    noise = torch.fft.irfft(spec, n=n)
    del spec
    noise *= CLI_PEAK / noise.abs().amax(dim=1, keepdim=True)
    t = torch.arange(n, device=dev, dtype=torch.float64) / rate
    x = noise.double() + CLI_PEAK * torch.sin(2 * math.pi * CLI_TONE * t)
    write_wav(path, rate, x.cpu().numpy(), 24)
    return n


def cli_run(card, label, argv, resamplers=None, split=False):
    """r8brain_torch.cli.main(argv) in this process, its --bench line
    captured and printed with the wall time.  With ``resamplers`` (a
    list), every Resampler the CLI builds is appended to it, and the run
    is counted (shard_run: launch counts set to 0 just before, read just
    after, every kernel call on the card recorded).  With ``split`` (and
    ``resamplers``), this run's own parts are printed too: the CLI's WAV
    decode, Resampler build (the host design) and WAV encode, each timed
    where the CLI calls it; the rest of its --bench window (the copy to
    the card, the chain, the copy back and the float64 cast); and
    torch.profiler's device time of the run's kernels and copies, with the
    card's idle share of the run's wall.  Returns (frac_whole calls,
    frac_whole launches)."""
    import contextlib
    import io
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from r8brain_torch import cli

    err = io.StringIO()
    parts = {}
    real = {n: getattr(cli, n) for n in ("Resampler", "read_wav",
                                         "write_wav")}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    def build(*a, **kw):
        rs = real["Resampler"](*a, **kw)
        resamplers.append(rs)
        return rs

    prof = profile(activities=[ProfilerActivity.CUDA]) if split else \
        contextlib.nullcontext()

    wall = []

    def run():
        # the wall is cli.main's alone: the profiler's start and its
        # trace's collection lie outside it
        with contextlib.redirect_stderr(err), prof:
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--bench"])
            wall.append(time.perf_counter() - t0)
        return rc

    fcalls, nf = [], 0
    if resamplers is None:
        rc = run()
    else:
        cli.Resampler = timed("design", build) if split else build
        if split:
            cli.read_wav = timed("decode", real["read_wav"])
            cli.write_wav = timed("encode", real["write_wav"])
        try:
            rc, fcalls, _dc, nf, _nd = shard_run(run)
        finally:
            for n, fn in real.items():
                setattr(cli, n, fn)
    wall = wall[0]
    m = re.search(r"in ([0-9.]+)s = ([0-9.]+) Mrops", err.getvalue())
    check(rc == 0 and m is not None, f"cli {label}: exit {rc}, stderr "
          f"{err.getvalue()[-500:]!r}")
    print(f"timing {card}: cli {label}: wall {wall:.3f} s; --bench "
          f"{m[1]} s = {m[2]} Mrops"
          + (f"; frac_whole launches {nf}" if resamplers is not None
             else ""))
    if split:
        dev_s = {"kernels": 0.0, "copies": 0.0}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_s["copies" if e.key.startswith("Memcpy") else
                      "kernels"] += e.self_device_time_total * 1e-6
        rest = float(m[1]) - parts["design"]
        busy = dev_s["kernels"] + dev_s["copies"]
        print(f"timing {card}: cli {label} split (this run, profiled): "
              f"decode {parts['decode']:.3f} s, design {parts['design']:.3f}"
              f" s, H2D + chain + D2H + cast {rest:.3f} s, encode "
              f"{parts['encode']:.3f} s; device: kernels "
              f"{dev_s['kernels'] * 1e3:.3f} ms, copies "
              f"{dev_s['copies'] * 1e3:.3f} ms, idle "
              f"{100.0 * (1.0 - busy / wall):.2f} % of the wall")
    return fcalls, nf


def cli_paths(dev, peaks, card, native_build):
    """The CLI phase: r8brain_torch.cli.main on a CLI_SECONDS stereo 24-bit
    master, in this process.  44.1 kHz -> 96 kHz: the native float64
    engine (--precision native, the reference), the whole file "high"
    as float64 and as 24-bit PCM (the 24-bit samples equal to the 24-bit
    quantisation of the float64 file's), --stream, --max-chunk 1048576
    and "fast"; then a 96 kHz master to 44.1 kHz, "high" and native.
    Every device run counted (launch counts set to 0 just before, read
    just after: frac_whole launched), held against the native output at
    CLASS_DB re full scale past EDGE_S at each edge, and its frame count
    to floor(frames * dst / src); each run's wall time and --bench Mrops
    printed; every new frac_whole call shape held to its plain version
    with a record.  ``native_build``: the future of the engine's build,
    started with the kernels' (its failure fails the phase)."""
    import filecmp
    import tempfile

    import numpy as np

    from r8brain_torch.io import read_wav, write_wav

    native_build.result()
    records, seen = [], set()
    f64 = ["--float", "--bits", "64"]
    with tempfile.TemporaryDirectory() as tmp:
        for src, dst in ((44100, 96000), (96000, 44100)):
            master = f"{tmp}/master_{src}.wav"
            t0 = time.perf_counter()
            frames = cli_master(dev, src, master)
            out_len = int(math.floor(frames * dst / src))
            skip = int(EDGE_S * dst)
            print(f"cli master: {master.rsplit('/', 1)[1]} 2 x {frames} "
                  f"frames 24-bit at {src} Hz written in "
                  f"{time.perf_counter() - t0:.3f} s")
            tag = f"{src / 1000:g}k -> {dst / 1000:g}k"

            def out(name):
                return f"{tmp}/{name}_{src}.wav"

            def read(path, bits):
                w = read_wav(path)
                check((w.rate, w.channels, w.bits, w.frames) ==
                      (dst, 2, bits, out_len), f"cli {path}: rate "
                      f"{w.rate}, {w.channels} ch, {w.bits} bits, "
                      f"{w.frames} frames (want {out_len})")
                return w.data

            cli_run(card, f"{tag} native", [master, out("native"), str(dst),
                                            "--precision", "native"] + f64)
            ref = read(out("native"), 64)[:, skip:-skip]
            runs = ([("high f64", []), ("high 24-bit", None),
                     ("stream", ["--stream"]),
                     ("max-chunk", ["--max-chunk", "1048576"]),
                     ("fast", ["--precision", "fast"])]
                    if src == 44100 else [("high f64", [])])
            for label, flags in runs:
                built = []
                pcm = flags is None
                path = out(label.replace(" ", "_"))
                argv = [master, path, str(dst)] + (
                    [] if pcm else flags + f64)
                fcalls, nf = cli_run(card, f"{tag} {label}", argv, built,
                                     split=label == "high f64"
                                     and src == 44100)
                check(nf >= 1 and len(built) == 1, f"cli {tag} {label}: "
                      f"{nf} frac_whole launches, {len(built)} resamplers")
                if pcm:
                    # the 24-bit file is the float64 file's samples
                    # through the same encoder
                    y64 = read(out("high_f64"), 64)
                    write_wav(f"{tmp}/requant.wav", dst, y64, 24)
                    same = filecmp.cmp(path, f"{tmp}/requant.wav",
                                       shallow=False)
                    read(path, 24)
                    print(f"cli {tag} {label}: 24-bit samples "
                          f"{'equal' if same else 'DIFFER from'} the "
                          f"24-bit quantisation of the float64 run's")
                    check(same, f"cli {tag} {label}: 24-bit file is not "
                          f"the float64 run's quantised")
                    for p in (path, f"{tmp}/requant.wav", out("high_f64")):
                        os.remove(p)
                else:
                    y = read(path, 64)
                    db = rms_db(y[:, skip:-skip] - ref)
                    print(f"cli {tag} {label}: 2 x {out_len} vs native "
                          f"float64 {db:.2f} dB re full scale (class "
                          f"{CLASS_DB:g})")
                    check(db <= CLASS_DB and bool(np.isfinite(y).all()),
                          f"cli {tag} {label} misses {CLASS_DB:g} dB")
                    del y
                    if label != "high f64":
                        os.remove(path)
                records += frac_shape_records(f"cli {tag} {label}", built,
                                              fcalls, seen, peaks, card)
                del fcalls, built
            del ref
            for p in (master, out("native"), out("high_f64")):
                if os.path.exists(p):
                    os.remove(p)
    return records


def acc_shape(name, args, kw):
    """A kernel call's shape: (kernel, rows, windows, the rest of its
    geometry)."""
    if name == "frac_whole":
        xp, parts, I, D, O, n_win = args
        return (name, xp.shape[0], n_win, I, D, O, tuple(parts.shape),
                kw.get("kc", 32))
    if name == "ozaki_framed":
        xp, _sx, _parts, L_f, hop, Kcols, nb = args
        return (name, xp.shape[0], nb, L_f, hop, Kcols,
                kw.get("x_lo") is not None, bool(kw.get("emit_pair")))
    if name == "df_fft_conv":
        u, plan, n_frames, head = args
        return (name, u.shape[0], n_frames, plan.mode(head), plan.n, head,
                u.shape[1])
    xp, parts, L_fs, nb, hop = args
    return (name, xp.shape[0], nb, tuple(L_fs), hop, tuple(parts.shape))


def acc_recorder(store, name, real):
    """A stand-in for the kernel wrapper ``name`` that runs ``real`` (which
    counts its launch) and keeps in ``store``, for each call shape
    (acc_shape), the first call's [args (held), kw, executor, stage input] and
    the number of calls on the card (a CPU model's calls are not kept):
    the executor is the nearest calling frame's ``self`` that is a torch
    module but no operator of ops/operators.py, the stage input that
    frame's ``x``."""
    import torch

    from r8brain_torch.ops.operators import FramedOperator, OzakiOperator

    def rec(*args, **kw):
        if args[0].device.type != "cuda":  # a CPU model's call
            return real(*args, **kw)
        key = acc_shape(name, args, kw)
        if key not in store:
            f, ex, x_in = sys._getframe(1), None, None
            while f is not None and ex is None:
                s = f.f_locals.get("self")
                if isinstance(s, torch.nn.Module) and not isinstance(
                        s, (FramedOperator, OzakiOperator)):
                    ex, x_in = s, f.f_locals.get("x")
                f = f.f_back
            store[key] = [held(name, args), kw, ex, x_in, 0]
        store[key][4] += 1
        return real(*args, **kw)
    return rec


def acc_hold(store, dev, peaks, peaks64, card, launches,
             phase="acceptance sweep", frac_keys=None):
    """Every call shape in ``store`` (recorded by ``phase``: the
    acceptance sweep, or the accuracy grid) against its kernel's plain
    version on the card: frac_whole within MODEL_REL_TOL of max |y| of its
    model (and KERNEL_REL_TOL of its float64 product), ozaki_framed
    bit-equal without x_lo (OZ_LO_REL_TOL / OZ_PAIR_REL_TOL with it),
    df_fft_conv within FFT_REL_TOL, sym_conv within SYM_ULPS; then each
    kernel's smallest shape (rows x windows) timed beside its plain
    version and its library call, one record a kernel; with
    ``frac_keys``, frac_whole's record is one for each of those shapes
    instead (its launches the phase's calls of that shape).  Returns the
    records."""
    import torch

    from r8brain_torch.ops.pallas_dfft import df_fft_conv, df_fft_conv_ref
    from r8brain_torch.ops.pallas_frac import (frac_whole, frac_whole_ref,
                                               operator_parts)
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed, ozaki_framed_ref
    from r8brain_torch.ops.pallas_symconv import sym_conv, sym_conv_ref

    worst = {k: 0.0 for k in ACC_KERNELS}
    shapes = {k: [] for k in ACC_KERNELS if any(key[0] == k for key in store)}
    for key, (args, kw, ex, _x, _n) in store.items():
        name = key[0]
        label = f"{phase} {name} {key[1:]}"
        if name == "frac_whole":
            check(ex is not None, f"{label}: no executor")
            skT, lo = exec_operator(ex, args[1])
            y, model = frac_whole(*args, **kw), frac_whole_ref(*args, **kw)
            r = frac_whole_ref(args[0].double(), operator_parts(
                skT.double(), None if lo is None else lo.double()),
                *args[2:], start=kw.get("start", 0))
            err = check_frac_model(label, y, model, r)[1]
        elif name == "ozaki_framed":
            lo, emit = kw.get("x_lo"), bool(kw.get("emit_pair"))
            y = ozaki_framed(*args, **kw)
            r = ozaki_framed_ref(*args, x_lo=lo, emit_pair=emit)
            ys, rs = (y, r) if emit else ((y,), (r,))
            yc = sum(t.double() for t in ys)
            rc = sum(t.double() for t in rs)
            err = float((yc - rc).abs().max().item()) / max(
                float(rc.abs().max().item()), 1e-300)
            if lo is None:
                check(all(torch.equal(a, b) for a, b in zip(ys, rs)),
                      f"{label}: not bit-equal to ozaki_framed_ref")
            else:
                tol = OZ_PAIR_REL_TOL if emit else OZ_LO_REL_TOL
                check(err <= tol, f"{label}: max rel {err:.3e} vs plain")
        elif name == "df_fft_conv":
            y, r = df_fft_conv(*args), df_fft_conv_ref(*args)
            err = max_rel(y, r.double())
            check(err <= FFT_REL_TOL, f"{label}: max rel err {err:.3e} vs "
                  f"plain")
        else:
            y, r = sym_conv(*args), sym_conv_ref(*args)
            err = ulps_of_max(y, r)
            check(err <= SYM_ULPS["float32"], f"{label}: {err:.2f} ulps of "
                  f"max |y| from plain")
        worst[name] = max(worst[name], err)
        shapes[name].append(key)
    torch.cuda.synchronize()
    records = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    for name, keys in shapes.items():
        if name == "frac_whole" and frac_keys is not None:
            for key in frac_keys:
                args, kw, ex, _x, n = store[key]
                records.append(frac_record(
                    f"frac_whole[{phase}: {type(ex).__name__}, C={key[1]}, "
                    f"n_win={key[2]}, I={key[3]}, D={key[4]}, O={key[5]}, "
                    f"{'high' if key[6][2] == 4 else 'fast'}]", (args, kw),
                    ex, n, peaks, card))
            continue
        key = min(keys, key=lambda k: (k[1] * k[2], k[3:]))
        args, kw, ex, x_in, _n = store[key]
        rows, wins = key[1], key[2]
        what = {"frac_whole": "of max |y| from the model",
                "ozaki_framed": "of max |y| from plain (bit-equal without "
                                "x_lo)",
                "df_fft_conv": "of max |y| from plain",
                "sym_conv": "ulps of max |y| from plain"}[name]
        print(f"{phase} {name}: {len(keys)} distinct call shapes, "
              f"{launches[name]} launches; smallest {rows} x {wins} "
              f"windows {key[3:]}; worst {worst[name]:.3e} {what}")
        tag = (f"{name}[{phase}: {len(keys)} shapes, smallest "
               f"{rows} x {wins}]")
        if name == "frac_whole":
            records.append(frac_record(tag, (args, kw), ex, launches[name],
                                       peaks, card))
        elif name == "df_fft_conv":
            records.append(fft_record(
                f"{phase}, {len(keys)} shapes, smallest {rows} x "
                f"{wins}", (args, kw), FFT_REPLACES[key[3]], launches[name],
                peaks64, card))
        elif name == "sym_conv":
            records.append(matmul_record(phase, name, tag,
                                         (args, kw), ex, x_in,
                                         launches[name], peaks, card))
        else:
            _xp, _sx, parts, L_f, hop, Kcols, nb = args
            geo = (L_f, hop, Kcols, nb)
            var = key[6:8]
            case = ozaki_case(dev, g, rows, *geo, parts)
            errs = check_ozaki_variants(f"{type(ex).__name__} ({phase}, "
                                        f"smallest shape)", geo, case,
                                        parts, kw["packed"])
            rep = ozaki_replaces(ex, *var)
            lib = library_call(ex, case[0], parts.double().sum(dim=0), hop,
                               torch.float64)
            records.append(ozaki_record(tag, rep, geo, case, parts,
                                        kw["packed"], var[0], var[1],
                                        launches[name], errs[var], lib,
                                        peaks, card))
    return records


def acceptance_paths(dev, peaks, peaks64, card, native_build):
    """The acceptance layer on the card: tools/torch_fuzz.py's first
    ACC_TRIALS draws through every executor (orc, f32, oz, stm, nat,
    high, fft, sym; every pair at its bound, a float32 executor above
    -141 dB re full scale printed beside its CPU model), counted (launch
    counts set to 0 just before it and read just after: every kernel of
    ACC_KERNELS launched) with every kernel call recorded; the fuzzer's
    pins (relative) and its class pins (CLASS_DB re full scale);
    torch_zerotest --impl f32 --quick; torch_flt_test; the serving
    latency curve at LAT_BLOCKS on LAT_CHANNELS channels for each of
    LAT_DSTS; then every call shape of the sweep held to its plain version
    and each kernel's smallest shape recorded (acc_hold)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_flt_test
    import torch_fuzz
    import torch_latency_curve
    import torch_zerotest

    from r8brain_torch.ops import operators, stages
    from r8brain_torch.ops.pallas_dfft import df_fft_conv
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed
    from r8brain_torch.ops.pallas_symconv import sym_conv

    native_build.result()
    t_phase = time.perf_counter()
    mods = {"stages": stages, "operators": operators}
    real = {"frac_whole": frac_whole, "ozaki_framed": ozaki_framed,
            "df_fft_conv": df_fft_conv, "sym_conv": sym_conv}
    store = {}
    for fn in real.values():
        fn.launches = 0
    try:
        for name, ms in ACC_KERNELS.items():
            for m in ms:
                setattr(mods[m], name, acc_recorder(store, name, real[name]))
        t0 = time.perf_counter()
        summary, fails = torch_fuzz.sweep(
            ACC_TRIALS, 0, torch_fuzz.BASE + torch_fuzz.CARD, dev, log=print)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for name, ms in ACC_KERNELS.items():
            for m in ms:
                setattr(mods[m], name, real[name])
    launches = {k: fn.launches for k, fn in real.items()}
    calls = {k: sum(v[4] for key, v in store.items() if key[0] == k)
             for k in real}
    print(f"acceptance fuzzer {card}: {ACC_TRIALS} draws in {dt:.1f} s "
          f"({dt / ACC_TRIALS:.3f} s a draw); launches {launches}, calls "
          f"{calls}")
    print("acceptance fuzzer: " + json.dumps(summary))
    check(not fails, f"acceptance fuzzer: {len(fails)} pairs miss their "
          f"bound, first {fails[0] if fails else None}")
    check(all(launches[k] >= 1 for k in real), f"acceptance fuzzer: a "
          f"kernel never launched: {launches}")
    check(all(launches[k] == calls[k] for k in real if k != "df_fft_conv")
          and launches["df_fft_conv"] >= calls["df_fft_conv"],
          f"acceptance fuzzer: launches {launches} for calls {calls}")
    check(all(summary["runs"][k] >= 1 for k in torch_fuzz.BASE +
              torch_fuzz.CARD), f"acceptance fuzzer: runs {summary['runs']}")

    for pin in torch_fuzz.PINS:
        label, cfg, ex, bound_db = pin[:4]
        y, ref = torch_fuzz.run_pin(pin, dev)
        d = torch_fuzz.rel_db(y, ref)
        print(f"acceptance pin {label} {cfg} {ex}: {d:.2f} dB relative "
              f"(bound {bound_db:g}), {rms_db(y - ref):.2f} re full scale")
        check(d < bound_db, f"acceptance pin {label}: {d:.2f} dB misses "
              f"{bound_db:g}")
    for pin in torch_fuzz.CLASS_PINS:
        label, cfg, ex, bound_db = pin[:4]
        y, ref = torch_fuzz.run_pin(pin, dev)
        d = rms_db(y - ref)
        print(f"acceptance class pin {label} {cfg} {ex}: {d:.2f} dB re full "
              f"scale (bound {bound_db:g})")
        check(d < bound_db, f"acceptance class pin {label}: {d:.2f} dB "
              f"misses {bound_db:g}")

    t0 = time.perf_counter()
    rc = torch_zerotest.main(["--impl", "f32", "--quick", "--device",
                              "cuda"])
    check(rc == 0 and torch_zerotest.last["ratios"] == 62,
          f"torch_zerotest --impl f32 --quick: rc {rc}, "
          f"{torch_zerotest.last}")
    print(f"acceptance zerotest {card}: {time.perf_counter() - t0:.1f} s")
    rc = torch_flt_test.main(["--device", "cuda"])
    check(rc == 0, f"torch_flt_test on the card: rc {rc}")

    for dst in LAT_DSTS:
        points, mode = torch_latency_curve.curve(
            44100.0, float(dst), 180.15, "fast", LAT_CHANNELS, LAT_BLOCKS,
            LAT_ITERS, dev)
        print(f"acceptance latency curve {card}: " + json.dumps({
            "metric": "stream_latency_curve", "channels": LAT_CHANNELS,
            "src": 44100.0, "dst": float(dst), "mode": mode,
            "points": points}))
        lens = [p["block_len"] for p in points]
        check(len(points) >= 2 and len(set(lens)) == len(lens) and all(
            math.isfinite(p["ms_per_block"]) and p["ms_per_block"] > 0
            for p in points), f"latency curve {dst}: {points}")
        torch.cuda.empty_cache()

    records = acc_hold(store, dev, peaks, peaks64, card, launches)
    del store
    torch.cuda.empty_cache()
    print(f"acceptance_paths: {time.perf_counter() - t_phase:.1f} s")
    return records


def grid_paths(dev, peaks, peaks64, card):
    """The accuracy grid on the card: every row of the matrix's
    ACCURACY_RUNS but GRID_SKIP through torch_chip_accuracy.audit, each
    configuration's dB re full scale against the float64 oracle printed
    and held to torch_chip_accuracy.CLASS_DB; the launch counts set to 0
    just before and read just after (every kernel of GRID_KERNELS
    launched, each launch a recorded call); then every call shape held to
    its plain version (acc_hold), frac_whole recorded at the GRID_FRAC_D
    fused shapes and the other kernels at their smallest."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_bench_matrix
    import torch_chip_accuracy

    from r8brain_torch.ops import operators
    from r8brain_torch.ops.pallas_frac import frac_whole
    from r8brain_torch.ops.pallas_ozaki import ozaki_framed

    t_phase = time.perf_counter()
    mods = {"operators": operators}
    real = {"frac_whole": frac_whole, "ozaki_framed": ozaki_framed}
    rows = [r for r in torch_bench_matrix.ACCURACY_RUNS
            if r[0] not in GRID_SKIP]
    store, misses, n_cells = {}, [], 0
    for fn in real.values():
        fn.launches = 0
    try:
        for name in GRID_KERNELS:
            for m in ACC_KERNELS[name]:
                setattr(mods[m], name, acc_recorder(store, name, real[name]))
        for label, argv, _timeout in rows:
            args = torch_chip_accuracy.parser().parse_args(
                argv + ["--device", "cuda"])
            t0 = time.perf_counter()
            res = torch_chip_accuracy.audit(args, dev, log=lambda _l: None)
            dt = time.perf_counter() - t0
            for cfg, db in res.items():
                bound_db = torch_chip_accuracy.CLASS_DB[cfg]
                ok = not isinstance(db, str) and db <= bound_db
                n_cells += 1
                print(f"grid {label} {cfg} {card}: {db} dB re full scale vs "
                      f"the f64 oracle (class {bound_db:g}; {args.channels} "
                      f"x {args.seconds:g} s of {args.src:g} Hz -> "
                      f"{args.dst:g} Hz, atten {args.atten:g}, tb "
                      f"{args.tb:g}, phase {args.phase}; row {dt:.1f} s)")
                if not ok:
                    misses.append((label, cfg, db, bound_db))
    finally:
        for name in GRID_KERNELS:
            for m in ACC_KERNELS[name]:
                setattr(mods[m], name, real[name])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in real.items()}
    calls = {k: sum(v[4] for key, v in store.items() if key[0] == k)
             for k in real}
    print(f"grid: {len(rows)} rows, {n_cells} cells; launches {launches}, "
          f"calls {calls}")
    check(not misses, f"grid: {len(misses)} cells miss their class: "
          f"{misses}")
    check(all(launches[k] >= 1 for k in real), f"grid: a kernel never "
          f"launched: {launches}")
    check(launches == calls, f"grid: launches {launches} for calls {calls}")
    frac_keys = [k for k in store if k[0] == "frac_whole"
                 and k[4] in GRID_FRAC_D
                 and type(store[k][2]).__name__ == "FusedUpExec"]
    check(sorted({k[4] for k in frac_keys}) == sorted(GRID_FRAC_D),
          f"grid: fused frac_whole shapes {sorted({k[4] for k in frac_keys})}"
          f", want D in {GRID_FRAC_D}")
    records = acc_hold(store, dev, peaks, peaks64, card, launches,
                       phase="accuracy grid", frac_keys=frac_keys)
    del store
    torch.cuda.empty_cache()
    print(f"grid_paths: {time.perf_counter() - t_phase:.1f} s")
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    from r8brain_torch import Resampler
    from r8brain_torch.ops.ozaki import split_operator_host
    from r8brain_torch.ops.pallas_ozaki import pack_operator

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

    # the native engine (the CLI phase's float64 reference) builds on the
    # host while nvcc builds the kernels
    from concurrent.futures import ThreadPoolExecutor

    from r8brain_torch.native import build_library

    pool = ThreadPoolExecutor(1)
    native_build = pool.submit(build_library)
    pool.shutdown(wait=False)
    build_kernels()

    x = torch.rand((CHANNELS, N_IN), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 2 - 1
    rs64 = Resampler(SRC, DST, TB, ATTEN, dtype=torch.float64, device="cpu")
    ref = rs64.oneshot(x[:N_CMP].cpu().double()).numpy()
    skip = int(EDGE_S * DST)

    peaks = (peak_f32, peak_bf16, peak_bytes)
    accumulation_pin(dev, Resampler(SRC, DST, TB, ATTEN,
                                    device=dev).execs[0].op.hi)
    check_frac_beta(dev)
    check_frac_band()
    kernels = [fast_path(dev, x, ref, skip, peaks, card),
               fused_high_path(dev, x, ref, skip, peaks, card)]

    # the split-operand kernel: its lemma, then every variant vs plain at
    # the guarantee chain's two geometries and at an odd one
    lemma_pin(dev)
    rs_on, by_on = guarantee_chain(dev, x, ref, skip, carry=True)
    rs_off, by_off = guarantee_chain(dev, x, ref, skip, carry=False)
    conv, frac = rs_on.execs
    T_in = max(N_IN, rs_on.in_len_for_out(rs_on.default_out_len(N_IN)))
    M1 = conv.out_len(T_in)
    geos = {"conv": conv.geometry(M1), "frac": frac.geometry(frac.out_len(M1))}
    parts = {"conv": conv.op.parts, "frac": frac.op.parts}
    packs = {k: (ex.op.tiles, ex.op.bands)
             for k, ex in (("conv", conv), ("frac", frac))}
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    t_odd = np.sinc((np.arange(599)[:, None] - 300
                     - rng.standard_normal((1, 100)) * 4) / 8)
    odd_parts = split_operator_host(t_odd)[0].to(dev)
    odd_geo = (599, 301, 100, 9)
    check_ozaki_variants("odd", odd_geo,
                         ozaki_case(dev, g, 13, *odd_geo, odd_parts),
                         odd_parts, pack_operator(odd_parts))
    cases, errs = {}, {}
    for k in ("conv", "frac"):
        cases[k] = ozaki_case(dev, g, CHANNELS, *geos[k], parts[k])
        errs[k] = check_ozaki_variants(f"{k} (guarantee chain shape)",
                                       geos[k], cases[k], parts[k], packs[k])

    # every path's launches: each stage of each chain went through the kernel
    # in its variant (with the carry on, the conv stage emits the pair and
    # the frac stage, the last, takes its residual as x_lo)
    paths = {  # (stage, carry): (run, (has_lo, emit_pair))
        ("conv", True): (by_on, (False, True)),
        ("frac", True): (by_on, (True, False)),
        ("conv", False): (by_off, (False, False)),
        ("frac", False): (by_off, (False, False))}
    launches = {}
    for (k, carry), (by, var) in paths.items():
        L_f, hop, Kcols, _nb = geos[k]
        launches[(k, carry)] = by.get((hop, L_f, Kcols, *var), 0)
        check(launches[(k, carry)] >= 1,
              f"the guarantee chain (carry {'on' if carry else 'off'}) never "
              f"launched ozaki_framed{var} at the {k} stage")

    # timing
    for carry, rs in ((True, rs_on), (False, rs_off)):
        one_ms = cuda_ms(lambda: rs.oneshot(x), reps=5, warmup=1)
        print(f"timing {card}: guarantee oneshot carry "
              f"{'on' if carry else 'off'} {one_ms:.3f} ms = "
              f"{1e-6 * CHANNELS * N_IN / (one_ms * 1e-3):.1f} Mrops")
    for k, ex in (("conv", conv), ("frac", frac)):
        lib = library_call(ex, cases[k][0], parts[k].double().sum(dim=0),
                           geos[k][1], torch.float64)
        for carry in (True, False):
            has_lo, emit = paths[(k, carry)][1]
            kernels.append(ozaki_record(
                f"ozaki_framed[{k}, x_lo={int(has_lo)}, "
                f"emit_pair={int(emit)}]", ozaki_replaces(ex, has_lo, emit),
                geos[k], cases[k], parts[k], packs[k], has_lo, emit,
                launches[(k, carry)], errs[k][(has_lo, emit)], lib, peaks,
                card))
    del cases, rs_on, rs_off
    torch.cuda.empty_cache()

    # the df32-FFT engines: the kernel at every mode and size, then each
    # path counted, checked and timed with its kernels
    check_fft_cases(dev)
    kernels += fft_paths(dev, x, ref, skip,
                         (peak_f32, peak_bf16, peak_f64, peak_bytes), card)

    # the float32 stage chains: the folded kernel and the scouting GEMM
    # against their plain versions, then each chain counted, checked and
    # timed with its conv-stage kernel call; then the scouting GEMM
    check_sym_cases(dev)
    check_dense_cases(dev)
    kernels += matmul_paths(dev, x, ref, skip, peaks, card)
    kernels += gemm_records(dev, peaks, card)
    del x
    torch.cuda.empty_cache()

    # the half-band, cascade and polynomial paths, then their guarantee
    # chains; each new kernel call shape against its plain version
    kernels += stage_paths(dev, peaks, card)
    kernels += ozaki_paths(dev, peaks, card)

    # the functional transform (gradients through frac_whole's adjoint and
    # through a twin), then fused=True and fused="poly"
    kernels += functional_paths(dev, peaks, card)
    fused_paths(dev, card)

    # the push-mode streams at the serving size, then the chunked oneshot
    kernels += stream_paths(dev, peaks, (peak_f32, peak_bf16, peak_f64,
                                         peak_bytes), card)

    # channel x time-block sharding: in-process meshes, two processes,
    # the dry run
    kernels += sharding_paths(dev, peaks, (peak_f32, peak_bf16, peak_f64,
                                           peak_bytes), card)

    # the CLI on a five-minute stereo master, each way
    kernels += cli_paths(dev, peaks, card, native_build)

    # the acceptance layer: the differential fuzzer's sweep through every
    # executor, its pins, the zerotest, the bank's SNR, the latency curve
    kernels += acceptance_paths(dev, peaks, (peak_f32, peak_bf16, peak_f64,
                                             peak_bytes), card, native_build)

    # the accuracy grid of the matrix: every corner no earlier phase runs,
    # each configuration held to its class against the float64 oracle
    kernels += grid_paths(dev, peaks, (peak_f32, peak_bf16, peak_f64,
                                       peak_bytes), card)

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
