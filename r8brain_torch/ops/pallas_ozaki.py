"""Split-operand (Ozaki) framed matmul: the hand-written CUDA kernel and
its plain PyTorch version.

    y[c, b*Kcols + k] = sum_{l < L_f} xp[c, b*hop + l] * T[l, k]

computed error-free on the per-channel power-of-two grid (``ops/ozaki.py``):
the input window split into 4 bfloat16 slices, the 10 slice pairs with
p+q < 4 against the host-split operator ``T_parts`` in ``K0``-deep chunks,
the d = 0 chunk results folded with ``two_sum`` into (hi, lo), the d >= 1
ones summed into ``rest``; with ``x_lo`` (the previous seam's bfloat16
residual) one more pass against ``T_parts[0]`` into ``cheap``; then one of
three output combines.

Counterpart of the reference package's ``ops/pallas_ozaki.py``: every one
of its four TPU kernels is this function at some argument set.

=============================  =========================================
reference TPU kernel           here
=============================  =========================================
``ozaki_matmul_pallas``        ``ozaki_framed(...)`` at the conv geometry
``_ozaki_matmul_pallas_var``   ``x_lo`` and/or ``emit_pair=True``
``ozaki_dense_pallas``         ``ozaki_framed(...)`` at the frac geometry
``ozaki_dense_pallas_pair``    the same, ``emit_pair=True``
=============================  =========================================

The dense TPU kernels took pre-framed rows ([R, Kpad], built XLA-side
only because the TPU's DMA needs 128-aligned starts) and per-row scales;
here every caller passes the signal and per-channel scales and the kernel
reads its windows straight from ``xp`` (implicit im2col).

``ozaki_framed`` launches ``csrc/ozaki_framed.cu`` on a CUDA tensor and
runs ``ozaki_framed_ref`` on a CPU tensor.  Both make every (p, q) chunk
product exactly and fold in the reference kernel's order (chunk, then p,
then q), so without ``x_lo`` the two agree bit for bit; the inexact
``cheap`` pass (~2^-24 of the output) is summed in another order on the
card, which may move the last bit of an output.

The kernel takes the operator as ``pack_operator(T_parts)``, which each
executor builds once: per (32-column tile, 64-deep k-tile) one contiguous
block of the four slices, each a K-major 128-byte-swizzled bf16 tile
(``pallas_frac``'s packing), and per column tile the range of k-tiles
that hold nonzeros.  ``wgmma_dot`` and ``mma_dot`` are the probes that pin
the exactness lemma on the card, on the kernel's own wgmma path and on
``mma.sync``; ``lemma_operands`` are their operands.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import numpy as np
import torch

from . import _cuda
from .dfloat import two_sum
from .framing import _frames
from .ozaki import K0, N_DIAG, N_PARTS
from .pallas_frac import TILE_K, _pack

__all__ = ["TILE_N", "pack_operator", "ozaki_framed", "ozaki_framed_ref",
           "wgmma_dot", "mma_dot", "lemma_operands"]

#: Output columns of a column tile of the packed operator and the kernel
#: (a tile of each of the four slices; the kernel's widest product,
#: A_0 x [s0|s1|s2|s3], is 4 * TILE_N = 128 columns).
TILE_N = 32


def pack_operator(T_parts: torch.Tensor):
    """(tiles, bands): the operator slices [4, L_f, Kcols] bfloat16 in the
    form the kernel reads, on T_parts' device.

    tiles: bfloat16 [n_ct, n_kt, 4, TILE_N, TILE_K], zero-padded to whole
    tiles (n_ct = ceil(Kcols / TILE_N), n_kt = ceil(L_f / TILE_K)), each
    [TILE_N, TILE_K] slice tile K-major and 128-byte swizzled: one
    contiguous 16 KB block per (column tile, k-tile), copied to shared
    memory as it lies, where the four slices stacked are one [128, 64]
    operand.  bands: int32 [n_ct, 2], the first and one past the last
    k-tile of each column tile that holds a nonzero entry (0, 0 for an
    all-zero tile); the kernel skips the others.  ``pallas_frac.
    unpack_parts(tiles, L_f, Kcols)`` inverts the packing."""
    if T_parts.dim() != 3 or T_parts.shape[0] != N_PARTS \
            or T_parts.dtype != torch.bfloat16:
        raise ValueError(f"T_parts must be bfloat16 [{N_PARTS}, L_f, "
                         f"Kcols], got {T_parts.dtype} "
                         f"{tuple(T_parts.shape)}")
    _P, L_f, Kcols = T_parts.shape
    n_kt, n_ct = -(-L_f // TILE_K), -(-Kcols // TILE_N)
    tiles = _pack(T_parts.float(), TILE_N)
    nz = torch.zeros((n_kt * TILE_K, n_ct * TILE_N), dtype=torch.bool,
                     device=T_parts.device)
    nz[:L_f, :Kcols] = (T_parts != 0).any(dim=0)
    nz = nz.reshape(n_kt, TILE_K, n_ct, TILE_N).any(dim=3).any(dim=1).T
    kt = torch.arange(n_kt, device=T_parts.device)
    any_nz = nz.any(dim=1)
    first = torch.where(nz, kt, n_kt).amin(dim=1)
    last = torch.where(nz, kt, -1).amax(dim=1) + 1
    bands = torch.stack([torch.where(any_nz, first, 0),
                         torch.where(any_nz, last, 0)], dim=1)
    return tiles, bands.to(torch.int32).contiguous()


def _check_packed(packed, L_f, Kcols, device):
    tiles, bands = packed
    n_kt, n_ct = -(-L_f // TILE_K), -(-Kcols // TILE_N)
    want = (n_ct, n_kt, N_PARTS, TILE_N, TILE_K)
    if (tuple(tiles.shape) != want or tiles.dtype != torch.bfloat16
            or tuple(bands.shape) != (n_ct, 2) or bands.dtype != torch.int32):
        raise ValueError(f"the operator was packed for another tiling: "
                         f"want tiles bfloat16 {want} and bands int32 "
                         f"({n_ct}, 2) (pack_operator of [{N_PARTS}, "
                         f"L_f={L_f}, Kcols={Kcols}]), got {tiles.dtype} "
                         f"{tuple(tiles.shape)} and {bands.dtype} "
                         f"{tuple(bands.shape)}")
    if any(t.device != device or not t.is_contiguous()
           for t in (tiles, bands)):
        raise ValueError("the packed operator must be contiguous on xp's "
                         "device")


def _check(xp, sx, T_parts, L_f, hop, Kcols, n_blocks, x_lo):
    if xp.dim() != 2 or xp.dtype != torch.float32:
        raise TypeError(f"xp must be a float32 [C, N] tensor, got "
                        f"{xp.dtype} {tuple(xp.shape)}")
    C = xp.shape[0]
    if sx.shape != (C, 1) or sx.dtype != torch.float32:
        raise ValueError(f"sx must be float32 [{C}, 1], got {sx.dtype} "
                         f"{tuple(sx.shape)}")
    if T_parts.shape != (N_PARTS, L_f, Kcols) \
            or T_parts.dtype != torch.bfloat16:
        raise ValueError(f"T_parts must be bfloat16 [{N_PARTS}, L_f={L_f}, "
                         f"Kcols={Kcols}], got {T_parts.dtype} "
                         f"{tuple(T_parts.shape)}")
    if n_blocks < 1 or hop < 1 or L_f < 1 or Kcols < 1:
        raise ValueError(f"need n_blocks, hop, L_f, Kcols >= 1, got "
                         f"{n_blocks}, {hop}, {L_f}, {Kcols}")
    span = (n_blocks - 1) * hop + L_f
    if xp.shape[1] < span:
        raise ValueError(f"xp has {xp.shape[1]} samples; {n_blocks} "
                         f"windows need {span}")
    if x_lo is not None and (x_lo.dim() != 2 or x_lo.shape[0] != C
                             or x_lo.shape[1] < span
                             or x_lo.dtype != torch.bfloat16):
        raise ValueError(f"x_lo must be bfloat16 [{C}, >= {span}], got "
                         f"{x_lo.dtype} {tuple(x_lo.shape)}")


def ozaki_framed_ref(xp: torch.Tensor, sx: torch.Tensor,
                     T_parts: torch.Tensor, L_f: int, hop: int, Kcols: int,
                     n_blocks: int, x_lo: Optional[torch.Tensor] = None,
                     emit_pair: bool = False):
    """Plain PyTorch version of ``ozaki_framed``, on any device: the
    kernel's split (multiply by the power-of-two reciprocals, round half to
    even), its ``K0`` chunks over l, each (p, q) product an exact float32
    matmul of the upcast slices, and its fold and combines."""
    _check(xp, sx, T_parts, L_f, hop, Kcols, n_blocks, x_lo)
    C = xp.shape[0]
    span = (n_blocks - 1) * hop + L_f
    r = xp[:, :span] * (1.0 / sx)
    parts = []
    for p in range(N_PARTS):
        q = torch.round(r * float(256 ** (p + 1))) * 2.0 ** (-8 * (p + 1))
        parts.append(q.to(torch.bfloat16))
        r = r - q
    shape = (C, n_blocks, Kcols)
    z = dict(dtype=torch.float32, device=xp.device)
    hi, lo, rest = (torch.zeros(shape, **z) for _ in range(3))
    cheap = torch.zeros(shape, **z) if x_lo is not None else None
    for a0 in range(0, L_f, K0):
        a1 = min(L_f, a0 + K0)
        fr = [_frames(parts[p][:, a0:], n_blocks, hop, a1 - a0).float()
              for p in range(N_PARTS)]
        for p in range(N_PARTS):
            for q in range(N_DIAG - p):
                o = torch.matmul(fr[p], T_parts[q, a0:a1].float())
                if p + q == 0:
                    s, err = two_sum(hi, o)
                    hi, lo = s, lo + err
                else:
                    rest = rest + o
        if x_lo is not None:
            frl = _frames(x_lo[:, a0:span], n_blocks, hop, a1 - a0).float()
            cheap = cheap + torch.matmul(frl, T_parts[0, a0:a1].float())
    s = sx[:, :, None]
    if not emit_pair:
        if x_lo is not None:
            y = hi * s + ((lo + rest) * s + cheap)
        else:
            y = (hi + (lo + rest)) * s
        return y.reshape(C, n_blocks * Kcols)
    small = (lo + rest) * s
    if x_lo is not None:
        small = small + cheap
    H, L = two_sum(hi * s, small)
    return (H.reshape(C, n_blocks * Kcols),
            L.to(torch.bfloat16).reshape(C, n_blocks * Kcols))


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/ozaki_framed.cu``."""
    lib.r8b_ozaki_framed.argtypes = _ARGTYPES
    lib.r8b_ozaki_wgmma_dot.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.r8b_ozaki_mma_dot.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in (lib.r8b_ozaki_framed, lib.r8b_ozaki_wgmma_dot,
               lib.r8b_ozaki_mma_dot):
        fn.restype = ctypes.c_int
    return lib


def _lib():
    return set_argtypes(_cuda.load("ozaki_framed"))


def launch_args(xp, sx, packed, L_f, hop, Kcols, n_blocks, x_lo, y, yl):
    """The argument list of ``r8b_ozaki_framed`` (without the stream)."""
    tiles, bands = packed
    n_ct, n_kt, _P, bn, _tk = tiles.shape
    return (xp.data_ptr(), xp.stride(0), sx.data_ptr(), tiles.data_ptr(),
            bands.data_ptr(), n_ct, n_kt, bn,
            None if x_lo is None else x_lo.data_ptr(),
            0 if x_lo is None else x_lo.stride(0), y.data_ptr(),
            None if yl is None else yl.data_ptr(), xp.shape[0], n_blocks,
            hop, L_f, Kcols)


def ozaki_framed(xp: torch.Tensor, sx: torch.Tensor, T_parts: torch.Tensor,
                 L_f: int, hop: int, Kcols: int, n_blocks: int,
                 x_lo: Optional[torch.Tensor] = None,
                 emit_pair: bool = False, packed=None):
    """y [C, n_blocks*Kcols] float32, or the (hi float32, lo bfloat16) pair
    when ``emit_pair``: y[c, b*Kcols + k] = xp[c, b*hop : b*hop + L_f] .
    T[:, k] in the split form (``x_lo``'s window product added).

    xp: [C, N >= (n_blocks-1)*hop + L_f] float32, unit stride along time;
    sx: [C, 1] float32 powers of two >= each channel's max |xp| over the
    windows (``ozaki.channel_scale``); T_parts: [4, L_f, Kcols] bfloat16
    from ``ozaki.split_operator_host``; x_lo: bfloat16, xp's shape;
    packed: ``pack_operator(T_parts)`` on xp's device, which the executors
    build once (packed here at each call when None).  On a CUDA tensor
    this launches the kernel or raises; on a CPU tensor it is
    ``ozaki_framed_ref``.  It has no gradient: an input that autograd or
    torch.func tracks raises (``_cuda.no_gradient``).  Each launch adds one to ``ozaki_framed.launches``
    and to ``ozaki_framed.launches_by[(hop, L_f, Kcols, has_lo,
    emit_pair)]``, so a run can tell the stages and variants apart."""
    _check(xp, sx, T_parts, L_f, hop, Kcols, n_blocks, x_lo)
    _cuda.no_gradient("ozaki_framed", xp, x_lo)
    if packed is not None:
        _check_packed(packed, L_f, Kcols, xp.device)
    if xp.device.type == "cpu":
        return ozaki_framed_ref(xp, sx, T_parts, L_f, hop, Kcols, n_blocks,
                                x_lo=x_lo, emit_pair=emit_pair)
    if xp.device.type != "cuda":
        raise RuntimeError(f"ozaki_framed runs on cuda or cpu, not "
                           f"{xp.device}")
    if sx.device != xp.device or not sx.is_contiguous():
        raise ValueError("sx must be contiguous on xp's device")
    if xp.stride(1) != 1 or (x_lo is not None and (
            x_lo.device != xp.device or x_lo.stride(1) != 1)):
        raise ValueError("xp and x_lo must have unit stride along time, on "
                         "one device")
    if packed is None:
        packed = pack_operator(T_parts.to(xp.device))
    C = xp.shape[0]
    y = torch.empty((C, n_blocks * Kcols), dtype=torch.float32,
                    device=xp.device)
    yl = torch.empty((C, n_blocks * Kcols), dtype=torch.bfloat16,
                     device=xp.device) if emit_pair else None
    if C > 0:
        with torch.cuda.device(xp.device):
            stream = torch.cuda.current_stream(xp.device).cuda_stream
            rc = _lib().r8b_ozaki_framed(
                *launch_args(xp, sx, packed, L_f, hop, Kcols, n_blocks,
                             x_lo, y, yl), stream)
        if rc != 0:
            raise RuntimeError(f"ozaki_framed kernel launch failed: CUDA "
                               f"error {rc}")
        ozaki_framed.launches += 1
        ozaki_framed.launches_by[
            (hop, L_f, Kcols, x_lo is not None, emit_pair)] += 1
    return (y, yl) if emit_pair else y


ozaki_framed.launches = 0
ozaki_framed.launches_by = Counter()


def wgmma_dot(a: torch.Tensor, T_parts: torch.Tensor) -> torch.Tensor:
    """[4, 64, TILE_N] float32: out[q] = a [64, K] @ T_parts[q] [K,
    TILE_N] (bfloat16 on the card, K <= K0) through the kernel's own
    tensor-core path: the four slices packed by ``pack_operator`` and
    moved by a bulk copy, A from registers, the m64n128k16 wgmma over
    [s0|s1|s2|s3], every k16 step of K chained into one float32
    accumulator.  The probe that pins the exactness lemma for the kernel;
    not a path of the resampler."""
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 \
            or T_parts.dtype != torch.bfloat16 or T_parts.device != a.device:
        raise ValueError("wgmma_dot takes two bfloat16 CUDA tensors")
    K = a.shape[1]
    if a.shape[0] != 64 or K > K0 or T_parts.shape != (N_PARTS, K, TILE_N):
        raise ValueError(f"wgmma_dot takes a [64, K <= {K0}] and T_parts "
                         f"[{N_PARTS}, K, {TILE_N}], got {tuple(a.shape)} "
                         f"and {tuple(T_parts.shape)}")
    tiles, _bands = pack_operator(T_parts)
    n_kt = tiles.shape[1]
    ap = torch.zeros((64, n_kt * TILE_K), dtype=torch.bfloat16,
                     device=a.device)
    ap[:, :K] = a
    out = torch.empty((N_PARTS, 64, TILE_N), dtype=torch.float32,
                      device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().r8b_ozaki_wgmma_dot(ap.data_ptr(), tiles.data_ptr(),
                                        out.data_ptr(), n_kt, stream)
    if rc != 0:
        raise RuntimeError(f"wgmma_dot launch failed: CUDA error {rc}")
    return out


def mma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] (bfloat16, on the card) into one float32
    accumulator per output through the kernel's own tensor-core product
    (``mma.sync`` m16n8k16, 16 terms a step): the probe that pins the
    exactness lemma on the card.  Not a path of the resampler."""
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 \
            or b.dtype != torch.bfloat16 or b.device != a.device:
        raise ValueError("mma_dot takes two bfloat16 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"inner sizes differ: {K} and {b.shape[0]}")
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().r8b_ozaki_mma_dot(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"mma_dot launch failed: CUDA error {rc}")
    return out


def lemma_operands(seed: int, p: int, q: int, M: int = 64, K: int = K0,
                   N: int = TILE_N):
    """{kind: (a [M, K], b [K, N])} bfloat16 slice operands of the pair
    (p, q) on the grids of slice p (step 2^-8(p+1)) and slice q, for the
    probes of the exactness lemma (a K0-deep float32 accumulation of the
    products is exact): "worst case" (every product +-256 units squared,
    so a row of all one sign sums to exactly 2^24 units), "random units"
    (uniform integers in [-256, 256]), "gaussian split" (the slices of
    split Gaussian data) and "mixed magnitude" (+-1-unit entries with one
    256-unit entry in each row of a and each column of b: where they meet,
    one 2^16 product among products of 1)."""
    from .ozaki import split_input, split_operator_host

    rng = np.random.default_rng(seed)
    worst = np.ones((M, K)), np.ones((K, N))
    signs = np.where(rng.random((M, 1)) < 0.5, -1.0, 1.0)
    worst = worst[0] * signs, worst[1]  # all one sign a row
    units = rng.integers(-256, 257, (M, K)), rng.integers(-256, 257, (K, N))
    ka, kb = rng.integers(0, K, M), rng.integers(0, K, N)
    kb[: min(M, N)] = ka[: min(M, N)]  # the first min(M, N) diagonal meet
    mixed_a = rng.choice([-1.0, 1.0], (M, K))
    mixed_a[np.arange(M), ka] *= 256
    mixed_b = rng.choice([-1.0, 1.0], (K, N))
    mixed_b[kb, np.arange(N)] *= 256
    cases = {"worst case": (worst[0] * 256, worst[1] * 256),
             "random units": units,
             "mixed magnitude": (mixed_a, mixed_b)}
    out = {k: (torch.from_numpy(a * 2.0**(-8 * (p + 1))).bfloat16(),
               torch.from_numpy(b * 2.0**(-8 * (q + 1))).bfloat16())
           for k, (a, b) in cases.items()}
    xparts, _ = split_input(torch.from_numpy(rng.standard_normal((M, K))))
    tparts, _ = split_operator_host(rng.standard_normal((K, N)))
    out["gaussian split"] = (xparts[p], tparts[q])
    return out
