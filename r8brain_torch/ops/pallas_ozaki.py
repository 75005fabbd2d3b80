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
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from . import _cuda
from .dfloat import two_sum
from .framing import _frames
from .ozaki import K0, N_DIAG, N_PARTS

__all__ = ["ozaki_framed", "ozaki_framed_ref", "mma_dot"]


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
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _cuda.load("ozaki_framed")
    lib.r8b_ozaki_framed.argtypes = _ARGTYPES
    lib.r8b_ozaki_framed.restype = ctypes.c_int
    lib.r8b_ozaki_mma_dot.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.r8b_ozaki_mma_dot.restype = ctypes.c_int
    return lib


def ozaki_framed(xp: torch.Tensor, sx: torch.Tensor, T_parts: torch.Tensor,
                 L_f: int, hop: int, Kcols: int, n_blocks: int,
                 x_lo: Optional[torch.Tensor] = None,
                 emit_pair: bool = False):
    """y [C, n_blocks*Kcols] float32, or the (hi float32, lo bfloat16) pair
    when ``emit_pair``: y[c, b*Kcols + k] = xp[c, b*hop : b*hop + L_f] .
    T[:, k] in the split form (``x_lo``'s window product added).

    xp: [C, N >= (n_blocks-1)*hop + L_f] float32, unit stride along time;
    sx: [C, 1] float32 powers of two >= each channel's max |xp| over the
    windows (``ozaki.channel_scale``); T_parts: [4, L_f, Kcols] bfloat16
    from ``ozaki.split_operator_host``; x_lo: bfloat16, xp's shape.  On a
    CUDA tensor this launches the kernel or raises; on a CPU tensor it is
    ``ozaki_framed_ref``.  Each launch adds one to ``ozaki_framed.launches``
    and to ``ozaki_framed.launches_by[(hop, L_f, Kcols, has_lo,
    emit_pair)]``, so a run can tell the stages and variants apart."""
    _check(xp, sx, T_parts, L_f, hop, Kcols, n_blocks, x_lo)
    if xp.device.type == "cpu":
        return ozaki_framed_ref(xp, sx, T_parts, L_f, hop, Kcols, n_blocks,
                                x_lo=x_lo, emit_pair=emit_pair)
    if xp.device.type != "cuda":
        raise RuntimeError(f"ozaki_framed runs on cuda or cpu, not "
                           f"{xp.device}")
    if any(t.device != xp.device or not t.is_contiguous()
           for t in (sx, T_parts)):
        raise ValueError("sx and T_parts must be contiguous on xp's device")
    if xp.stride(1) != 1 or (x_lo is not None and (
            x_lo.device != xp.device or x_lo.stride(1) != 1)):
        raise ValueError("xp and x_lo must have unit stride along time, on "
                         "one device")
    C = xp.shape[0]
    y = torch.empty((C, n_blocks * Kcols), dtype=torch.float32,
                    device=xp.device)
    yl = torch.empty((C, n_blocks * Kcols), dtype=torch.bfloat16,
                     device=xp.device) if emit_pair else None
    if C > 0:
        with torch.cuda.device(xp.device):
            stream = torch.cuda.current_stream(xp.device).cuda_stream
            rc = _lib().r8b_ozaki_framed(
                xp.data_ptr(), xp.stride(0), sx.data_ptr(),
                T_parts.data_ptr(),
                None if x_lo is None else x_lo.data_ptr(),
                0 if x_lo is None else x_lo.stride(0), y.data_ptr(),
                None if yl is None else yl.data_ptr(), C, n_blocks, hop, L_f,
                Kcols, stream)
        if rc != 0:
            raise RuntimeError(f"ozaki_framed kernel launch failed: CUDA "
                               f"error {rc}")
        ozaki_framed.launches += 1
        ozaki_framed.launches_by[
            (hop, L_f, Kcols, x_lo is not None, emit_pair)] += 1
    return (y, yl) if emit_pair else y


ozaki_framed.launches = 0
ozaki_framed.launches_by = Counter()


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
