"""Framed matmul of the fused chain: the hand-written CUDA kernel and its
plain PyTorch version.

    y[c, m*O + j] = sum_{d<D} xp[c, m*I + d] * skT[d, j]
                  (+ sum_{d<D} xp[c, m*I + d] * skT_lo[d, j])

Counterpart of the reference package's ``ops/pallas_frac.py``
(``frac_whole_pallas``): the same function, with the optional residual dot
against the f64->f32 operator residual that ``precision="high"`` passes.

``frac_whole`` launches ``csrc/frac_whole.cu`` on a CUDA tensor and runs
``frac_whole_ref`` on a CPU tensor.  The kernel accumulates ``KC``-term
partial sums in registers and folds each into a (sum, compensation) pair
with ``two_sum``; ``frac_whole_ref`` in float32 reproduces that chunking
and fold (each chunk one segmented matmul), so the CPU tests hold the
kernel's accumulation scheme to the -141 dB class.  A single running f32
sum over D = 1027 terms reaches only about -132 dB on the flagship
operator.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .dfloat import two_sum
from .framing import _frames, _framed_matmul

__all__ = ["KC", "frac_whole", "frac_whole_ref"]

#: Terms per partial sum before the two_sum fold (float32 kernel and model).
KC = 32


def _check(xp, skT, I, D, O, n_win, skT_lo):
    if xp.dim() != 2 or skT.shape != (D, O):
        raise ValueError(f"xp must be [C, L] and skT [D={D}, O={O}], got "
                         f"{tuple(xp.shape)} and {tuple(skT.shape)}")
    if xp.dtype not in (torch.float32, torch.float64) or skT.dtype != xp.dtype:
        raise TypeError(f"xp and skT must share float32 or float64, got "
                        f"{xp.dtype} and {skT.dtype}")
    if skT_lo is not None and (skT_lo.shape != skT.shape
                               or skT_lo.dtype != skT.dtype):
        raise ValueError("skT_lo must match skT's shape and dtype")
    if n_win < 1 or I < 1:
        raise ValueError(f"need n_win >= 1 and I >= 1, got {n_win}, {I}")
    if xp.shape[1] < (n_win - 1) * I + D:
        raise ValueError(f"xp has {xp.shape[1]} samples; {n_win} windows "
                         f"need {(n_win - 1) * I + D}")


def _two_sum_fold(hi, lo, acc):
    s, e = two_sum(hi, acc)
    return s, lo + e


def frac_whole_ref(xp: torch.Tensor, skT: torch.Tensor, I: int, D: int,
                   O: int, n_win: int,
                   skT_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``frac_whole``, on any device.

    float64: one framed contraction (segmented reshape views).
    float32: the kernel's accuracy model -- ``KC``-term chunks over d, each
    a segmented matmul, folded with two_sum into (hi, lo); the residual dot
    is one more framed contraction, added as hi + (lo + residual)."""
    _check(xp, skT, I, D, O, n_win, skT_lo)
    C = xp.shape[0]
    if xp.dtype == torch.float64:
        y = _framed_matmul(xp, skT, n_win, I)
        if skT_lo is not None:
            y = y + _framed_matmul(xp, skT_lo, n_win, I)
        return y.reshape(C, n_win * O)
    hi = lo = None
    for d0 in range(0, D, KC):
        d1 = min(D, d0 + KC)
        acc = torch.matmul(_frames(xp[:, d0:], n_win, I, d1 - d0), skT[d0:d1])
        if hi is None:
            hi, lo = acc, torch.zeros_like(acc)
        else:
            hi, lo = _two_sum_fold(hi, lo, acc)
    if skT_lo is not None:
        lo = lo + _framed_matmul(xp, skT_lo, n_win, I)
    return (hi + lo).reshape(C, n_win * O)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launcher(dtype):
    lib = _cuda.load("frac_whole")
    fn = lib.r8b_frac_whole_f32 if dtype == torch.float32 else \
        lib.r8b_frac_whole_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def frac_whole(xp: torch.Tensor, skT: torch.Tensor, I: int, D: int, O: int,
               n_win: int, skT_lo: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """y [C, n_win*O]: y[c, m*O + j] = xp[c, m*I : m*I + D] . skT[:, j]
    (+ the same dot against ``skT_lo``).

    xp: [C, L] with L >= (n_win-1)*I + D and unit stride along time (any
    row stride); skT, skT_lo: contiguous [D, O] of xp's dtype.  On a CUDA
    tensor this launches the kernel (counted in ``frac_whole.launches``) or
    raises; on a CPU tensor it is ``frac_whole_ref``."""
    _check(xp, skT, I, D, O, n_win, skT_lo)
    if xp.device.type == "cpu":
        return frac_whole_ref(xp, skT, I, D, O, n_win, skT_lo)
    if xp.device.type != "cuda":
        raise RuntimeError(f"frac_whole runs on cuda or cpu, not {xp.device}")
    ops = [skT] if skT_lo is None else [skT, skT_lo]
    if any(t.device != xp.device or not t.is_contiguous() for t in ops):
        raise ValueError("skT and skT_lo must be contiguous on xp's device")
    if xp.stride(1) != 1:
        raise ValueError("xp must have unit stride along time")
    C = xp.shape[0]
    y = torch.empty((C, n_win * O), dtype=xp.dtype, device=xp.device)
    if C == 0:
        return y
    fn = _launcher(xp.dtype)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = fn(xp.data_ptr(), xp.stride(0), skT.data_ptr(),
                None if skT_lo is None else skT_lo.data_ptr(), y.data_ptr(),
                C, n_win, I, D, O, stream)
    if rc != 0:
        raise RuntimeError(f"frac_whole kernel launch failed: CUDA error {rc}")
    frac_whole.launches += 1
    return y


frac_whole.launches = 0
