"""The polynomial stage's fast contraction: the hand-written CUDA kernel
and its plain PyTorch version.

    y[c, n] = sum_{i < fl} x[c, starts[n] + i] * taps[n, i]

with x read as 0 outside [0, N).  ``FracPolyExec`` (``ops/stages.py``)
runs it for its float32 ``"banded"`` engine under ``precision="fast"``
without a seam residual or a pair: ``starts`` are the outputs' window
starts in x's own coordinates and ``taps`` the spline filters, their
float64 values rounded once to float32, the very values its banded
operators hold.  It replaces no TPU kernel: the reference package's
polynomial stage is XLA (``csrc/poly_dot.cu`` says what the kernel replaces
and how it is built).

``poly_dot`` launches ``csrc/poly_dot.cu`` on a CUDA tensor and runs
``poly_dot_ref`` on a CPU tensor.  The kernel sums each output as one fmaf
chain in tap order; the plain version rounds each product and adds it to
the running sum in the same order.  The two differ by at most
2 * fl * 2^-24 * sum_i |x[c, starts[n] + i] * taps[n, i]| an output (each
sum's rounding error is within (fl - 1) * 2^-24 of that sum of
magnitudes, whatever the order), which ``abs_bound`` computes.

The function is linear in x and differentiable in it (torch.autograd and
torch.func): the backward is its adjoint in plain PyTorch (one scatter-add
a tap), the jvp the function on the tangent, and vmap folds batch
dimensions into rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.trace import spanned
from . import _cuda

__all__ = ["POLY_TILE", "tile_width", "poly_dot", "poly_dot_ref",
           "abs_bound"]

#: Outputs a block of the kernel computes, from output 0 (csrc TILE).
POLY_TILE = 64

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def tile_width(starts: np.ndarray, fl: int) -> int:
    """The samples of x a tile of the kernel's ``POLY_TILE`` consecutive
    outputs reads at most: the largest max - min of ``starts`` over a tile,
    plus fl (the kernel's shared-memory rows, sized once a length on the
    host)."""
    s = np.asarray(starts, np.int64)
    if s.size == 0:
        return fl
    pad = -s.size % POLY_TILE
    s = np.concatenate([s, np.repeat(s[-1], pad)]).reshape(-1, POLY_TILE)
    return int((s.max(axis=1) - s.min(axis=1)).max()) + fl


def poly_dot_ref(x: torch.Tensor, starts: torch.Tensor,
                 taps: torch.Tensor) -> torch.Tensor:
    """The plain version: one gather a tap of x zero-padded to the windows'
    reach, each product rounded and added in tap order."""
    C, N = x.shape
    M, fl = taps.shape
    y = x.new_zeros((C, M))
    if M == 0:
        return y
    s = starts.long()
    pad_l = max(0, -int(s.min()))
    pad_r = max(0, int(s.max()) + fl - N)
    xp = F.pad(x, (pad_l, pad_r))
    idx = s + pad_l
    for i in range(fl):
        y = y + xp[:, idx + i] * taps[:, i]
    return y


def abs_bound(x: torch.Tensor, starts: torch.Tensor,
              taps: torch.Tensor) -> torch.Tensor:
    """[C, M]: the bound on |kernel - plain| an output, 2 * fl * 2^-24 *
    sum_i |x[c, starts[n] + i] * taps[n, i]| (in float64)."""
    fl = taps.shape[1]
    mag = poly_dot_ref(x.double().abs(), starts, taps.double().abs())
    return 2.0 * fl * 2.0**-24 * mag


def _launch(x: torch.Tensor, starts: torch.Tensor, taps: torch.Tensor,
            width: Optional[int]) -> torch.Tensor:
    """One launch of the kernel (counted in ``poly_dot.launches``)."""
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("x must have unit stride along time")
    C, N = x.shape
    M, fl = taps.shape
    if N == 0:  # every window reads zeros
        return x.new_zeros((C, M))
    y = torch.empty((C, M), dtype=x.dtype, device=x.device)
    if C == 0 or M == 0:
        return y
    if width is None:
        width = tile_width(starts.cpu().numpy(), fl)
    lib = _cuda.load("poly_dot")
    fn = lib.r8b_poly_dot_f32
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), x.stride(0), N, starts.data_ptr(),
                taps.data_ptr(), fl, y.data_ptr(), C, M, width, stream)
    if rc != 0:
        raise RuntimeError(f"poly_dot kernel launch failed: CUDA error {rc}")
    poly_dot.launches += 1
    return y


def _run(x, starts, taps, width):
    if x.device.type == "cpu":
        return poly_dot_ref(x, starts, taps)
    if x.device.type != "cuda":
        raise RuntimeError(f"poly_dot runs on cuda or cpu, not {x.device}")
    return _launch(x, starts, taps, width)


def _adjoint(gy: torch.Tensor, starts: torch.Tensor, taps: torch.Tensor,
             N: int) -> torch.Tensor:
    """xbar [C, N] = poly_dot's transpose on gy [C, M]: each tap's products
    scatter-added to their samples, those outside [0, N) dropped."""
    M, fl = taps.shape
    idx = starts.long()[:, None] + torch.arange(fl, device=starts.device)
    inside = (idx >= 0) & (idx < N)
    w = torch.where(inside, taps, torch.zeros_like(taps))
    idx = idx.clamp(0, max(N - 1, 0))
    gx = gy.new_zeros((*gy.shape[:-1], N))
    if N == 0:
        return gx
    for i in range(fl):
        gx = gx.index_add(-1, idx[:, i], gy * w[:, i])
    return gx


class _PolyDot(torch.autograd.Function):
    """poly_dot as a linear map of x (starts and taps are constants)."""

    @staticmethod
    def forward(x, starts, taps, width):
        return _run(x, starts, taps, width)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, starts, taps, width = inputs
        ctx.geo = (x.shape[1], width)
        ctx.save_for_backward(starts, taps)
        ctx.save_for_forward(starts, taps)

    @staticmethod
    def backward(ctx, gy):
        if not ctx.needs_input_grad[0]:
            return (None,) * 4
        starts, taps = ctx.saved_tensors
        return (_adjoint(gy, starts, taps, ctx.geo[0]),) + (None,) * 3

    @staticmethod
    def jvp(ctx, gx, *_rest):
        if gx is None:
            return None
        starts, taps = ctx.saved_tensors
        return _PolyDot.apply(gx.contiguous(), starts, taps, ctx.geo[1])

    @staticmethod
    def vmap(info, in_dims, x, starts, taps, width):
        if in_dims[1] is not None or in_dims[2] is not None:
            raise ValueError("poly_dot's starts and taps cannot be batched")
        if in_dims[0] is None:
            return _PolyDot.apply(x, starts, taps, width), None
        xb = x.movedim(in_dims[0], 0)
        B, C = xb.shape[0], xb.shape[1]
        y = _PolyDot.apply(xb.reshape(B * C, xb.shape[2]).contiguous(),
                           starts, taps, width)
        return y.reshape(B, C, y.shape[1]), 0


def _check(x, starts, taps, width):
    if x.dim() != 2:
        raise ValueError(f"x must be [C, N], got {tuple(x.shape)}")
    if x.dtype != torch.float32 or taps.dtype != torch.float32:
        raise TypeError(f"poly_dot takes float32 x and taps, got "
                        f"{x.dtype} and {taps.dtype}")
    if starts.dtype != torch.int32:
        raise TypeError(f"starts must be int32, got {starts.dtype}")
    if taps.dim() != 2 or taps.shape[1] < 1 or starts.dim() != 1 \
            or starts.shape[0] != taps.shape[0]:
        raise ValueError(f"need starts [M] and taps [M, fl >= 1], got "
                         f"{tuple(starts.shape)} and {tuple(taps.shape)}")
    if not (starts.is_contiguous() and taps.is_contiguous()):
        raise ValueError("starts and taps must be contiguous")
    if starts.device != x.device or taps.device != x.device:
        raise ValueError(f"starts and taps must lie on x's device "
                         f"{x.device}, got {starts.device}, {taps.device}")
    if width is not None and not (isinstance(width, int)
                                  and taps.shape[1] <= width <= 1 << 20):
        raise ValueError(f"width must be an int in [fl, 2^20], got {width!r}")


@spanned("r8b.kernel.poly_dot")
def poly_dot(x: torch.Tensor, starts: torch.Tensor, taps: torch.Tensor,
             width: Optional[int] = None) -> torch.Tensor:
    """y [C, M]: y[c, n] = sum_{i < fl} x[c, starts[n] + i] * taps[n, i],
    x read as 0 outside [0, N).

    x: [C, N] float32 with unit stride along time (any row stride);
    starts: int32 [M] in x's coordinates; taps: float32 [M, fl], both
    contiguous on x's device; width: ``tile_width(starts, fl)``, which a
    caller that calls often computes once on the host (without it, a call
    on the card copies starts to the host).  The width sizes the kernel's
    shared-memory rows only: a tile of outputs whose windows span more
    reads x from global memory, the same sums, slower.  On a CUDA tensor
    this launches the kernel (counted in ``poly_dot.launches``) or raises;
    on a CPU tensor it is
    ``poly_dot_ref``.  Within ``abs_bound`` of the plain version, not bit
    for bit.  Differentiable in x (module docstring)."""
    _check(x, starts, taps, width)
    return _PolyDot.apply(x, starts, taps, width)


poly_dot.launches = 0
