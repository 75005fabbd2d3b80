"""Overlap-save FFT convolution in FP64: the hand-written CUDA kernel, its
plain PyTorch version and the host plan.

    frame f of row c:  x_f[t] = u[c, f*hop + t]        (zero past u's end)
    w[c, f*hop + t]  = (x_f (*) k)[head + t],  t < hop = n - head

with (*) the circular convolution of length n, rounded once to float32.
With a second spectrum (polyphase mode) the output interleaves the even
and odd kernel halves, ``w[c, 2*(f*hop + t) + p] = (x_f (*) k_p)[head +
t]``: the up = 2 convolution of the zero-stuffed signal, which is never
built.

Counterpart of the reference package's three df32-FFT kernel files,
``ops/pallas_dfft5.py``, ``ops/pallas_dfft4.py`` and ``ops/pallas_dfft.py``:
their five TPU kernels compute this one function (the float64 convolution
rounded to float32) in two-float arithmetic, and differ only in TPU layout
work-arounds.  Here each is one argument set of ``df_fft_conv``:

=======================================  ================================
reference TPU kernel                     here
=======================================  ================================
``df_ols_convolve_pallas5``              ``head=0`` (frames mode) over a
``df_ols_convolve_pallas4``              frame tensor viewed as one
``df_ols_convolve_pallas``               signal a row; the conv stage
                                         passes the padded signal itself
                                         with ``head=P`` ("framed")
``df_ols_convolve_pallas5_framed``       ``head=n/4`` ("framed")
``df_ols_convolve_pallas5_framed_poly``  a plan with ``H2`` ("poly")
=======================================  ================================

The card has native FP64, so the kernel (``csrc/df_fft_conv.cu``) runs its
butterflies and the spectrum product in double and rounds only the output;
the TPU kernels' permuted twiddle, mask and transposed-spectrum planes are
Mosaic layout and have no counterpart.  Up to ``SMEM_MAX_N`` the kernel
keeps each transform's points in registers and runs radix-16 passes
(``pass_radices``); its forward transform leaves the spectrum in
``digit_order``, and the plan stores G in that order (``DfFFTPlan.Gk``),
so the product needs no reordering.  ``df_fft_conv`` launches the
kernel on a CUDA tensor and runs ``df_fft_conv_ref`` (``torch.fft`` in
complex128) on a CPU tensor; the two agree to the float32 rounding of the
output (a last-bit difference at most).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.trace import spanned
from . import _cuda
from .framing import _frames

__all__ = ["supported_n", "framed_supported", "pass_radices", "digit_order",
           "DfFFTPlan", "df_fft_conv", "df_fft_conv_ref", "MIN_N", "MAX_N",
           "SMEM_MAX_N"]

#: Transform sizes the kernel takes: every power of two in [MIN_N, MAX_N].
MIN_N, MAX_N = 128, 65536
#: Up to this size the kernel keeps a transform's points in the registers
#: of one CTA (16 a thread); above it the kernel runs the four-step split
#: through a float64 scratch.
SMEM_MAX_N = 8192
#: Points a thread of the register-resident kernel holds.
RADIX = 16
#: Bytes of four-step scratch one call allocates at most (it runs its
#: transforms in chunks that fit); the kernel takes at most 65535 a launch.
SCRATCH_BYTES = 1 << 28
_LANES = 128


def supported_n(n: int) -> bool:
    """The reference's four-step geometry rule (``pallas_dfft5.py:75``): n
    = A*128 with A a power of two, 8 <= A <= 128.  It decides the
    ``pallas_fft5`` engine's plan, not what this kernel can run."""
    if n % _LANES:
        return False
    A = n // _LANES
    return 8 <= A <= 128 and (A & (A - 1)) == 0


def framed_supported(n: int) -> bool:
    """The reference's framed-mode rule (``pallas_dfft5.py:84``): n >=
    4096, where the TPU's frame starts land on sublane tiles."""
    return supported_n(n) and n >= 4096


def pass_radices(n: int) -> tuple:
    """The register-resident kernel's passes, forward order (n <=
    SMEM_MAX_N): radix 2^(log2(n) mod 4) first (16 when that is 0), then
    radix 16: (16, 16, 16) at 4096, (2, 16, 16, 16) at 8192."""
    b = n.bit_length() - 1
    r0 = 1 << (b % 4 or 4)
    return (r0,) + (RADIX,) * ((b - (b % 4 or 4)) // 4)


def digit_order(n: int) -> np.ndarray:
    """The frequency index of the point that the kernel's forward transform
    (decimation in frequency over ``pass_radices(n)``) leaves at each
    position: position p = sum_i k_i * n/(r_0...r_i), digit k_i < r_i of
    pass i, holds X[k_0 + r_0*k_1 + r_0*r_1*k_2 + ...]."""
    p = np.arange(n)
    idx = np.zeros(n, dtype=np.int64)
    w_pos, w_x = n, 1
    for r in pass_radices(n):
        w_pos //= r
        idx += (p // w_pos) % r * w_x
        w_x *= r
    return idx


class DfFFTPlan(nn.Module):
    """Host constants of one convolution: the transform size ``n``, the
    natural-order complex128 spectrum ``G`` (``H``, the kernel's ``fft(k,
    n)/n``, or ``H + 1j*H2`` in polyphase mode), the twiddle table ``tw``
    (``exp(-2*pi*i*e/n)``, e < n) and, for n <= SMEM_MAX_N, ``Gk``: G in
    the kernel's order, ``Gk[m, tau] = G[digit_order(n)[16*tau + m]]``
    ([16, n/16]: the point that thread tau holds in register m after the
    forward transform, read coalesced), as buffers that move with the
    module."""

    def __init__(self, n: int, H: np.ndarray, H2: Optional[np.ndarray] = None):
        super().__init__()
        if n < MIN_N or n > MAX_N or n & (n - 1):
            raise ValueError(f"n must be a power of two in [{MIN_N}, "
                             f"{MAX_N}], got {n}")
        H = np.asarray(H, dtype=np.complex128)
        if H.shape != (n,) or (H2 is not None and np.shape(H2) != (n,)):
            raise ValueError(f"spectra must have length n={n}")
        self.n = n
        self.poly = H2 is not None
        G = H if H2 is None else H + 1j * np.asarray(H2, np.complex128)
        self.register_buffer("G", torch.from_numpy(np.ascontiguousarray(G)))
        if n <= SMEM_MAX_N:
            Gk = G[digit_order(n)].reshape(n // RADIX, RADIX).T
            self.register_buffer("Gk",
                                 torch.from_numpy(np.ascontiguousarray(Gk)))
        tw = np.exp(-2j * np.pi * np.arange(n, dtype=np.float64) / n)
        self.register_buffer("tw", torch.from_numpy(tw))

    def mode(self, head: int) -> str:
        return "poly" if self.poly else ("frames" if head == 0 else "framed")


def _check(u, plan, n_frames, head):
    if u.dim() != 2 or u.dtype != torch.float32:
        raise TypeError(f"u must be a float32 [C, L] tensor, got {u.dtype} "
                        f"{tuple(u.shape)}")
    if not isinstance(plan, DfFFTPlan):
        raise TypeError("plan must be a DfFFTPlan")
    if not 0 <= head < plan.n or n_frames < 1:
        raise ValueError(f"need 0 <= head < n={plan.n} and n_frames >= 1, "
                         f"got head={head}, n_frames={n_frames}")


def df_fft_conv_ref(u: torch.Tensor, plan: DfFFTPlan, n_frames: int,
                    head: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``df_fft_conv``, on any device: the frames
    as reshape views of the zero-padded signal, one real frame per
    complex128 ``torch.fft`` transform, the product by ``plan.G``, the
    unscaled inverse, rounded to float32."""
    _check(u, plan, n_frames, head)
    n = plan.n
    hop = n - head
    need = (n_frames - 1) * hop + n
    up = F.pad(u, (0, need - u.shape[1])) if u.shape[1] < need \
        else u[:, :need]
    X = torch.fft.fft(_frames(up.double(), n_frames, hop, n))
    w = torch.fft.ifft(X * plan.G.to(X.device), norm="forward")[..., head:]
    C = u.shape[0]
    if plan.poly:
        return torch.stack([w.real, w.imag], dim=-1).reshape(C, -1).float()
    return w.real.reshape(C, -1).float()


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p]


def _lib():
    lib = _cuda.load("df_fft_conv")
    lib.r8b_df_fft_conv.argtypes = _ARGTYPES
    lib.r8b_df_fft_conv.restype = ctypes.c_int
    return lib


@spanned("r8b.kernel.df_fft_conv")
def df_fft_conv(u: torch.Tensor, plan: DfFFTPlan, n_frames: int,
                head: int = 0) -> torch.Tensor:
    """w [C, n_frames*hop] float32 (``[C, 2*n_frames*hop]`` interleaved in
    polyphase mode), hop = plan.n - head: the valid tail of frame f of row
    c, ``u[c, f*hop : f*hop + n]`` (zeros past u's end), circularly
    convolved with the plan's kernel.

    u: [C, L] float32 with unit stride along time (any row stride).  On a
    CUDA tensor this launches the kernel or raises; on a CPU tensor it is
    ``df_fft_conv_ref``.  It has no gradient: an input that autograd or
    torch.func tracks raises (``_cuda.no_gradient``).  Every kernel
    launched adds one to ``df_fft_conv.launches`` and to
    ``df_fft_conv.launches_by[(mode, n)]``, mode "frames" (head 0),
    "framed" or "poly": one launch a call
    for n <= SMEM_MAX_N; above, three (the four-step's passes) for each
    chunk of transforms that fits the scratch."""
    _check(u, plan, n_frames, head)
    _cuda.no_gradient("df_fft_conv", u)
    if u.device.type == "cpu":
        return df_fft_conv_ref(u, plan, n_frames, head)
    if u.device.type != "cuda":
        raise RuntimeError(f"df_fft_conv runs on cuda or cpu, not {u.device}")
    if plan.G.device != u.device:
        raise ValueError(f"the plan lies on {plan.G.device}, u on {u.device}")
    if u.stride(1) != 1 and u.shape[1] > 1:
        raise ValueError("u must have unit stride along time")
    n, C = plan.n, u.shape[0]
    hop = n - head
    out = torch.empty((C, (2 if plan.poly else 1) * n_frames * hop),
                      dtype=torch.float32, device=u.device)
    if C == 0:
        return out
    f_total = C * n_frames
    n_tr = f_total if plan.poly else -(-f_total // 2)
    chunk, scratch = n_tr, None
    if n > SMEM_MAX_N:
        chunk = max(1, min(n_tr, 65535, SCRATCH_BYTES // (16 * n)))
        scratch = torch.empty((chunk, n), dtype=torch.complex128,
                              device=u.device)
    G = plan.Gk if n <= SMEM_MAX_N else plan.G
    lib = _lib()
    per_chunk, key = (1 if n <= SMEM_MAX_N else 3), (plan.mode(head), n)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        for g0 in range(0, n_tr, chunk):
            rc = lib.r8b_df_fft_conv(
                u.data_ptr(), u.stride(0), u.shape[1], G.data_ptr(),
                plan.tw.data_ptr(), out.data_ptr(), C, n_frames, n, head,
                int(plan.poly), g0, min(chunk, n_tr - g0),
                None if scratch is None else scratch.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"df_fft_conv kernel launch failed: CUDA "
                                   f"error {rc}")
            df_fft_conv.launches += per_chunk
            df_fft_conv.launches_by[key] += per_chunk
    return out


df_fft_conv.launches = 0
df_fft_conv.launches_by = Counter()
