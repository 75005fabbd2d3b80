"""Dense float32 GEMM for the scouting tools: the hand-written CUDA kernel
and its plain PyTorch version.

    C[m, n] = sum_k A[m, k] * B[k, n]

Counterpart of the reference package's TPU scouting GEMMs
(``tools/exp_pallas_gemm.py`` ``pallas_gemm`` and
``tools/exp_framed_kernel.py`` ``make_gemm``): a float32 dot at
``Precision.HIGHEST`` (M tiles of 512 or 176 rows there), and the variant
that sums K in ``hop``-row segments.  No stage executor calls it;
``chip_smoke.py`` and ``tools/torch_exp_framed_kernel.py`` time it.
``dense_gemm`` launches ``csrc/dense_gemm.cu`` on a CUDA tensor and runs
``dense_gemm_ref`` on a CPU tensor.

The kernel computes what the TPU's HIGHEST dot computes, on the tensor
cores: A and B split exactly into three bfloat16 slices each (``split3``),
the 6 slice products with p+q <= 2 summed in float32, each ``FOLD``
k-values (or each segment) in a fresh accumulator added into the total in
float32.  B is split and packed for it once per call (``pack_b``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda
from .pallas_frac import TILE_K, _pack, split3

__all__ = ["M_TILES", "FOLD", "PACK_N", "pack_b", "dense_gemm",
           "dense_gemm_ref"]

#: The reference tools' M tiles (512 and 176 rows); accepted and checked,
#: they do not change the kernel's tile or its result.
M_TILES = (512, 176)
#: Segment lengths must be whole multiples of the tensor cores' k16 step.
SEG_QUANTUM = 16
#: k-values a fresh accumulator of the kernel sums in one K loop.
FOLD = 64
#: Columns of a tile of the packed B (and of the kernel's tile of C).
PACK_N = 128


def _check(A, B, mt, hop):
    if mt not in M_TILES:
        raise ValueError(f"mt must be one of {M_TILES}, got {mt}")
    if hop is not None and (hop < SEG_QUANTUM or hop % SEG_QUANTUM):
        raise ValueError(f"hop must be a positive multiple of {SEG_QUANTUM}, "
                         f"got {hop}")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[0] \
            or B.shape[0] < 1 or B.shape[1] < 1:
        raise ValueError(f"need A [M, K] and B [K, N] with K, N >= 1, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError(f"A and B must be float32, got {A.dtype} and "
                        f"{B.dtype}")


def pack_b(B: torch.Tensor) -> torch.Tensor:
    """B [K, N] float32 in the form the kernel reads it: its three bfloat16
    slices (``split3``), zero-padded to whole tiles (``TILE_K`` rows of K,
    ``PACK_N`` columns of N) and packed as bfloat16 [n_col_tiles,
    n_k_tiles, 3, PACK_N, TILE_K], K-major, each [PACK_N, TILE_K] tile
    128-byte swizzled: one contiguous block a (column tile, k-tile)."""
    if B.dim() != 2 or B.dtype != torch.float32:
        raise TypeError(f"B must be a float32 [K, N] matrix, got {B.dtype} "
                        f"{tuple(B.shape)}")
    return _pack(torch.stack(split3(B)), PACK_N)


def _check_packed(packed: torch.Tensor, K: int, N: int) -> None:
    want = (-(-N // PACK_N), -(-K // TILE_K), 3, PACK_N, TILE_K)
    if packed.dtype != torch.bfloat16 or tuple(packed.shape) != want:
        raise ValueError(f"the packed B must be pack_b of a [K={K}, N={N}] "
                         f"matrix: bfloat16 {list(want)}, got {packed.dtype} "
                         f"{list(packed.shape)} (another tiling)")


def dense_gemm_ref(A: torch.Tensor, B: torch.Tensor, mt: int = 512,
                   hop: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``dense_gemm``: the float64 product (the
    tile and the segmentation change only the rounding), as float64."""
    _check(A, B, mt, hop)
    return torch.matmul(A.double(), B.double())


def dense_gemm(A: torch.Tensor, B: torch.Tensor, mt: int = 512,
               hop: Optional[int] = None) -> torch.Tensor:
    """C = A @ B in float32, [M, K] x [K, N] -> [M, N].

    mt: the reference's M tile, 512 or 176 (checked; the result does not
    depend on it); hop: None for one K loop, else the segment length (a
    multiple of 16).  On a CUDA tensor this packs B (``pack_b``) and
    launches the kernel (counted in ``dense_gemm.launches``) or raises; A
    is copied first, zero-padded to a multiple of 4 columns, where K is no
    multiple of 4 or A's start is not 16-byte aligned (the TMA copies need
    both).  On a CPU tensor it is ``dense_gemm_ref`` rounded to float32."""
    _check(A, B, mt, hop)
    if A.device.type == "cpu":
        return dense_gemm_ref(A, B, mt, hop).float()
    if A.device.type != "cuda":
        raise RuntimeError(f"dense_gemm runs on cuda or cpu, not {A.device}")
    if B.device != A.device or not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("A and B must be contiguous on one device")
    M, K = A.shape
    N = B.shape[1]
    C = torch.empty((M, N), dtype=torch.float32, device=A.device)
    if M == 0:
        return C
    packed = pack_b(B)
    _check_packed(packed, K, N)
    if K % 4:
        A = F.pad(A, (0, -K % 4))
    elif A.data_ptr() % 16:
        A = A.clone()
    fn = _cuda.load("dense_gemm").r8b_dense_gemm_f32
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), packed.data_ptr(), C.data_ptr(), M, A.shape[1],
                N, hop or FOLD, stream)
    if rc != 0:
        raise RuntimeError(f"dense_gemm kernel launch failed: CUDA error {rc}")
    dense_gemm.launches += 1
    return C


dense_gemm.launches = 0
