"""Dense float32 GEMM for the scouting tools: the hand-written CUDA kernel
and its plain PyTorch version.

    C[m, n] = sum_k A[m, k] * B[k, n]

Counterpart of the reference package's TPU scouting GEMMs
(``tools/exp_pallas_gemm.py`` ``pallas_gemm`` and
``tools/exp_framed_kernel.py`` ``make_gemm``): M tiles of 512 or 176 rows,
and the variant that sums K in ``hop``-row segments.  No stage executor
calls it; ``chip_smoke.py`` and ``tools/torch_exp_framed_kernel.py`` time
it.  ``dense_gemm`` launches
``csrc/dense_gemm.cu`` on a CUDA tensor and runs ``dense_gemm_ref`` on a
CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

__all__ = ["M_TILES", "dense_gemm", "dense_gemm_ref"]

#: The kernel's M tiles (the reference tools' 512 and 176 rows).
M_TILES = (512, 176)
#: Segment lengths must be whole multiples of the kernel's K slab.
SEG_QUANTUM = 16


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


def dense_gemm_ref(A: torch.Tensor, B: torch.Tensor, mt: int = 512,
                   hop: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``dense_gemm``: the float64 product (the
    tile and the segmentation change only the rounding), as float64."""
    _check(A, B, mt, hop)
    return torch.matmul(A.double(), B.double())


def dense_gemm(A: torch.Tensor, B: torch.Tensor, mt: int = 512,
               hop: Optional[int] = None) -> torch.Tensor:
    """C = A @ B in float32, [M, K] x [K, N] -> [M, N].

    mt: the M tile, 512 or 176; hop: None for one K loop, else the segment
    length (a multiple of 16).  On a CUDA tensor this launches the kernel
    (counted in ``dense_gemm.launches``) or raises; on a CPU tensor it is
    ``dense_gemm_ref`` rounded to float32."""
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
    fn = _cuda.load("dense_gemm").r8b_dense_gemm_f32
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), B.data_ptr(), C.data_ptr(), M, K, N, mt,
                hop or 0, stream)
    if rc != 0:
        raise RuntimeError(f"dense_gemm kernel launch failed: CUDA error {rc}")
    dense_gemm.launches += 1
    return C


dense_gemm.launches = 0
