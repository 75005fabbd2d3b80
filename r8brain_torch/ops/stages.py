"""Framing helpers shared by the executors.

Counterparts of the reference package's ``ops/stages.py`` helpers that the
fused chain needs: overlapping frames as reshape views, the plain framed
contraction, and the residual-operator truncation.  The stage executors
themselves (convolver, half-band, interpolator engines) are later slices
of the port (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["_frames", "_framed_matmul", "truncate_residual"]


def _frames(xp: torch.Tensor, n_blocks: int, hop: int, L_f: int
            ) -> torch.Tensor:
    """Overlapping frames [C, n_blocks, L_f] at stride ``hop`` via chunked
    reshape+concat (no gather, no conv).  For L_f <= hop the result is a
    view of (a padded copy of) ``xp``."""
    C = xp.shape[0]
    n_seg = -(-L_f // hop)  # segments of length hop covering L_f
    total = (n_blocks + n_seg) * hop
    pad = total - xp.shape[1]
    if pad > 0:
        xp = F.pad(xp, (0, pad))
    else:
        xp = xp[:, :total]
    chunks = xp.reshape(C, n_blocks + n_seg, hop)
    segs = [chunks[:, e : n_blocks + e, :] for e in range(n_seg)]
    if n_seg == 1:
        return segs[0][:, :, :L_f]
    return torch.cat(segs, dim=-1)[:, :, :L_f]


def _framed_matmul(xp: torch.Tensor, T: torch.Tensor, n_blocks: int,
                   hop: int) -> torch.Tensor:
    """out[c, b, k] = sum_l frames[c, b, l] * T[l, k] with
    frames[c, b, l] = xp[c, b*hop + l], WITHOUT materializing the
    overlapping frames: einsum(concat(segs), T) == sum_e einsum(seg_e,
    T_rows_e), and each segment is a pure reshape view of xp.

    This is the plain contraction in the working dtype (the float64
    reference path).  The float32 path runs through the kernel module
    (ops/pallas_frac.py), whose plain model fixes the accumulation order."""
    C = xp.shape[0]
    L_f = T.shape[0]
    n_seg = -(-L_f // hop)
    total = (n_blocks + n_seg) * hop
    pad = total - xp.shape[1]
    if pad > 0:
        xpp = F.pad(xp, (0, pad))
    else:
        xpp = xp[:, :total]
    chunks = xpp.reshape(C, n_blocks + n_seg, hop)
    out = None
    for e in range(n_seg):
        w = min(hop, L_f - e * hop)
        seg = chunks[:, e : n_blocks + e, :w]
        o = torch.matmul(seg, T[e * hop : e * hop + w])
        out = o if out is None else out + o
    return out


def truncate_residual(Tlo: np.ndarray, scale: float):
    """(row_offset, contiguous significant rows) of a residual operator:
    rows with max|Tlo| <= scale * 2^-31 contribute below the f32 output
    noise floor.  The bound is linear (worst-case), not statistical: the
    dropped rows' summed L1 mass relative to the main operator measures
    -186 dB for the flagship fused operator (audited in the reference
    package's tests/test_r2_fixes.py), 40+ dB under the -141 dB class."""
    rn = np.abs(Tlo).max(axis=1)
    idx = np.nonzero(rn > scale * 2.0**-31)[0]
    if idx.size == 0:
        return 0, Tlo[:0]
    r0, r1 = int(idx.min()), int(idx.max()) + 1
    return r0, np.ascontiguousarray(Tlo[r0:r1])
