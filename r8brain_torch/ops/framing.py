"""A signal framed at an offset, overlapping frames of a [C, N] signal as
reshape views, and the plain framed contraction over them.

Counterparts of the reference package's ``ops/stages.py`` helpers
``_frames`` and ``_framed_matmul``.  A leaf module: the kernel modules and
the stage executors both build on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["shifted", "shifted_bytes", "_frames", "_framed_matmul"]


def shifted(x: torch.Tensor, start: int, need: int, dtype) -> torch.Tensor:
    """[C, >= need] tensor of ``dtype`` whose column 0 is x's column
    ``start`` (zeros outside x): one padded copy, or a view of x when x
    already covers [start, start + need)."""
    pad_l = max(0, -start)
    pad_r = max(0, need + start - x.shape[1])
    x = x.to(dtype)
    if pad_l or pad_r:
        x = F.pad(x, (pad_l, pad_r))
    return x[:, start + pad_l :]


def shifted_bytes(x: torch.Tensor, start: int, need: int, dtype) -> int:
    """The bytes ``shifted(x, start, need, dtype)`` writes, from host
    integers: its cast and its padded copy, each where it makes one; 0
    where it returns a view of x."""
    C, N = x.shape
    pad = max(0, -start) + max(0, need + start - N)
    size = dtype.itemsize
    cast = C * N * size if x.dtype != dtype else 0
    return cast + (C * (N + pad) * size if pad else 0)


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
