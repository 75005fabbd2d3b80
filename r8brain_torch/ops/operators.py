"""The banded operators of the stage executors, each with its one call.

Every framed stage is the same product: a banded operator T [L_f, Kcols]
applied to windows of the input at stride ``hop``, window 0 at column
``start`` of x,

    y[c, b*Kcols + k] = x[c, start + b*hop : start + b*hop + L_f] . T[:, k],

b < n_blocks.  The executors keep the geometry (start, hop, n_blocks and
the framed length ``need``, the length of a framing copy where one is
made) and their seam protocols; this module owns the rest, built once from the
float64 operator T:

* ``FramedOperator``, T on ``frac_whole`` (ops/pallas_frac.py): T in the
  stage's dtype with the optional float32 residual each executor builds,
  packed (``operator_parts``), its nonzero band and the fold width ``kc``;
  on the card each call hands the kernel the signal as it lies and the
  window origin (the ``frame.direct`` counter), and elsewhere, or where
  the signal needs a cast, frames a copy in the stage's dtype first (the
  ``r8b.frame`` span; its bytes, the ``frame.bytes`` counter);
* ``OzakiOperator``, T on ``ozaki_framed`` (ops/pallas_ozaki.py): its
  error-free split form (``split_operator_host``) and the kernel's packing
  (``pack_operator``); each call frames the signal to float32 with its
  per-channel scales (the ``r8b.ozaki.prep`` span) and the seam residual
  in its own dtype (``r8b.ozaki.carry``).

Callers use ``op.apply(...)``, not ``op(...)``: a module's ``__call__``
costs host time on every call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.trace import count, span
from .framing import shifted, shifted_bytes
from .ozaki import channel_scale, split_operator_host
from .pallas_frac import KC, frac_whole, operator_band, operator_parts
from .pallas_ozaki import ozaki_framed, pack_operator

__all__ = ["FramedOperator", "OzakiOperator"]


class FramedOperator(nn.Module):
    """A banded operator on ``frac_whole``.

    ``hi``: T [L_f, Kcols] in the stage's dtype; ``lo``: the float32
    residual the executor gives (None under "fast" and in float64);
    ``parts``: both as ``frac_whole`` takes them; ``band``: the nonzero
    band of ``parts`` (None in float64); ``kc``: the terms a float32
    big-pair partial sums before its fold."""

    def __init__(self, T: np.ndarray, dtype,
                 lo: Optional[np.ndarray] = None, kc: int = KC):
        super().__init__()
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        self.register_buffer("hi", torch.from_numpy(
            np.ascontiguousarray(T.astype(np_dt))))
        self.register_buffer("lo", None if lo is None else
                             torch.from_numpy(np.ascontiguousarray(lo)))
        self.register_buffer("parts", operator_parts(self.hi, self.lo))
        self.band = operator_band(self.parts)
        self.dtype, self.kc = self.hi.dtype, kc
        self.L_f, self.Kcols = T.shape

    def apply(self, x: torch.Tensor, start: int, need: int, hop: int,
              n_blocks: int) -> torch.Tensor:
        """Every block's columns [C, n_blocks*Kcols] of x framed from
        column ``start`` over ``need`` samples (zeros outside x).  On the
        card, in the stage's dtype, the kernel reads x where it lies (a
        call counted as ``frame.direct``); else x is framed first, the
        copy inside the ``r8b.frame`` span, its bytes counted as
        ``frame.bytes``."""
        if _reads_in_place(x, self.dtype):
            count("frame.direct")
            return frac_whole(x, self.parts, hop, self.L_f, self.Kcols,
                              n_blocks, kc=self.kc, band=self.band,
                              start=start)
        with span("r8b.frame"):
            xp = shifted(x, start, need, self.dtype)
        count("frame.bytes", shifted_bytes(x, start, need, self.dtype))
        return frac_whole(xp, self.parts, hop, self.L_f, self.Kcols,
                          n_blocks, kc=self.kc, band=self.band)


def _reads_in_place(x: torch.Tensor, dtype) -> bool:
    """Whether ``frac_whole`` reads x in place: on the card, in the
    operator's dtype, unit stride along time.  The CPU's plain model frames
    a copy, as a cast does."""
    return x.device.type == "cuda" and x.dtype == dtype and x.stride(1) == 1


class OzakiOperator(nn.Module):
    """A banded operator on ``ozaki_framed``: ``parts``, the slices of
    ``split_operator_host`` [4, L_f, Kcols] (the plain version's), with
    their ``scale``, and ``tiles`` and ``bands``, their packing for the
    kernel."""

    def __init__(self, T: np.ndarray):
        super().__init__()
        parts, self.scale = split_operator_host(T)
        self.register_buffer("parts", parts)
        tiles, bands = pack_operator(parts)
        self.register_buffer("tiles", tiles)
        self.register_buffer("bands", bands)
        self.L_f, self.Kcols = T.shape

    def apply(self, x: torch.Tensor, start: int, need: int, hop: int,
              n_blocks: int, x_lo: Optional[torch.Tensor] = None,
              pair: bool = False):
        """Every block's columns [C, n_blocks*Kcols] (the (hi, lo) pair
        when ``pair``) of x framed from column ``start`` over ``need``
        samples in float32, with the seam residual ``x_lo`` framed alike
        in its own dtype."""
        with span("r8b.ozaki.prep"):
            xp = shifted(x, start, need, torch.float32)
            sx = channel_scale(xp[:, : (n_blocks - 1) * hop + self.L_f])
        xl = None
        if x_lo is not None:
            with span("r8b.ozaki.carry"):
                xl = shifted(x_lo, start, need, x_lo.dtype)
        return ozaki_framed(xp, sx, self.parts, self.L_f, hop, self.Kcols,
                            n_blocks, x_lo=xl, emit_pair=pair,
                            packed=(self.tiles, self.bands))
