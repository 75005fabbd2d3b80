"""Error-free split-operand (Ozaki-style) framed matmul: the operand split,
the per-channel scale, and the plain composition.

Counterpart of the reference package's ``ops/ozaki.py``.  The guarantee
engine's idea, unchanged:

* Each operand is normalized by a POWER OF TWO (the input per channel,
  the operator per output column) and split into ``N_PARTS`` = 4 slices
  of 8 mantissa bits: every slice value is an integer multiple of
  2^(e - 8(p+1)) with |integer| <= 2^8, hence exact in bfloat16.
* A slice-pair product is an integer < 2^16 on a common grid; a dot of
  ``K0`` <= 256 of them stays below 2^24, so every float32 accumulation
  of it, in any order, is exact.  Longer contractions are chunked, the
  d = p+q = 0 chunk results folded with ``two_sum`` and the d >= 1 ones
  summed in plain float32 (they are 2^-8d of the output).
* Pairs with d < ``N_DIAG`` = 4 are kept: 10 bfloat16 products per chunk.

``framed_matmul_ozaki`` is the plain composition of the reference's XLA
path (segment, then ``K0``-chunk); the kernel module
(``ops/pallas_ozaki.py``) computes the same function in the kernel's own
chunk order.  Everything here runs in float32 from bfloat16 operands
upcast: bf16 x bf16 products are exact in float32 (and in TF32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .dfloat import two_sum

__all__ = ["N_PARTS", "N_DIAG", "K0", "split_operator_host",
           "split_operator_batched", "channel_scale", "split_input",
           "framed_cheap", "framed_matmul_ozaki"]

N_PARTS = 4   # 8-bit slices per operand (32 bits below the block peak)
N_DIAG = 4    # kept diagonals d = p+q in [0, N_DIAG)
K0 = 256      # longest exactly-accumulated chunk of 16-bit products


def _pow2_ceil_scale(amax: np.ndarray) -> np.ndarray:
    """Smallest power of two >= amax (1.0 where amax == 0)."""
    e = np.where(amax > 0,
                 np.ceil(np.log2(np.maximum(amax, 1e-300))), 0.0)
    return np.exp2(e)


def split_operator_host(T64: np.ndarray):
    """Split a [L_f, Kcols] float64 operator into ``N_PARTS`` bfloat16
    slices on a per-COLUMN power-of-two grid, the column scale folded back
    into the slices (an exponent shift: bf16 exactness and the per-column
    common grid both survive).  Returns (parts [N_PARTS, L_f, Kcols]
    torch.bfloat16, scale [Kcols] float32 numpy, for diagnostics)."""
    T64 = np.asarray(T64, dtype=np.float64)
    amax = np.abs(T64).max(axis=0)
    s = _pow2_ceil_scale(amax)
    r = T64 / s[None, :]
    parts = []
    for p in range(N_PARTS):
        step = 2.0 ** (-8 * (p + 1))
        q = np.round(r / step) * step
        parts.append(q * s[None, :])
        r = r - q
    parts = np.stack(parts)
    pb = torch.from_numpy(parts).to(torch.bfloat16)
    assert np.array_equal(pb.double().numpy(), parts), \
        "operator slice not bf16-exact"
    return pb, s.astype(np.float32)


def split_operator_batched(T64: torch.Tensor, axis: int = 1,
                           check: bool = False) -> torch.Tensor:
    """Split a batched float64 operator (``[nloc, W, G]``, or the filter
    values ``[..., G, fl]`` with ``axis=-1``) into ``N_PARTS`` bfloat16
    slices on a per-column power-of-two grid (the max over the contraction
    axis ``axis``), the scales folded in, where the tensor lies.  Returns
    [N_PARTS, *T64.shape] torch.bfloat16.  Every step is exact (a division
    by a power of two, a round to the slice grid, a difference), so the
    CPU and the card give the same slices, those of the reference's
    ``split_operator_host_batched``.  The banded polynomial interpolator's
    guarantee path (``stages.banded_contract_ozaki``) uses it: the
    exactness lemma holds per (channel, m, g) output cell, provided every
    slice is bfloat16-exact (a slice pushed subnormal by a tiny column
    max would round); ``check`` asserts that, at the cost of reading the
    result back."""
    T64 = T64.double()
    amax = T64.abs().amax(dim=axis, keepdim=True)
    # the smallest power of two >= amax (1.0 where amax == 0), exactly
    m, e = torch.frexp(amax)
    s = torch.ldexp(torch.ones_like(amax), e - (m == 0.5).to(e.dtype))
    s = torch.where(amax > 0, s, torch.ones_like(amax))
    r = T64 / s
    parts = []
    for p in range(N_PARTS):
        step = 2.0 ** (-8 * (p + 1))
        q = torch.round(r / step) * step
        parts.append(q * s)
        r = r - q
    parts = torch.stack(parts)
    pb = parts.to(torch.bfloat16)
    if check:
        assert torch.equal(pb.double(), parts), \
            "operator slice not bf16-exact"
    return pb


def channel_scale(x: torch.Tensor) -> torch.Tensor:
    """[C, 1] float32 power of two >= the per-channel max |x| (1.0 for
    silent rows), by the reference's formula exp2(ceil(log2(amax))) in
    float32.  Just above a power of two, log2 may round down to the
    integer, giving s = amax / (1 + 2^-23): the leading slice is then 256
    units and exactness still holds (ROADMAP.md section 3)."""
    amax = x.float().abs().amax(dim=1, keepdim=True)
    e = torch.where(amax > 0, torch.ceil(torch.log2(amax)),
                    torch.zeros((), dtype=torch.float32, device=x.device))
    return torch.exp2(e)


def split_input(x: torch.Tensor):
    """Split [C, N] input on a per-CHANNEL power-of-two grid.  Returns
    (parts [N_PARTS, C, N] bfloat16, scale [C, 1] float32).  Every step is
    exact: the scale is a power of two and each slice an integer multiple
    of its grid step with <= 8 significant bits."""
    x = x.float()
    s = channel_scale(x)
    r = x / s
    parts = []
    for p in range(N_PARTS):
        step = 2.0 ** (-8 * (p + 1))
        q = torch.round(r / step) * step
        parts.append(q.to(torch.bfloat16))
        r = r - q
    return torch.stack(parts), s


def _bf16_dot(seg: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """cbl,lk->cbk of bfloat16 operands, products and sums in float32."""
    return torch.matmul(seg.float(), T.float())


def framed_cheap(x_lo: torch.Tensor, T0: torch.Tensor, n_blocks: int,
                 hop: int) -> torch.Tensor:
    """One bfloat16 pass of a seam-residual stream against the TOP
    operator slice, [C, n_blocks, Kcols] float32: the residual needs about
    8 relative bits (error ~2^-32 of the main output).  Same segmented
    reshape-view framing as ``framed_matmul_ozaki``."""
    C = x_lo.shape[0]
    L_f = T0.shape[0]
    n_seg = -(-L_f // hop)
    total = (n_blocks + n_seg) * hop
    pad = total - x_lo.shape[1]
    xl = F.pad(x_lo, (0, pad)) if pad > 0 else x_lo[:, :total]
    ch = xl.to(torch.bfloat16).reshape(C, n_blocks + n_seg, hop)
    out = None
    for e in range(n_seg):
        w = min(hop, L_f - e * hop)
        o = _bf16_dot(ch[:, e : n_blocks + e, :w], T0[e * hop : e * hop + w])
        out = o if out is None else out + o
    return out


def framed_matmul_ozaki(xp: torch.Tensor, T_parts: torch.Tensor,
                        n_blocks: int, hop: int, x_lo=None,
                        pair: bool = False):
    """out[c, b, k] = sum_l xp[c, b*hop + l] * T[l, k] in the split form,
    [C, n_blocks, Kcols] float32, ~2^-30 relative accuracy on any backend.

    The reference's XLA composition, kept as the tests' second reference:
    each hop-wide segment in ``K0``-deep chunks.  ``x_lo`` (the previous
    seam's residual, consumed as bfloat16 with one pass against slice 0)
    and ``pair`` (return the two_sum-normalized (hi float32, lo bfloat16)
    instead of collapsing) compose freely, as in the reference."""
    C = xp.shape[0]
    L_f = T_parts.shape[1]
    n_seg = -(-L_f // hop)
    total = (n_blocks + n_seg) * hop

    def _padto(a):
        p = total - a.shape[1]
        return F.pad(a, (0, p)) if p > 0 else a[:, :total]

    xparts, x_scale = split_input(_padto(xp.float()))
    xparts = [xparts[p].reshape(C, n_blocks + n_seg, hop)
              for p in range(N_PARTS)]
    xl_chunks = None
    if x_lo is not None:
        xl_chunks = _padto(x_lo).to(torch.bfloat16).reshape(
            C, n_blocks + n_seg, hop)

    hi = lo = rest = cheap = None
    for e in range(n_seg):
        w = min(hop, L_f - e * hop)
        for c0 in range(0, w, K0):
            a0 = e * hop + c0
            a1 = min(e * hop + w, a0 + K0)
            diags = [None] * N_DIAG
            for p in range(N_PARTS):
                for q in range(N_DIAG - p):
                    seg = xparts[p][:, e : n_blocks + e,
                                    a0 - e * hop : a1 - e * hop]
                    o = _bf16_dot(seg, T_parts[q, a0:a1])
                    d = p + q
                    diags[d] = o if diags[d] is None else diags[d] + o
            if hi is None:
                hi, lo = diags[0], torch.zeros_like(diags[0])
            else:
                s, err = two_sum(hi, diags[0])
                hi, lo = s, lo + err
            small = diags[1] + diags[2] + diags[3]
            rest = small if rest is None else rest + small
            if xl_chunks is not None:
                seg = xl_chunks[:, e : n_blocks + e,
                                a0 - e * hop : a1 - e * hop]
                o = _bf16_dot(seg, T_parts[0, a0:a1])
                cheap = o if cheap is None else cheap + o
    small_all = lo + rest
    sx = x_scale[:, None, :]
    if x_lo is None and not pair:
        return (hi + small_all) * sx
    y_hi = hi * sx
    y_small = small_all * sx
    if cheap is not None:
        y_small = y_small + cheap
    if not pair:
        return y_hi + y_small
    H, L = two_sum(y_hi, y_small)
    return H, L.to(torch.bfloat16)

