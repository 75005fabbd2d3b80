"""Framed matmul of the fused chain: the hand-written CUDA kernel and its
plain PyTorch version.

    y[c, m*O + j] = sum_{d<D} x[c, start + m*I + d] * skT[d, j]
                  (+ sum_{d<D} x[c, start + m*I + d] * skT_lo[d, j])

with x zero outside [0, N): the kernel reads x where it lies, from a
signed window origin ``start``.

Counterpart of the reference package's ``ops/pallas_frac.py``
(``frac_whole_pallas``): the same function, with the optional residual dot
against the f64->f32 operator residual that ``precision="high"`` passes.

``frac_whole`` launches ``csrc/frac_whole.cu`` on a CUDA tensor and runs
``frac_whole_ref`` on a CPU tensor.  Both take the operator as
``operator_parts(skT, skT_lo)`` and, in float32, its nonzero band
``operator_band(parts)``, which ``ops/operators.py`` builds once for
each executor.  In float32 both compute the three-slice bfloat16 split
that the kernel runs on the tensor cores, with its lead slices on fixed
grids:

* the big pair x0*s0 sums in ``kc``-term folds (``KC`` = 32, or ``KC_LO``
  = 16 where the caller asks), each starting at a multiple of kc from d =
  0; each window row's values over a fold are split by ``split_grid``:
  x0 rounded to nearest on one grid 2^(E-8), 2^E above the row's largest
  |x| in the fold (at I = 1 on the 8-column tile, the direct stage's, one
  grid for each 16 windows, as the kernel splits each sample once for
  all its rows), and the float32 remainder (exact) split into x1, x2 by
  the floating rule; the operator comes split the same way, its lead
  slice on one grid for each column and 32-row group of D (so a fold of
  16 or of 32 terms lies in one group), and under "high" with one more
  slice, bf16(skT_lo);
* x0 = k 2^(E-8) and s0 = m 2^(F-8) with |k|, |m| <= 256, so a fold's
  products lie on one grid and sum to under 2^21 of its units: every fold
  sum is exact in float32 (the tensor cores, which truncate an inexact
  sum toward zero, have nothing to truncate), and each is folded into a
  (hi, lo) pair with ``two_sum``;
* the five small pairs with p+q <= 2 (and x0*bf16(skT_lo)) sum into lo,
  which once a 64-row k-tile moves into hi (Fast2Sum): the tensor cores
  truncate each small-pair sum they add into lo, and a lo kept within an
  ulp of hi keeps that truncation from biasing y; y = hi + lo, rounded
  once.

For each column tile both walk only the folds that meet the tile's band
(the k16 steps of D where some slice of the operator has a nonzero entry
in the tile's columns; the 8-column tile of O <= 2 walks all of D): every
other fold would add exact zeros, and the Fast2Sums of the k-tiles past
the band keep hi + lo exactly, so y is the full walk's bit for bit (for
finite x).

Every slice product is exact in float32; the dropped pairs (x1*s2, x2*s1,
x2*s2) are below 2^-26 of each product.  The grids trade an exact input
for exact fold sums: split3's floating slices hold every float32 x
exactly, but x0 + x1 + x2 here is only within 2^(E-27) of x (x1 and x2
hold the 16 bits below 2^(E-9), so a value far below its row's largest
loses its last bits), rounded to nearest: the error has no sign of its
own.  The JAX kernel's f32-HIGHEST dot reads its input exactly.  On
the flagship operator the model reads about -150 dB re full scale, where
float32 products summed in 32-term chunks folded with two_sum read -144.5
and a single running float32 sum over D = 1027 terms about -132.

The function is linear in x, and ``frac_whole`` is differentiable in it
(torch.autograd and torch.func): its gradient is ``frac_whole`` itself on
the adjoint geometry (``adjoint_geometry``) against the float32 operator
re-blocked and split anew on the adjoint's own grids (``adjoint_parts``,
built once per operator), so on the card the backward launches the
kernel too, with the same exact fold sums.

On the card the kernel stages each window row with 16-byte copies where
the window origin, x's row stride and I allow, else with 8-byte copies on
rows that start 8-byte aligned (``copy_width``).  Where the origin itself
is off that alignment, the launch gives the operator s < 4 leading zero
rows and reads from start - s (``lead_rows``): the same products, the
origin aligned.  That operator is split anew on its own grids
(``_lead_operator``, built once per operator and s), so its fold sums are
exact too, but they group D's rows otherwise: on the card the output's
bits follow x's address mod 16 bytes (a view at another storage offset, a
stream's window), within the kernel's tolerance of its plain model.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakTensorKeyDictionary

from ..utils.trace import count, spanned
from . import _cuda
from .dfloat import two_sum
from .framing import _framed_matmul, shifted

__all__ = ["KC", "KC_LO", "TILE_K", "K_STEP", "split3", "split_grid",
           "operator_parts", "OperatorBand", "operator_band", "unpack_parts",
           "adjoint_geometry", "adjoint_parts", "copy_width", "lead_rows",
           "frac_whole", "frac_whole_ref"]

#: Terms per partial sum of the big pair before the two_sum fold (two k16
#: tensor-core steps), and the rows of D that share one grid of the
#: operator's lead slice.
KC = 32
#: The short fold (one k16 step) the stage interpolator and the "high"
#: direct stage ask for: a whole-stepping interpolator's ~24 nonzero taps a
#: column would otherwise share one partial (split model, 44.1k -> 96k frac
#: stage with skT_lo: -150.44 dB re full scale against -148.94 at 32 terms;
#: tests/test_torch_fft_chain.py holds the chain).
KC_LO = 16
#: Rows of D a k-tile of the packed operator holds (one 128-byte swizzle
#: row of bfloat16).
TILE_K = 64
#: Rows of D one tensor-core step (wgmma k16) takes: the unit of a band.
K_STEP = 16
#: Output rows a block of the float32 kernel computes; the 8-column tile
#: tiles each channel's rows apart up to this stride (the kernel's
#: MAX_STRETCH_I).
_BLOCK_M = 128
_MAX_STRETCH_I = 64


def _tile_n(O: int) -> int:
    """Output columns a tile of the packed operator (and of the kernel)
    holds: 8 for O <= 2 (the direct stage of a 2x conversion; its slices
    then also lie side by side in one tile), 128 where that pads O no
    further than 64 would, else 64."""
    if O <= 2:
        return 8
    return 128 if -(-O // 128) * 128 == -(-O // 64) * 64 else 64


def split3(x: torch.Tensor):
    """(x0, x1, x2), float32 tensors of bfloat16 values: x0 = bf16_rn(x),
    x1 = bf16_rn(x - x0), x2 = bf16_rn(x - x0 - x1), each difference exact
    (Sterbenz).  x0 + x1 + x2 == x for every float32 x whose third slice
    stays in bfloat16's normal range (|x| >= about 2^-110) and whose first
    does not overflow (|x| < 2^128 * (1 - 2^-9), about 3.39e38: the largest
    finite floats round to infinity in bfloat16)."""
    x = x.float()
    x0 = x.to(torch.bfloat16).float()
    r = x - x0
    x1 = r.to(torch.bfloat16).float()
    x2 = (r - x1).to(torch.bfloat16).float()
    return x0, x1, x2


def split_grid(x: torch.Tensor, dim: int = -1, run: int = 16):
    """(x0, x1, x2), float32 tensors of bfloat16 values, of float32 x:
    x0 is x rounded to nearest on one grid for each run of ``run`` entries
    along ``dim`` (runs from index 0; the last one may be short), 2^(E-8)
    where 2^E > the run's largest |x| (E = the exponent field of that
    largest |x| less 126, at least -125, as the kernels take it); x1 =
    bf16_rn(x - x0), x2 = bf16_rn(x - x0 - x1), each difference exact.

    x0 is k * 2^(E-8) with |k| <= 256, so it is exact in bfloat16, and the
    products of two runs' lead slices all lie on one grid: 32 of them sum
    to under 2^21 of its units, exactly in float32.  x - x0 is under
    2^(E-9) and exact; x0 + x1 + x2 is within 2^(E-27) of x (rounded to
    nearest: no bias).  The split passes gradients straight through x0."""
    x = x.float()
    xd = x.detach().movedim(dim, -1)
    n = xd.shape[-1]
    g = torch.nn.functional.pad(xd, (0, -n % run))
    g = g.reshape(*xd.shape[:-1], -1, run)
    E = torch.frexp(g.abs().amax(-1, keepdim=True)).exponent.clamp(min=-125)
    scale = torch.ldexp(torch.ones_like(E, dtype=torch.float32), E - 8)
    x0 = torch.round(g / scale) * scale  # both exact: scale is 2^(E-8)
    x0 = x0.reshape(*xd.shape[:-1], -1)[..., :n].movedim(-1, dim)
    r = x.detach() - x0
    x1 = r.to(torch.bfloat16).float()
    x2 = (r - x1).to(torch.bfloat16).float()
    if x.requires_grad:
        x0 = x0 + (x - x.detach())
    return x0, x1, x2


def _slices(skT: torch.Tensor, skT_lo: Optional[torch.Tensor]):
    """[P, D, O] float32 operator slices: split_grid along D (a grid for
    each column and KC-row group) and, under "high", bf16(skT_lo)."""
    s = list(split_grid(skT, dim=0, run=KC))
    if skT_lo is not None:
        s.append(skT_lo.float().to(torch.bfloat16).float())
    return torch.stack(s)


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of [..., n, 64] bfloat16 tiles, an involution:
    the 16-byte chunk c of row n is stored at chunk c ^ (n % 8), the layout
    that TMA's SWIZZLE_128B writes and wgmma's 128B descriptor reads."""
    n = torch.arange(t.shape[-2], device=t.device)
    chunk = torch.arange(8, device=t.device)[None, :] ^ (n[:, None] % 8)
    idx = (chunk[:, :, None] * 8
           + torch.arange(8, device=t.device)).reshape(t.shape[-2], 64)
    return torch.gather(t, -1, idx.expand(t.shape))


def _pack(s: torch.Tensor, BN: int) -> torch.Tensor:
    """[P, D, O] slices packed for the kernel's BN-column tile (see
    operator_parts)."""
    P, D, O = s.shape
    Kt, Nt = -(-D // TILE_K), -(-O // BN)
    pad = s.new_zeros((P, Kt * TILE_K, Nt * BN))
    pad[:, :D, :O] = s
    t = pad.reshape(P, Kt, TILE_K, Nt, BN).permute(3, 1, 0, 4, 2)
    if BN == 8:
        side = s.new_zeros((Kt * TILE_K, BN))
        for p in range(P):
            side[:D, 2 * p : 2 * p + O] = s[p]
        side = side.reshape(1, Kt, 1, TILE_K, BN).transpose(3, 4)
        t = torch.cat([t, side], dim=2)
    return _swizzle(t.to(torch.bfloat16).contiguous())


def operator_parts(skT: torch.Tensor,
                   skT_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The operator skT (+ skT_lo), [D, O], in the form ``frac_whole``
    takes it; ``ops/operators.py`` builds it once for each executor.

    float64: [P, D, O], skT (and skT_lo) stacked, which the float64 kernel
    reads as it is.  float32: the P slices of skT (and bf16(skT_lo)),
    zero-padded to whole tiles (TILE_K rows of D, ``_tile_n(O)`` columns of
    O) and packed as bfloat16 [n_col_tiles, n_k_tiles, P, BN, TILE_K],
    K-major, each [BN, TILE_K] tile 128-byte swizzled: one contiguous block
    per (column tile, k-tile), copied to shared memory as it lies.  For O
    <= 2 one more tile follows the P (index P): the slices side by side,
    column 2p + j holding slice p's column j, which the kernel multiplies
    (the P tiles are its plain model's)."""
    if skT.dim() != 2 or skT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"skT must be a float32 or float64 [D, O] matrix, "
                        f"got {skT.dtype} {tuple(skT.shape)}")
    if skT_lo is not None and (skT_lo.shape != skT.shape
                               or skT_lo.dtype != skT.dtype):
        raise ValueError("skT_lo must match skT's shape and dtype")
    if skT.dtype == torch.float64:
        return torch.stack([skT] if skT_lo is None else [skT, skT_lo])
    return _pack(_slices(skT, skT_lo), _tile_n(skT.shape[1]))


def unpack_parts(parts: torch.Tensor, D: int, O: int) -> torch.Tensor:
    """[P, D, O] slices of an operator_parts (float32 for a packed one, the
    float64 stack as it is): operator_parts' inverse."""
    if parts.dtype == torch.float64:
        return parts
    if parts.shape[3] == 8:
        parts = parts[:, :, :-1]  # the side-by-side tile
    Nt, Kt, P, BN, TK = parts.shape
    t = _swizzle(parts).float().permute(2, 1, 4, 0, 3)
    return t.reshape(P, Kt * TK, Nt * BN)[:, :D, :O]


class OperatorBand(nn.Module):
    """The nonzero band of a float32 ``operator_parts``: for each column
    tile, the first k16 step of D (``K_STEP`` rows) where some slice holds
    a nonzero entry in the tile's columns and one past the last ((0, 0)
    for an all-zero tile).  ``steps`` is an int32 buffer [n_col_tiles, 2]
    on the operator's device, which the kernel reads, and ``host`` the same
    pairs as Python integers, kept from the build, so that a call reads
    nothing back from the card.  A module, so that it moves with its
    executor."""

    def __init__(self, steps: torch.Tensor):
        super().__init__()
        if steps.dtype != torch.int32 or steps.dim() != 2 \
                or steps.shape[1] != 2:
            raise ValueError(f"a band is int32 [n_col_tiles, 2], got "
                             f"{steps.dtype} {tuple(steps.shape)}")
        self.register_buffer("steps", steps.contiguous())
        self.host = tuple((a, b) for a, b in steps.tolist())
        #: folds of KC_LO and of KC terms one row tile walks
        self.folds = {kc: sum(len(self.fold_range(t, kc))
                              for t in range(len(self.host)))
                      for kc in (KC_LO, KC)}

    def fold_range(self, tile: int, kc: int) -> range:
        """The folds of kc terms (fold f: d in [f*kc, (f+1)*kc)) that
        column tile ``tile`` walks: those that meet its band."""
        a, b = self.host[tile]
        k = kc // K_STEP
        return range(a // k, -(-b // k)) if b > a else range(0)


def operator_band(parts: torch.Tensor) -> Optional[OperatorBand]:
    """The ``OperatorBand`` of a float32 ``operator_parts``, computed on its
    device (one read back of n_col_tiles pairs), built once beside it;
    None for the float64 stack, whose kernel walks all of D.  Every slice
    counts, bf16(skT_lo) too."""
    if parts.dtype == torch.float64:
        return None
    Nt, Kt, PT, BN, TK = parts.shape
    n = Kt * TK // K_STEP
    nz = (_swizzle(parts) != 0).reshape(Nt, Kt, PT, BN, TK // K_STEP, K_STEP)
    nz = nz.any(dim=5).any(dim=3).any(dim=2).reshape(Nt, n)
    step = torch.arange(n, device=parts.device)
    hit = nz.any(dim=1)
    first = torch.where(nz, step, n).amin(dim=1)
    last = torch.where(nz, step, -1).amax(dim=1) + 1
    steps = torch.stack([torch.where(hit, first, 0),
                         torch.where(hit, last, 0)], dim=1)
    return OperatorBand(steps.to(torch.int32))


def _check(x, parts, I, D, O, n_win, kc):
    if kc not in (KC_LO, KC):
        raise ValueError(f"kc must be {KC_LO} or {KC}, got {kc}")
    if x.dim() != 2:
        raise ValueError(f"x must be [C, N], got {tuple(x.shape)}")
    if x.dtype == torch.float32:
        if parts.dtype != torch.bfloat16:
            raise TypeError(f"a float32 x takes the packed bfloat16 "
                            f"operator_parts, got {parts.dtype}")
        BN = _tile_n(O)
        want = (-(-O // BN), -(-D // TILE_K), BN, TILE_K)
        P = parts.shape[2] - (BN == 8) if parts.dim() == 5 else 0
        if (parts.dim() != 5 or P not in (3, 4)
                or tuple(parts.shape[:2]) + tuple(parts.shape[3:]) != want):
            raise ValueError(f"parts must be operator_parts of a [D={D}, "
                             f"O={O}] operator: bfloat16 [{want[0]}, "
                             f"{want[1]}, 3 or 4{' (+1)' if BN == 8 else ''}"
                             f", {BN}, {TILE_K}], got {tuple(parts.shape)}")
    elif x.dtype == torch.float64:
        if parts.dtype != torch.float64:
            raise TypeError(f"a float64 x takes the float64 operator_parts, "
                            f"got {parts.dtype}")
        if parts.dim() != 3 or parts.shape[0] not in (1, 2) \
                or tuple(parts.shape[1:]) != (D, O):
            raise ValueError(f"parts must be operator_parts of a [D={D}, "
                             f"O={O}] operator: float64 [1 or 2, {D}, {O}], "
                             f"got {tuple(parts.shape)}")
    else:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if n_win < 1 or I < 1:
        raise ValueError(f"need n_win >= 1 and I >= 1, got {n_win}, {I}")


def _check_band(x, parts, band):
    """A float32 call on the card takes its operator's band; one given
    must fit the operator and lie on x's device."""
    if x.dtype != torch.float32:
        return
    if band is None:
        if x.device.type == "cuda":
            raise ValueError("a float32 frac_whole on the card takes the "
                             "operator's band, operator_band(parts)")
        return
    if not isinstance(band, OperatorBand) \
            or tuple(band.steps.shape) != (parts.shape[0], 2):
        raise ValueError(f"band must be the OperatorBand of the operator's "
                         f"{parts.shape[0]} column tiles")
    if band.steps.device != x.device:
        raise ValueError(f"the band lies on {band.steps.device}, x on "
                         f"{x.device}")


def _fold_slices(x: torch.Tensor, n_win: int, I: int, D: int, O: int,
                 kc: int):
    """Per fold of kc terms (d0 = 0, kc, 2kc, ...): (d0, d1, (x0, x1,
    x2)), the window rows' values x[c, m*I + d] for d0 <= d < d1 as
    [C, n_win, d1 - d0] slices, split by ``split_grid`` over the fold: one
    grid for each window row (the grid belongs to the row, not the
    sample), or at I = 1 on the 8-column tile (O <= 2), where the kernel
    splits each sample once for all the rows of a warp that read it, for
    each 16 windows from m = 0, the last group's windows past n_win
    reading on into zeros past x's end, as the kernel's rows do."""
    rows = 16 if I == 1 and _tile_n(O) == 8 else 1
    n = -(-n_win // rows) * rows
    if n > n_win:
        x = F.pad(x, (0, (n - n_win) * I))
    for d0 in range(0, D, kc):
        d1 = min(D, d0 + kc)
        w = x[:, d0:].unfold(1, d1 - d0, I)[:, :n]  # a strided view
        if rows == 1:
            yield d0, d1, split_grid(w, run=kc)
            continue
        C, k = w.shape[0], d1 - d0
        s = split_grid(w.reshape(C, n // rows, rows * k), run=rows * k)
        yield d0, d1, tuple(v.reshape(C, n, k)[:, :n_win] for v in s)


def _band_mask(band, f: int, kc: int, BN: int, O: int, device):
    """Which of the O columns walk fold f (a bool [O] on ``device``);
    None where all do, as without a band and on the 8-column tile (which
    walks all of D)."""
    if band is None or BN == 8:
        return None
    walk = [f in band.fold_range(t, kc) for t in range(len(band.host))]
    if all(walk):
        return None
    return torch.tensor(walk, device=device).repeat_interleave(BN)[:O]


def frac_whole_ref(x: torch.Tensor, parts: torch.Tensor, I: int, D: int,
                   O: int, n_win: int, kc: int = KC,
                   band: Optional[OperatorBand] = None,
                   start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``frac_whole``, on any device.

    The windows are framed first: ``shifted(x, start, L)`` (L = (n_win-1)*I
    + D), a view of x where x covers [start, start + L), else a zero-padded
    copy.  float64: one framed contraction per stacked operator (segmented
    reshape views).  float32: the kernel's split arithmetic on the slices
    of ``parts``, fold by fold (``_fold_slices``): the small pairs
    x0*(s1+s2) + x1*(s0+s1) + x2*s0 (+ x0*bf16(skT_lo)) as one float32
    matmul a fold, added to lo; the big pair x0*s0 as one matmul a fold,
    exact in float32 whatever its order (its products lie on one grid),
    folded with two_sum into (hi, lo), both 0 at the start; once a
    TILE_K-row k-tile lo moves into hi (Fast2Sum: t = hi + lo, lo = lo -
    (t - hi), hi = t); hi + lo.  With ``band`` (``operator_band(parts)``) a
    column takes a fold only where the fold meets its tile's band, as the
    kernel walks it (the 8-column tile walks all of D), and a fold that
    meets no tile's band is not computed."""
    _check(x, parts, I, D, O, n_win, kc)
    C = x.shape[0]
    L = (n_win - 1) * I + D
    xp = shifted(x, start, L, x.dtype)
    s = unpack_parts(parts, D, O)
    if xp.dtype == torch.float64:
        y = _framed_matmul(xp, s[0], n_win, I)
        if s.shape[0] == 2:
            y = y + _framed_matmul(xp, s[1], n_win, I)
        return y.reshape(C, n_win * O)
    # the small pairs' operator rows, stacked along K to match the
    # concatenated slices [x0, x1, x2 (, x0)] of a fold
    rhs = [s[1] + s[2], s[0] + s[1], s[0]] + ([s[3]] if s.shape[0] == 4
                                             else [])
    hi = xp.new_zeros((C, n_win, O))
    lo = xp.new_zeros((C, n_win, O))
    for d0, d1, (x0, x1, x2) in _fold_slices(xp[:, :L], n_win, I, D, O,
                                               kc):
        walk = _band_mask(band, d0 // kc, kc, parts.shape[3], O, xp.device)
        if walk is None or bool(walk.any()):
            acc = torch.matmul(x0, s[0, d0:d1])
            lhs = [x0, x1, x2, x0][:len(rhs)]
            sm = torch.matmul(torch.cat(lhs, dim=-1),
                              torch.cat([r[d0:d1] for r in rhs]))
            h, e = two_sum(hi, acc)
            l_ = (lo + sm) + e
            if walk is None:
                hi, lo = h, l_
            else:
                hi, lo = torch.where(walk, h, hi), torch.where(walk, l_, lo)
        if d1 % TILE_K == 0:  # Fast2Sum, as the kernel
            t = hi + lo
            hi, lo = t, lo - (t - hi)
    return (hi + lo).reshape(C, n_win * O)


def copy_width(x: torch.Tensor, origin: int, I: int, O: int) -> int:
    """The bytes of each copy with which the float32 kernel stages the
    windows of a call reading x from window origin ``origin``; the launch
    hands the kernel this choice (``csrc/frac_whole.cu``, ``launch_split``,
    which refuses 16 where the alignment does not allow it).  16 where x's
    first column and the origin lie on 16 bytes and I and x's row stride
    are multiples of 4 floats; 8 where the origin lies on 8 bytes and I and
    the row stride are even (a row whose copies would straddle x's first
    column copies a float at a time); else 4, as for float64 and the
    8-column tile's stretches, which copy a float at a time."""
    if x.dtype != torch.float32 or (_tile_n(O) == 8
                                    and I <= _MAX_STRETCH_I):
        return 4
    p, ldx = x.data_ptr() // 4 + origin, x.stride(0)  # the origin's float
    if p % 4 == 0 and x.data_ptr() % 16 == 0 and ldx % 4 == 0 \
            and I % 4 == 0:
        return 16
    return 8 if p % 2 == 0 and ldx % 2 == 0 and I % 2 == 0 else 4


def lead_rows(x: torch.Tensor, start: int, I: int, D: int, O: int) -> int:
    """The leading zero rows s (0 to 3) a launch on the card gives the
    operator so that the window origin start - s takes the widest copies
    (``copy_width``), the fewest rows among the widest; none that would
    add a k-tile of D.  Which s that is follows x's address: the same
    samples at another storage offset may take another s, and with it an
    operator whose folds group D's rows otherwise (``_lead_operator``), so
    other bits within the kernel's tolerance."""
    k_tiles = -(-D // TILE_K)
    fits = [s for s in range(4) if -(-(D + s) // TILE_K) == k_tiles]
    return max(fits, key=lambda s: (copy_width(x, start - s, I, O), -s))


#: Operators with leading zero rows, per operator_parts tensor: {(D, O, s,
#: version): (operator_parts, band)}, built on first use and dropped with
#: the operator.
_LEADS = WeakTensorKeyDictionary()


def _lead_operator(parts: torch.Tensor, D: int, O: int, s: int):
    """(operator_parts, operator_band) of the float32 operator the forward
    computes with, s0 + s1 + s2 (exact in float32), and bf16(skT_lo) as it
    is, each with s leading zero rows: split anew, so that its lead slice
    lies on grids of its own 32-row groups (the kernel's folds start at a
    multiple of kc from its row 0).  Built once per operator and s, from
    the buffer itself, outside torch.func's transforms."""
    def build():
        with torch.no_grad():
            sl = unpack_parts(parts, D, O)
            ops = [sl[0] + sl[1] + sl[2]] + ([sl[3]] if sl.shape[0] == 4
                                             else [])
            ap = operator_parts(*(F.pad(t, (0, 0, s, 0)) for t in ops))
            return ap, operator_band(ap)

    parts = _operator(parts)
    return _derived(_LEADS, parts, (D, O, s), build)


def _derived(cache, parts: torch.Tensor, key: tuple, build):
    """build(), once per operator buffer ``parts``, ``key`` and the
    buffer's version, kept in ``cache`` (a WeakTensorKeyDictionary, so it
    goes with the operator) and built outside torch.func's transforms: a
    backward under one would otherwise make them its wrappers, which
    outlive it in the cache and have no storage for the kernel to read."""
    per = cache.get(parts)
    if per is None:
        per = cache[parts] = {}
    key = key + (parts._version,)
    value = per.get(key)
    if value is None:
        with torch._C._DisableFuncTorch():
            value = per[key] = build()
    return value


_F64_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_F32_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launcher(dtype):
    lib = _cuda.load("frac_whole")
    if dtype == torch.float32:
        fn, fn.argtypes = lib.r8b_frac_whole_f32, _F32_ARGS
    else:
        fn, fn.argtypes = lib.r8b_frac_whole_f64, _F64_ARGS
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, parts: torch.Tensor, I: int, D: int, O: int,
            n_win: int, kc: int, band, start: int) -> torch.Tensor:
    """One launch of the kernel (counted in ``frac_whole.launches``),
    reading x in place from window origin ``start``."""
    if x.stride(1) != 1:
        raise ValueError("x must have unit stride along time")
    if parts.device != x.device or not parts.is_contiguous():
        raise ValueError("the operator must be contiguous on x's device")
    C, N = x.shape
    y = torch.empty((C, n_win * O), dtype=x.dtype, device=x.device)
    if C == 0:
        return y
    fn = _launcher(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.float32:
            Nt, Kt, P, BN, _ = parts.shape
            rc = fn(x.data_ptr(), x.stride(0), start, N, parts.data_ptr(),
                    _operator(band.steps).data_ptr(), P - (BN == 8), BN,
                    Kt, y.data_ptr(), C, n_win, I, D, O, kc,
                    int(copy_width(x, start, I, O) == 16), stream)
        else:
            rc = fn(x.data_ptr(), x.stride(0), start, N, parts[0].data_ptr(),
                    parts[1].data_ptr() if parts.shape[0] == 2 else None,
                    y.data_ptr(), C, n_win, I, D, O, stream)
    if rc != 0:
        raise RuntimeError(f"frac_whole kernel launch failed: CUDA error {rc}")
    frac_whole.launches += 1
    return y


def _count_folds(x, parts, I, D, n_win, kc, band):
    """``frac_whole.folds`` (folds walked: each column tile's band, or all
    of D without one and on the 8-column tile) and
    ``frac_whole.folds_full`` (all of D), over the kernel's row tiles
    (channel-aligned on the 8-column tile at I <= 64), from host
    integers."""
    Nt, BN = parts.shape[0], parts.shape[3]
    C = x.shape[0]
    if BN == 8 and I <= _MAX_STRETCH_I:
        rows = C * -(-n_win // _BLOCK_M)
    else:
        rows = -(-C * n_win // _BLOCK_M)
    full = Nt * -(-D // kc)
    count("frac_whole.folds", rows * (full if band is None or BN == 8
                                      else band.folds[kc]))
    count("frac_whole.folds_full", rows * full)


def _run(x, parts, I, D, O, n_win, kc, band, start):
    if x.device.type == "cuda":
        s = lead_rows(x, start, I, D, O)
        if s:
            parts, band = _lead_operator(parts, D, O, s)
            D, start = D + s, start - s
    if x.dtype == torch.float32:
        _count_folds(x, parts, I, D, n_win, kc, band)
    if x.device.type == "cpu":
        # a fresh tensor, not a view: callers correct outputs in place
        y = frac_whole_ref(x, parts, I, D, O, n_win, kc, band, start)
        return y if y._base is None else y.clone()
    if x.device.type != "cuda":
        raise RuntimeError(f"frac_whole runs on cuda or cpu, not {x.device}")
    return _launch(x, parts, I, D, O, n_win, kc, band, start)


#: Adjoint operators, per operator_parts tensor: {(I, D, O, version): (the
#: adjoint's operator_parts, its band)}, built on first use and dropped
#: with the operator.
_ADJOINTS = WeakTensorKeyDictionary()


def adjoint_geometry(I: int, D: int, O: int):
    """(I', D', O', K) of frac_whole's adjoint: with K = ceil(D / I),

        xbar[a*I + i] = sum_{k<K} sum_j ybar[(a-k)*O + j] * T[k*I + i, j],

    a frac_whole call at I' = O, D' = K*O, O' = I on ybar left-padded by
    (K-1)*O zeros, against T'[(K-1-k)*O + j, i] = T[k*I + i, j] (zero
    where k*I + i >= D)."""
    K = -(-D // I)
    return O, K * O, I, K


def _adjoint_operator(parts: torch.Tensor, I: int, D: int, O: int):
    """(operator_parts, operator_band) of the adjoint, built once per
    operator (see ``adjoint_parts``) from the buffer itself
    (``_derived``)."""
    return _derived(_ADJOINTS, parts, (I, D, O),
                    lambda: _build_adjoint(parts, I, D, O))


def _build_adjoint(parts: torch.Tensor, I: int, D: int, O: int):
    _I, Dp, _O, K = adjoint_geometry(I, D, O)
    s = unpack_parts(parts, D, O)
    if parts.dtype != torch.float64:
        ops = [s[0] + s[1] + s[2]] + ([s[3]] if s.shape[0] == 4 else [])
        s = torch.stack(ops)
    sp = s.new_zeros((s.shape[0], K * I, O))
    sp[:, :D] = s
    t = sp.reshape(s.shape[0], K, I, O).flip(1).transpose(2, 3)
    t = t.reshape(s.shape[0], Dp, I)
    ap = (t.contiguous() if parts.dtype == torch.float64
          else operator_parts(*t))
    return ap, operator_band(ap)


def adjoint_parts(parts: torch.Tensor, I: int, D: int,
                  O: int) -> torch.Tensor:
    """The operator_parts of frac_whole's adjoint (``adjoint_geometry``)
    from the forward's ``parts``, built once per operator, with its band.
    float32: the operator the forward computes with, s0 + s1 + s2 (exact
    in float32), re-blocked and split anew (``operator_parts``), so that
    its lead slice lies on the adjoint's own grids, one for each of its
    columns and KC-row groups, and the adjoint's fold sums are exact too;
    bf16(skT_lo) re-blocked as it is.  float64: the stacked operators
    re-blocked."""
    return _adjoint_operator(parts, I, D, O)[0]


def _operator(parts: torch.Tensor) -> torch.Tensor:
    """The executor's buffer itself (its operator, or its band's steps):
    torch.func hands a Function's backward a fresh wrapper of the operator
    on every call, and the adjoint cache is keyed on the buffer (a
    constant of every transform); an executor built under a transform
    (a gradient's twin) holds its buffers as that transform's wrappers,
    which have no storage for the kernel to read."""
    while torch._C._functorch.is_functorch_wrapped_tensor(parts):
        parts = torch._C._functorch.get_unwrapped(parts)
    return parts


def _adjoint(gy: torch.Tensor, parts, I, D, O, n_win, kc, N: int,
             start: int):
    """xbar [C, N] = frac_whole's transpose on gy [C, n_win*O]: the
    adjoint reads gy in place with (K-1)*O zeros on each side, gives the
    gradient over the windows' span from ``start``, and that span is cut
    to x's [0, N)."""
    Ia, Da, Oa, K = adjoint_geometry(I, D, O)
    before = frac_whole.launches
    ap, ab = _adjoint_operator(_operator(parts), I, D, O)
    gx = _FracWhole.apply(gy.contiguous(), ap, Ia, Da, Oa, n_win + K - 1,
                          kc, ab, -(K - 1) * O)
    frac_whole.adjoint_launches += frac_whole.launches - before
    return shifted(gx, -start, N, gx.dtype)[:, :N]


class _FracWhole(torch.autograd.Function):
    """frac_whole as a linear map of x (the operator is a constant): the
    backward is frac_whole itself on the adjoint geometry, the jvp
    frac_whole on the tangent, and vmap folds batch dimensions into rows
    (every row is independent)."""

    @staticmethod
    def forward(x, parts, I, D, O, n_win, kc, band, start):
        return _run(x, parts, I, D, O, n_win, kc, band, start)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, parts, I, D, O, n_win, kc, band, start = inputs
        ctx.geo = (I, D, O, n_win, kc, x.shape[1], start)
        ctx.band = band
        ctx.save_for_backward(parts)
        ctx.save_for_forward(parts)

    @staticmethod
    def backward(ctx, gy):
        if not ctx.needs_input_grad[0]:
            return (None,) * 9
        (parts,) = ctx.saved_tensors
        return (_adjoint(gy, parts, *ctx.geo),) + (None,) * 8

    @staticmethod
    def jvp(ctx, gx, *_rest):
        if gx is None:
            return None
        (parts,) = ctx.saved_tensors
        I, D, O, n_win, kc, _N, start = ctx.geo
        return _FracWhole.apply(gx.contiguous(), parts, I, D, O, n_win, kc,
                                ctx.band, start)

    @staticmethod
    def vmap(info, in_dims, x, parts, I, D, O, n_win, kc, band, start):
        if in_dims[1] is not None:
            raise ValueError("frac_whole's operator cannot be batched")
        if in_dims[0] is None:
            return _FracWhole.apply(x, parts, I, D, O, n_win, kc, band,
                                    start), None
        xb = x.movedim(in_dims[0], 0)
        B, C = xb.shape[0], xb.shape[1]
        y = _FracWhole.apply(xb.reshape(B * C, xb.shape[2]).contiguous(),
                             parts, I, D, O, n_win, kc, band, start)
        return y.reshape(B, C, y.shape[1]), 0


@spanned("r8b.kernel.frac_whole")
def frac_whole(x: torch.Tensor, parts: torch.Tensor, I: int, D: int,
               O: int, n_win: int, kc: int = KC,
               band: Optional[OperatorBand] = None,
               start: int = 0) -> torch.Tensor:
    """y [C, n_win*O]: y[c, m*O + j] = x[c, start + m*I : start + m*I + D]
    . skT[:, j] (+ the same dot against skT_lo), x zero outside [0, N), for
    parts = ``operator_parts(skT, skT_lo)`` of x's dtype on x's device.

    x: [C, N] with unit stride along time (any row stride, any storage
    offset; slice it for a shorter logical length), read where it lies;
    start: the signed column of x where window 0 begins; kc: terms a
    float32 big-pair partial sums before its fold, ``KC`` or ``KC_LO``
    (float64 ignores it); band: ``operator_band(parts)`` on x's device,
    which a float32 call on the card must give (float64 ignores it; on the
    CPU without one every fold is walked).  On a CUDA tensor this launches
    the kernel (counted in ``frac_whole.launches``) or raises; on a CPU
    tensor it is ``frac_whole_ref``.  Each float32 call adds the folds it
    walks to the counter ``frac_whole.folds`` and those of all of D to
    ``frac_whole.folds_full`` (``utils/trace.py``: while a profiler
    records).

    Differentiable in x (torch.autograd, torch.func): the gradient is
    this function on the adjoint geometry (``adjoint_geometry``,
    ``adjoint_parts``), cut to x's columns, so on a CUDA tensor the
    backward launches the kernel too, counted in ``frac_whole.launches``
    and apart in ``frac_whole.adjoint_launches``.

    The float32 kernel's big-pair fold sums equal the model's, but it adds
    the small pairs into lo on the tensor cores, in their own order and
    truncated, so it matches ``frac_whole_ref`` to 2^-21 of max |y|, not
    bit for bit; float64 matches to 1e-12.  A launch that shifts the
    origin (``lead_rows``) matches the model of its shifted operator so,
    and the model of this one within the same tolerance: which shift it
    takes follows x's address, so the same samples at another storage
    offset may give other bits, within that tolerance."""
    start = operator.index(start)
    _check(x, parts, I, D, O, n_win, kc)
    _check_band(x, parts, band)
    return _FracWhole.apply(x, parts, I, D, O, n_win, kc, band, start)


frac_whole.launches = 0
frac_whole.adjoint_launches = 0
