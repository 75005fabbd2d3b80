"""Framed matmul of the fused chain: the hand-written CUDA kernel and its
plain PyTorch version.

    y[c, m*O + j] = sum_{d<D} xp[c, m*I + d] * skT[d, j]
                  (+ sum_{d<D} xp[c, m*I + d] * skT_lo[d, j])

Counterpart of the reference package's ``ops/pallas_frac.py``
(``frac_whole_pallas``): the same function, with the optional residual dot
against the f64->f32 operator residual that ``precision="high"`` passes.

``frac_whole`` launches ``csrc/frac_whole.cu`` on a CUDA tensor and runs
``frac_whole_ref`` on a CPU tensor.  Both take the operator as
``operator_parts(skT, skT_lo)``, which each executor builds once.  In
float32 both compute the exact three-slice bfloat16 split form that the
kernel runs on the tensor cores:

* each input sample and each operator entry is split into three bfloat16
  slices, x = x0 + x1 + x2 (``split3``: each slice the nearest bfloat16 to
  what the ones before left; exact for every float32 input in bfloat16's
  normal range, see ``split3``), the operator in ``operator_parts``, under
  "high" with one more slice, bf16(skT_lo);
* every slice product is exact in float32 (8 x 8 significant bits);
* the big pair x0*s0 sums in ``kc``-term float32 chunks (``KC`` = 32, or
  ``KC_LO`` = 16 where the caller asks), each folded into a (hi, lo) pair
  with ``two_sum``; the five small pairs with p+q <= 2 (and x0*bf16(skT_lo))
  sum into lo over all of D; y = hi + lo, rounded once.

The dropped pairs (x1*s2, x2*s1, x2*s2) are below 2^-26 of each product.
On the flagship operator the model reads -150.7 dB re full scale at
32-term folds, where float32 products summed in 32-term chunks folded
with two_sum read -144.5 and a single running float32 sum over D = 1027
terms about -132: the split is what holds the class on tensor cores
without TF32.

The function is linear in xp, and ``frac_whole`` is differentiable in it
(torch.autograd and torch.func): its gradient is ``frac_whole`` itself on
the adjoint geometry (``adjoint_geometry``) against the same operator
re-blocked (``adjoint_parts``, built once per operator), so on the card
the backward launches the kernel too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from . import _cuda
from .dfloat import two_sum
from .framing import _frames, _framed_matmul

__all__ = ["KC", "KC_LO", "TILE_K", "split3", "operator_parts",
           "unpack_parts", "adjoint_geometry", "adjoint_parts", "frac_whole",
           "frac_whole_ref"]

#: Terms per partial sum of the big pair before the two_sum fold (two k16
#: tensor-core steps).
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


def _slices(skT: torch.Tensor, skT_lo: Optional[torch.Tensor]):
    """[P, D, O] float32 operator slices: s0, s1, s2 (and bf16(skT_lo))."""
    s = list(split3(skT))
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
    takes it; each executor builds it once (a buffer beside skT).

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


def _check(xp, parts, I, D, O, n_win, kc):
    if kc not in (KC_LO, KC):
        raise ValueError(f"kc must be {KC_LO} or {KC}, got {kc}")
    if xp.dim() != 2:
        raise ValueError(f"xp must be [C, L], got {tuple(xp.shape)}")
    if xp.dtype == torch.float32:
        if parts.dtype != torch.bfloat16:
            raise TypeError(f"a float32 xp takes the packed bfloat16 "
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
    elif xp.dtype == torch.float64:
        if parts.dtype != torch.float64:
            raise TypeError(f"a float64 xp takes the float64 operator_parts, "
                            f"got {parts.dtype}")
        if parts.dim() != 3 or parts.shape[0] not in (1, 2) \
                or tuple(parts.shape[1:]) != (D, O):
            raise ValueError(f"parts must be operator_parts of a [D={D}, "
                             f"O={O}] operator: float64 [1 or 2, {D}, {O}], "
                             f"got {tuple(parts.shape)}")
    else:
        raise TypeError(f"xp must be float32 or float64, got {xp.dtype}")
    if n_win < 1 or I < 1:
        raise ValueError(f"need n_win >= 1 and I >= 1, got {n_win}, {I}")
    if xp.shape[1] < (n_win - 1) * I + D:
        raise ValueError(f"xp has {xp.shape[1]} samples; {n_win} windows "
                         f"need {(n_win - 1) * I + D}")


def _two_sum_fold(hi, lo, acc):
    s, e = two_sum(hi, acc)
    return s, lo + e


def frac_whole_ref(xp: torch.Tensor, parts: torch.Tensor, I: int, D: int,
                   O: int, n_win: int, kc: int = KC) -> torch.Tensor:
    """Plain PyTorch version of ``frac_whole``, on any device.

    float64: one framed contraction per stacked operator (segmented reshape
    views).  float32: the kernel's split arithmetic on the slices of
    ``parts`` -- the big pair x0*s0 in ``kc``-term chunks, each a
    segmented matmul, folded with two_sum into (hi, lo); the small pairs as
    three framed products x0*(s1+s2) + x1*(s0+s1) + x2*s0 (+
    x0*bf16(skT_lo)) added to lo; hi + lo."""
    _check(xp, parts, I, D, O, n_win, kc)
    C = xp.shape[0]
    s = unpack_parts(parts, D, O)
    if xp.dtype == torch.float64:
        y = _framed_matmul(xp, s[0], n_win, I)
        if s.shape[0] == 2:
            y = y + _framed_matmul(xp, s[1], n_win, I)
        return y.reshape(C, n_win * O)
    L = (n_win - 1) * I + D
    x0, x1, x2 = split3(xp[:, :L])
    hi = lo = None
    for d0 in range(0, D, kc):
        d1 = min(D, d0 + kc)
        acc = torch.matmul(_frames(x0[:, d0:], n_win, I, d1 - d0), s[0, d0:d1])
        if hi is None:
            hi, lo = acc, torch.zeros_like(acc)
        else:
            hi, lo = _two_sum_fold(hi, lo, acc)
    small = (_framed_matmul(x0, s[1] + s[2], n_win, I)
             + _framed_matmul(x1, s[0] + s[1], n_win, I)
             + _framed_matmul(x2, s[0], n_win, I))
    if s.shape[0] == 4:
        small = small + _framed_matmul(x0, s[3], n_win, I)
    return (hi + (lo + small)).reshape(C, n_win * O)


_F64_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_F32_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launcher(dtype):
    lib = _cuda.load("frac_whole")
    if dtype == torch.float32:
        fn, fn.argtypes = lib.r8b_frac_whole_f32, _F32_ARGS
    else:
        fn, fn.argtypes = lib.r8b_frac_whole_f64, _F64_ARGS
    fn.restype = ctypes.c_int
    return fn


def _launch(xp: torch.Tensor, parts: torch.Tensor, I: int, D: int, O: int,
            n_win: int, kc: int) -> torch.Tensor:
    """One launch of the kernel (counted in ``frac_whole.launches``)."""
    if xp.stride(1) != 1:
        raise ValueError("xp must have unit stride along time")
    if parts.device != xp.device or not parts.is_contiguous():
        raise ValueError("the operator must be contiguous on xp's device")
    C = xp.shape[0]
    y = torch.empty((C, n_win * O), dtype=xp.dtype, device=xp.device)
    if C == 0:
        return y
    fn = _launcher(xp.dtype)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        if xp.dtype == torch.float32:
            Nt, Kt, P, BN, _ = parts.shape
            rc = fn(xp.data_ptr(), xp.stride(0), parts.data_ptr(),
                    P - (BN == 8), BN, Kt, y.data_ptr(), C, n_win, I, D, O,
                    kc, stream)
        else:
            rc = fn(xp.data_ptr(), xp.stride(0), parts[0].data_ptr(),
                    parts[1].data_ptr() if parts.shape[0] == 2 else None,
                    y.data_ptr(), C, n_win, I, D, O, stream)
    if rc != 0:
        raise RuntimeError(f"frac_whole kernel launch failed: CUDA error {rc}")
    frac_whole.launches += 1
    return y


def _run(xp, parts, I, D, O, n_win, kc):
    if xp.device.type == "cpu":
        # a fresh tensor, not a view: callers correct outputs in place
        y = frac_whole_ref(xp, parts, I, D, O, n_win, kc)
        return y if y._base is None else y.clone()
    if xp.device.type != "cuda":
        raise RuntimeError(f"frac_whole runs on cuda or cpu, not {xp.device}")
    return _launch(xp, parts, I, D, O, n_win, kc)


#: Adjoint operators, per operator_parts tensor: {(I, D, O, version): the
#: adjoint's operator_parts}, built on first use and dropped with the
#: operator.
_ADJOINTS = WeakTensorKeyDictionary()


def adjoint_geometry(I: int, D: int, O: int):
    """(I', D', O', K) of frac_whole's adjoint: with K = ceil(D / I),

        xbar[a*I + i] = sum_{k<K} sum_j ybar[(a-k)*O + j] * T[k*I + i, j],

    a frac_whole call at I' = O, D' = K*O, O' = I on ybar left-padded by
    (K-1)*O zeros, against T'[(K-1-k)*O + j, i] = T[k*I + i, j] (zero
    where k*I + i >= D)."""
    K = -(-D // I)
    return O, K * O, I, K


def adjoint_parts(parts: torch.Tensor, I: int, D: int,
                  O: int) -> torch.Tensor:
    """The operator_parts of frac_whole's adjoint (``adjoint_geometry``)
    from the forward's ``parts``, built once per operator.  The slices are
    split per entry, so the adjoint's slices are a re-blocking of the same
    values: its arithmetic is the forward's, entry for entry."""
    per = _ADJOINTS.get(parts)
    if per is None:
        per = _ADJOINTS[parts] = {}
    key = (I, D, O, parts._version)
    adj = per.get(key)
    if adj is None:
        _I, Dp, _O, K = adjoint_geometry(I, D, O)
        s = unpack_parts(parts, D, O)
        sp = s.new_zeros((s.shape[0], K * I, O))
        sp[:, :D] = s
        t = sp.reshape(s.shape[0], K, I, O).flip(1).transpose(2, 3)
        t = t.reshape(s.shape[0], Dp, I)
        adj = per[key] = (t.contiguous() if parts.dtype == torch.float64
                          else _pack(t, _tile_n(I)))
    return adj


def _operator(parts: torch.Tensor) -> torch.Tensor:
    """The executor's operator buffer itself: torch.func hands a Function's
    backward a fresh wrapper of it on every call, and the adjoint cache is
    keyed on the buffer (a constant of every transform)."""
    while torch._C._functorch.is_functorch_wrapped_tensor(parts):
        parts = torch._C._functorch.get_unwrapped(parts)
    return parts


def _adjoint(gy: torch.Tensor, parts, I, D, O, n_win, kc, L: int):
    """xbar [C, L] = frac_whole's transpose on gy [C, n_win*O]."""
    Ia, Da, Oa, K = adjoint_geometry(I, D, O)
    gyp = F.pad(gy, ((K - 1) * O, (K - 1) * O))  # contiguous, as the kernel
    before = frac_whole.launches
    gx = _FracWhole.apply(gyp, adjoint_parts(_operator(parts), I, D, O),
                          Ia, Da, Oa, n_win + K - 1, kc)
    frac_whole.adjoint_launches += frac_whole.launches - before
    n = gx.shape[1]
    return gx[:, :L] if n >= L else F.pad(gx, (0, L - n))


class _FracWhole(torch.autograd.Function):
    """frac_whole as a linear map of xp (the operator is a constant): the
    backward is frac_whole itself on the adjoint geometry, the jvp
    frac_whole on the tangent, and vmap folds batch dimensions into rows
    (every row is independent)."""

    @staticmethod
    def forward(xp, parts, I, D, O, n_win, kc):
        return _run(xp, parts, I, D, O, n_win, kc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xp, parts, I, D, O, n_win, kc = inputs
        ctx.geo = (I, D, O, n_win, kc, xp.shape[1])
        ctx.save_for_backward(parts)
        ctx.save_for_forward(parts)

    @staticmethod
    def backward(ctx, gy):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        (parts,) = ctx.saved_tensors
        I, D, O, n_win, kc, L = ctx.geo
        return (_adjoint(gy, parts, I, D, O, n_win, kc, L),) + (None,) * 6

    @staticmethod
    def jvp(ctx, gxp, *_rest):
        if gxp is None:
            return None
        (parts,) = ctx.saved_tensors
        I, D, O, n_win, kc, _L = ctx.geo
        return _FracWhole.apply(gxp.contiguous(), parts, I, D, O, n_win, kc)

    @staticmethod
    def vmap(info, in_dims, xp, parts, I, D, O, n_win, kc):
        if in_dims[1] is not None:
            raise ValueError("frac_whole's operator cannot be batched")
        if in_dims[0] is None:
            return _FracWhole.apply(xp, parts, I, D, O, n_win, kc), None
        xb = xp.movedim(in_dims[0], 0)
        B, C = xb.shape[0], xb.shape[1]
        y = _FracWhole.apply(xb.reshape(B * C, xb.shape[2]).contiguous(),
                             parts, I, D, O, n_win, kc)
        return y.reshape(B, C, y.shape[1]), 0


def frac_whole(xp: torch.Tensor, parts: torch.Tensor, I: int, D: int,
               O: int, n_win: int, kc: int = KC) -> torch.Tensor:
    """y [C, n_win*O]: y[c, m*O + j] = xp[c, m*I : m*I + D] . skT[:, j]
    (+ the same dot against skT_lo), for parts = ``operator_parts(skT,
    skT_lo)`` of xp's dtype on xp's device.

    xp: [C, L] with L >= (n_win-1)*I + D and unit stride along time (any
    row stride); kc: terms a float32 big-pair partial sums before its fold,
    ``KC`` or ``KC_LO`` (float64 ignores it).  On a CUDA tensor this
    launches the kernel (counted in ``frac_whole.launches``) or raises; on
    a CPU tensor it is ``frac_whole_ref``.

    Differentiable in xp (torch.autograd, torch.func): the gradient is
    this function on the adjoint geometry (``adjoint_geometry``,
    ``adjoint_parts``), so on a CUDA tensor the backward launches the
    kernel too, counted in ``frac_whole.launches`` and apart in
    ``frac_whole.adjoint_launches``.

    The float32 kernel sums on the tensor cores in their own order, so it
    matches ``frac_whole_ref`` to 2^-21 of max |y| (a few float32 ulps of
    each chunk partial), not bit for bit; float64 matches to 1e-12."""
    _check(xp, parts, I, D, O, n_win, kc)
    return _FracWhole.apply(xp, parts, I, D, O, n_win, kc)


frac_whole.launches = 0
frac_whole.adjoint_launches = 0
