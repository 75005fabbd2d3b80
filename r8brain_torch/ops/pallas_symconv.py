"""Centrosymmetry-folded banded-Toeplitz conv stage: the hand-written CUDA
kernel and its plain PyTorch version.

For every phase j (frame length L_f_j, Hp_j = ceil(L_f_j / 2) fold rows),
frame b and column t < B/2 (B = 256):

    a[l] = xp[c, b*hop + l],  r[l] = xp[c, b*hop + L_f_j - 1 - l]
    z = a + r,  w = a - r
    oe = z . Te_j[:, t],  oo = w . To_j[:, t]
    y[c, (b*B + t)*up + j] = oe + oo,  y[c, (b*B + B-1-t)*up + j] = oe - oo

Under precision "high" (``lo`` given) oe and oo also get the exact two_sum
error of the fold adds dotted with Te_j / To_j, and z (w) dotted with the
row-truncated operator residual Te_lo (To_lo) over rows [r0, r0 + n).

Counterpart of the reference package's ``ops/pallas_symconv.py``
(``sym_conv_stage_pallas``) together with the XLA assembly that followed
it (``ops/stages.py`` ``_apply_sym_pallas``): the same function, written
straight to the stage's interleaved output order.  ``sym_conv`` launches
``csrc/sym_conv.cu`` on a CUDA tensor and runs ``sym_conv_ref`` on a CPU
tensor.  ``sym_conv_ref`` in float32 is the kernel's accuracy model:
``KC``-term chunks of each dot folded into (hi, lo) with two_sum, and the
two halves combined with one more two_sum; in float64 it is the plain
contraction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _cuda
from .dfloat import two_sum
from .framing import _frames
from .pallas_frac import KC

__all__ = ["BH", "sym_conv", "sym_conv_ref", "sym_ops_high"]

#: Columns of each half of a folded block (the reference pins B at 256).
BH = 128
#: Phases a stage may have (the kernel's parameter block).
MAX_PHASES = 8

LoRows = Sequence[Tuple[Tuple[int, int], Tuple[int, int]]]


def _check(xp, ops, L_fs, nb, hop, lo, lo_rows):
    up = len(L_fs)
    if not 1 <= up <= MAX_PHASES:
        raise ValueError(f"need 1..{MAX_PHASES} phases, got {up}")
    if xp.dim() != 2 or ops.dim() != 4 or ops.shape[:2] != (up, 2) \
            or ops.shape[3] != BH:
        raise ValueError(f"xp must be [C, L] and ops [{up}, 2, Hp, {BH}], "
                         f"got {tuple(xp.shape)} and {tuple(ops.shape)}")
    if xp.dtype not in (torch.float32, torch.float64) or ops.dtype != xp.dtype:
        raise TypeError(f"xp and ops must share float32 or float64, got "
                        f"{xp.dtype} and {ops.dtype}")
    if any(L_f < 1 or (L_f + 1) // 2 > ops.shape[2] for L_f in L_fs):
        raise ValueError(f"frame lengths {tuple(L_fs)} need more than the "
                         f"{ops.shape[2]} operator rows")
    if nb < 1 or hop < 1:
        raise ValueError(f"need nb >= 1 and hop >= 1, got {nb}, {hop}")
    if xp.shape[1] < (nb - 1) * hop + max(L_fs):
        raise ValueError(f"xp has {xp.shape[1]} samples; {nb} frames need "
                         f"{(nb - 1) * hop + max(L_fs)}")
    if (lo is None) != (lo_rows is None):
        raise ValueError("lo and lo_rows go together")
    if lo is not None:
        if xp.dtype != torch.float32:
            raise TypeError("the residual dots (precision 'high') run in "
                            "float32 only")
        if lo.dim() != 4 or lo.shape[:2] != (up, 2) or lo.shape[3] != BH \
                or lo.dtype != xp.dtype:
            raise ValueError(f"lo must be [{up}, 2, R, {BH}] of xp's dtype, "
                             f"got {tuple(lo.shape)}")
        if len(lo_rows) != up or any(
                r0 < 0 or not 0 <= n <= lo.shape[2]
                for ph in lo_rows for r0, n in ph):
            raise ValueError(f"lo_rows must give (r0, n) with 0 <= n <= "
                             f"{lo.shape[2]} for each of Te_lo, To_lo of "
                             f"each phase, got {lo_rows}")


def _folded_dot(v: torch.Tensor, T: torch.Tensor):
    """(hi, lo) of v @ T summed in KC-row chunks folded with two_sum."""
    hi = lo = None
    for l0 in range(0, T.shape[0], KC):
        acc = torch.matmul(v[..., l0 : l0 + KC], T[l0 : l0 + KC])
        if hi is None:
            hi, lo = acc, torch.zeros_like(acc)
        else:
            hi, e = two_sum(hi, acc)
            lo = lo + e
    return hi, lo


def sym_conv_ref(xp: torch.Tensor, ops: torch.Tensor, L_fs: Sequence[int],
                 nb: int, hop: int, lo: Optional[torch.Tensor] = None,
                 lo_rows: Optional[LoRows] = None) -> torch.Tensor:
    """Plain PyTorch version of ``sym_conv``, on any device (arguments as
    there)."""
    _check(xp, ops, L_fs, nb, hop, lo, lo_rows)
    C, up = xp.shape[0], len(L_fs)
    y = xp.new_empty((C, nb, 2 * BH, up))
    for j, L_f in enumerate(L_fs):
        Hp = (L_f + 1) // 2
        fr = _frames(xp, nb, hop, L_f)
        a, r = fr[..., :Hp], fr.flip(-1)[..., :Hp]
        z, w = a + r, a - r
        Te, To = ops[j, 0, :Hp], ops[j, 1, :Hp]
        if xp.dtype == torch.float64:
            oe, oo = torch.matmul(z, Te), torch.matmul(w, To)
            y[:, :, :BH, j] = oe + oo
            y[:, :, BH:, j] = (oe - oo).flip(-1)
            continue
        (he, le), (ho, lo_o) = _folded_dot(z, Te), _folded_dot(w, To)
        tp, tm = le + lo_o, le - lo_o
        if lo is not None:
            # the exact fold errors, and the residual operator's rows
            bz = z - a
            z_err = (a - (z - bz)) + (r - bz)
            bv = w - a
            w_err = (a - (w - bv)) - (r + bv)
            (r0e, ne), (r0o, no) = lo_rows[j]
            re = torch.matmul(z_err, Te) + torch.matmul(
                z[..., r0e : r0e + ne], lo[j, 0, :ne])
            ro = torch.matmul(w_err, To) + torch.matmul(
                w[..., r0o : r0o + no], lo[j, 1, :no])
            tp, tm = tp + (re + ro), tm + (re - ro)
        s, e = two_sum(he, ho)
        y[:, :, :BH, j] = s + (e + tp)
        s, e = two_sum(he, -ho)
        y[:, :, BH:, j] = (s + (e + tm)).flip(-1)
    return y.reshape(C, nb * 2 * BH * up)


def sym_ops_high(ops: torch.Tensor, lo: torch.Tensor,
                 lo_rows: LoRows) -> torch.Tensor:
    """The float64 operators that precision "high" computes with: ops plus
    the residual rows of lo at lo_rows.  ``sym_conv_ref`` in float64 on
    them, with the input in float64 (the fold then exact), is the function
    that ``sym_conv(..., lo, lo_rows)`` approximates."""
    eff = ops.double().clone()
    for j, ph in enumerate(lo_rows):
        for i, (r0, n) in enumerate(ph):
            eff[j, i, r0 : r0 + n] += lo[j, i, :n].double()
    return eff


def _launcher(dtype):
    lib = _cuda.load("sym_conv")
    vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    if dtype == torch.float32:
        fn = lib.r8b_sym_conv_f32
        fn.argtypes = [vp, ctypes.c_longlong, vp, vp, vp, i, i, i, i, i, i,
                       ip, ip, vp]
    else:
        fn = lib.r8b_sym_conv_f64
        fn.argtypes = [vp, ctypes.c_longlong, vp, vp, i, i, i, i, i, ip, vp]
    fn.restype = ctypes.c_int
    return fn


def sym_conv(xp: torch.Tensor, ops: torch.Tensor, L_fs: Sequence[int],
             nb: int, hop: int, lo: Optional[torch.Tensor] = None,
             lo_rows: Optional[LoRows] = None) -> torch.Tensor:
    """y [C, nb*256*up]: every phase of one folded conv stage, in the
    stage's output order y[c, (b*256 + t)*up + j].

    xp: [C, L], L >= (nb-1)*hop + max(L_fs), unit stride along time (any
    row stride), column 0 the phases' common frame origin; ops: contiguous
    [up, 2, Hp_max, 128], ops[j, 0] = Te_j and ops[j, 1] = To_j (rows past
    Hp_j unread); L_fs: the phases' frame lengths; lo (float32, precision
    "high"): contiguous [up, 2, R, 128] residual row blocks of Te_lo, To_lo,
    placed at lo_rows[j] = ((r0_e, n_e), (r0_o, n_o)).  On a CUDA tensor
    this launches the kernel (counted in ``sym_conv.launches``) or raises;
    on a CPU tensor it is ``sym_conv_ref``."""
    _check(xp, ops, L_fs, nb, hop, lo, lo_rows)
    if xp.device.type == "cpu":
        return sym_conv_ref(xp, ops, L_fs, nb, hop, lo, lo_rows)
    if xp.device.type != "cuda":
        raise RuntimeError(f"sym_conv runs on cuda or cpu, not {xp.device}")
    mats = [ops] if lo is None else [ops, lo]
    if any(t.device != xp.device or not t.is_contiguous()
           or t.data_ptr() % 16 for t in mats):
        raise ValueError("ops and lo must be contiguous and 16-byte aligned "
                         "on xp's device")
    if xp.stride(1) != 1:
        raise ValueError("xp must have unit stride along time")
    C, up = xp.shape[0], len(L_fs)
    y = torch.empty((C, nb * 2 * BH * up), dtype=xp.dtype, device=xp.device)
    if C == 0:
        return y
    fn = _launcher(xp.dtype)
    Lf = (ctypes.c_int * up)(*L_fs)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        if xp.dtype == torch.float32:
            rows = None
            if lo is not None:
                rows = (ctypes.c_int * (4 * up))(
                    *[v for ph in lo_rows for r0n in ph for v in r0n])
            rc = fn(xp.data_ptr(), xp.stride(0), ops.data_ptr(),
                    None if lo is None else lo.data_ptr(), y.data_ptr(), C,
                    nb, hop, up, ops.shape[2],
                    0 if lo is None else lo.shape[2], Lf, rows, stream)
        else:
            rc = fn(xp.data_ptr(), xp.stride(0), ops.data_ptr(), y.data_ptr(),
                    C, nb, hop, up, ops.shape[2], Lf, stream)
    if rc != 0:
        raise RuntimeError(f"sym_conv kernel launch failed: CUDA error {rc}")
    sym_conv.launches += 1
    return y


sym_conv.launches = 0
