"""Centrosymmetry-folded banded-Toeplitz conv stage: the hand-written CUDA
kernel and its plain PyTorch version.

For every phase j (frame length L_f_j, Hp_j = ceil(L_f_j / 2) fold rows),
frame b and column t < B/2 (B = 256):

    a[l] = xp[c, b*hop + l],  r[l] = xp[c, b*hop + L_f_j - 1 - l]
    z = a + r,  w = a - r
    oe = z . Te_j[:, t],  oo = w . To_j[:, t]
    y[c, (b*B + t)*up + j] = oe + oo,  y[c, (b*B + B-1-t)*up + j] = oe - oo

Under precision "high" oe and oo also get the exact two_sum error of the
fold adds dotted with Te_j / To_j, and z (w) dotted with the row-truncated
operator residual Te_lo (To_lo) over rows [r0, r0 + n).

Counterpart of the reference package's ``ops/pallas_symconv.py``
(``sym_conv_stage_pallas``) together with the XLA assembly that followed
it (``ops/stages.py`` ``_apply_sym_pallas``): the same function, written
straight to the stage's interleaved output order.  ``sym_conv`` launches
``csrc/sym_conv.cu`` on a CUDA tensor and runs ``sym_conv_ref`` on a CPU
tensor.  Both take the operators as ``sym_parts(ops, lo, lo_rows)``, which
the executor builds once.  In float32 both compute the three-slice
bfloat16 split that the kernel runs on the tensor cores, as
``frac_whole`` does (ops/pallas_frac.py), with its lead slices on fixed
grids:

* z and w are formed in float32 (and under "high" their exact fold
  errors z_err, w_err), then split into three bfloat16 slices each
  (``split_grid``): the lead slice z0 rounded to nearest on one grid for
  each frame and 16-row step, 2^(E-8) with 2^E above the step's largest
  |z|, and the float32 remainder (exact) split by the floating rule;
  Te_j and To_j come split the same way, their lead slice on one grid for
  each column and 16-row step, with a fourth slice under "high": bf16 of
  the residual rows at their offsets, zero elsewhere;
* every slice product is exact in float32; the big pair z0*s0 sums in
  ``KC``-term chunks, each folded into (hi, lo) with two_sum; a chunk is
  two 16-term steps, each summed on the tensor cores: all 16 products of
  a step lie on one grid and their sum is under 2^20 of its units, so
  the sum is exact and the tensor cores have nothing to truncate; the
  steps are added in float32; the five small pairs with p+q <= 2, and
  under "high" bf16(z_err)*s0 and z0*s3, sum per chunk into lo;
* the halves combine with one more two_sum, so each output rounds once:
  (s, e) = two_sum(hi_e, +-hi_o), y = s + (e + (lo_e +- lo_o)).

In float64 the operators are ``ops`` as they are and ``sym_conv_ref`` is
the plain contraction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..utils.trace import spanned
from . import _cuda
from .dfloat import two_sum
from .framing import _frames
from .pallas_frac import KC, TILE_K, _swizzle, split_grid

__all__ = ["BH", "TILE_N", "split_grid", "sym_conv", "sym_conv_ref",
           "sym_ops_high", "sym_parts", "unpack_sym"]

#: Columns of each half of a folded block (the reference pins B at 256).
BH = 128
#: Phases a stage may have (the kernel's parameter block).
MAX_PHASES = 8
#: Columns of each half a tile of the packed operator holds: one
#: warpgroup's MMA width, for both operators of a phase.
TILE_N = 32
N_TILES = BH // TILE_N
#: Rows of one k16 step: the lead slices' grids are set per step (the run
#: of ``split_grid``, ops/pallas_frac.py, by default)
STEP = 16

LoRows = Sequence[Tuple[Tuple[int, int], Tuple[int, int]]]


def _sym_slices(ops: torch.Tensor, lo: Optional[torch.Tensor],
                lo_rows: Optional[LoRows]) -> torch.Tensor:
    """[up, 2, P, Hp, BH] float32 slices of Te, To: split_grid along the
    rows (a grid for each column and 16-row step), and under "high" bf16
    of the residual rows at their offsets."""
    s = list(split_grid(ops, dim=2, run=STEP))
    if not torch.equal(s[0].to(torch.bfloat16).float(), s[0]):
        raise AssertionError("a lead slice is not exact in bfloat16")
    if lo is not None:
        s3 = torch.zeros_like(s[0])
        for j, ph in enumerate(lo_rows):
            for i, (r0, n) in enumerate(ph):
                s3[j, i, r0 : r0 + n] = lo[j, i, :n].float().to(
                    torch.bfloat16).float()
        s.append(s3)
    return torch.stack(s, dim=2)


def sym_parts(ops: torch.Tensor, lo: Optional[torch.Tensor] = None,
              lo_rows: Optional[LoRows] = None) -> torch.Tensor:
    """The folded operators in the form ``sym_conv`` takes them; the
    executor builds this once (a buffer).

    ops: [up, 2, Hp_max, 128] (Te_j, To_j; rows past Hp_j zero); lo
    (float32, precision "high"): [up, 2, R, 128] residual row blocks of
    Te_lo, To_lo placed at lo_rows[j] = ((r0_e, n_e), (r0_o, n_o)).

    float64: ops as it is.  float32: bfloat16 [up, N_TILES, Kt, 2, P,
    TILE_N, TILE_K]: per phase, 32-column tile and 64-row k-tile the P
    slices (split_grid along the rows, and under "high" the residual
    slice) of Te, then of To, each [TILE_N, TILE_K] tile K-major and
    128-byte swizzled; one contiguous block per (phase, column tile,
    k-tile), which the kernel copies to shared memory as it lies.  Rows
    past Hp_max are zero."""
    if ops.dim() != 4 or ops.shape[1] != 2 or ops.shape[3] != BH:
        raise ValueError(f"ops must be [up, 2, Hp, {BH}], got "
                         f"{tuple(ops.shape)}")
    if (lo is None) != (lo_rows is None):
        raise ValueError("lo and lo_rows go together")
    if ops.dtype == torch.float64:
        if lo is not None:
            raise TypeError("the residual dots (precision 'high') run in "
                            "float32 only")
        return ops
    if ops.dtype != torch.float32:
        raise TypeError(f"ops must be float32 or float64, got {ops.dtype}")
    up, _, Hp, _ = ops.shape
    if lo is not None:
        if lo.dim() != 4 or lo.shape[:2] != (up, 2) or lo.shape[3] != BH:
            raise ValueError(f"lo must be [{up}, 2, R, {BH}], got "
                             f"{tuple(lo.shape)}")
        if len(lo_rows) != up or any(
                r0 < 0 or not 0 <= n <= lo.shape[2] or r0 + n > Hp
                for ph in lo_rows for r0, n in ph):
            raise ValueError(f"lo_rows must give (r0, n) with 0 <= n <= "
                             f"{lo.shape[2]} and r0 + n <= {Hp} for each of "
                             f"Te_lo, To_lo of each phase, got {lo_rows}")
    s = _sym_slices(ops, lo, lo_rows)
    P = s.shape[2]
    Kt = -(-Hp // TILE_K)
    pad = s.new_zeros((up, 2, P, Kt * TILE_K, BH))
    pad[:, :, :, :Hp] = s
    t = pad.reshape(up, 2, P, Kt, TILE_K, N_TILES, TILE_N)
    t = t.permute(0, 5, 3, 1, 2, 6, 4)  # [up, N_TILES, Kt, 2, P, n, k]
    return _swizzle(t.to(torch.bfloat16).contiguous())


def unpack_sym(parts: torch.Tensor) -> torch.Tensor:
    """[up, 2, P, Kt*TILE_K, 128] float32 slices of a packed sym_parts:
    its inverse (rows padded to whole k-tiles with zeros)."""
    up, nt, Kt, _, P, n, k = parts.shape
    t = _swizzle(parts).float().permute(0, 3, 4, 2, 6, 1, 5)
    return t.reshape(up, 2, P, Kt * k, nt * n)


def _check(xp, parts, L_fs, nb, hop):
    up = len(L_fs)
    if not 1 <= up <= MAX_PHASES:
        raise ValueError(f"need 1..{MAX_PHASES} phases, got {up}")
    if xp.dim() != 2:
        raise ValueError(f"xp must be [C, L], got {tuple(xp.shape)}")
    if xp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"xp must be float32 or float64, got {xp.dtype}")
    if nb < 1 or hop < 1 or hop % (2 * BH):
        raise ValueError(f"need nb >= 1 and hop a positive multiple of "
                         f"{2 * BH} (frames of B = {2 * BH} columns), got "
                         f"{nb}, {hop}")
    if xp.dtype == torch.float64:
        if parts.dtype != torch.float64:
            raise TypeError(f"a float64 xp takes the float64 sym_parts, got "
                            f"{parts.dtype}")
        if parts.dim() != 4 or parts.shape[:2] != (up, 2) \
                or parts.shape[3] != BH:
            raise ValueError(f"parts must be sym_parts of float64 ops "
                             f"[{up}, 2, Hp, {BH}], got "
                             f"{tuple(parts.shape)}")
        rows = parts.shape[2]
    else:
        if parts.dtype != torch.bfloat16:
            raise TypeError(f"a float32 xp takes the packed bfloat16 "
                            f"sym_parts, got {parts.dtype}")
        if parts.dim() != 7 or parts.shape[0] != up \
                or tuple(parts.shape[1:2]) + tuple(parts.shape[3:4]) \
                + tuple(parts.shape[5:]) != (N_TILES, 2, TILE_N, TILE_K) \
                or parts.shape[4] not in (3, 4):
            raise ValueError(f"parts must be sym_parts of [{up}, 2, Hp, "
                             f"{BH}] float32 ops, packed as bfloat16 [{up}, "
                             f"{N_TILES}, Kt, 2, 3 or 4, {TILE_N}, "
                             f"{TILE_K}]; got another tiling "
                             f"{tuple(parts.shape)}")
        rows = parts.shape[2] * TILE_K
    if any(L_f < 1 or (L_f + 1) // 2 > rows for L_f in L_fs):
        raise ValueError(f"frame lengths {tuple(L_fs)} need more than the "
                         f"{rows} operator rows")
    if xp.shape[1] < (nb - 1) * hop + max(L_fs):
        raise ValueError(f"xp has {xp.shape[1]} samples; {nb} frames need "
                         f"{(nb - 1) * hop + max(L_fs)}")


def _split_dot(v: torch.Tensor, S: torch.Tensor,
               v_err: Optional[torch.Tensor]):
    """(hi, lo) of v @ (S[0] + S[1] + S[2] (+ S[3])) in the kernel's split
    arithmetic, v split by ``split_grid`` along its rows.  Per KC-row
    chunk: the big pair v0 @ s0 by 16-row steps, each step's sum exact in
    float32 (checked: its products lie on one grid), the steps added in
    float32, the chunk folded into (hi, lo) with two_sum; the small pairs
    (and the "high" terms bf16(v_err) @ s0 and v0 @ s3) summed in float64,
    rounded once, and added to lo before the fold's error.  The float64
    sums are exact for any terms within 2^37 of each other, so the result
    does not depend on their order."""
    v0, v1, v2 = (t.double() for t in split_grid(v, run=STEP))
    S = S.double()
    pairs = [(v0, S[1] + S[2]), (v1, S[0] + S[1]), (v2, S[0])]
    if v_err is not None:
        pairs += [(v_err.to(torch.bfloat16).double(), S[0]), (v0, S[3])]
    hi = lo = None
    for l0 in range(0, S.shape[1], KC):
        acc = None
        for k0 in range(l0, min(l0 + KC, S.shape[1]), STEP):
            p64 = torch.matmul(v0[..., k0 : k0 + STEP], S[0, k0 : k0 + STEP])
            p = p64.float()
            # exact, but below float32's normal range the grid may be finer
            # than its subnormals
            if not bool(((p.double() == p64)
                         | (p64.abs() < 2.0**-126)).all()):
                raise AssertionError("a big-pair step sum is not exact")
            acc = p if acc is None else acc + p
        c = slice(l0, l0 + KC)
        small = sum(torch.matmul(a[..., c], b[c]) for a, b in pairs).float()
        if hi is None:
            hi, lo = acc, small
        else:
            hi, e = two_sum(hi, acc)
            lo = (lo + small) + e
    return hi, lo


def sym_conv_ref(xp: torch.Tensor, parts: torch.Tensor, L_fs: Sequence[int],
                 nb: int, hop: int) -> torch.Tensor:
    """Plain PyTorch version of ``sym_conv``, on any device (arguments as
    there): in float32 the kernel's split arithmetic on the slices of
    ``parts``, in float64 the plain contraction."""
    _check(xp, parts, L_fs, nb, hop)
    C, up = xp.shape[0], len(L_fs)
    f64 = xp.dtype == torch.float64
    S = parts if f64 else unpack_sym(parts)
    high = not f64 and S.shape[2] == 4
    y = xp.new_empty((C, nb, 2 * BH, up))
    for j, L_f in enumerate(L_fs):
        Hp = (L_f + 1) // 2
        fr = _frames(xp, nb, hop, L_f)
        a, r = fr[..., :Hp], fr.flip(-1)[..., :Hp]
        z, w = a + r, a - r
        if f64:
            oe = torch.matmul(z, S[j, 0, :Hp])
            oo = torch.matmul(w, S[j, 1, :Hp])
            y[:, :, :BH, j] = oe + oo
            y[:, :, BH:, j] = (oe - oo).flip(-1)
            continue
        z_err = w_err = None
        if high:  # the exact errors of the fold adds
            bz = z - a
            z_err = (a - (z - bz)) + (r - bz)
            bv = w - a
            w_err = (a - (w - bv)) - (r + bv)
        he, le = _split_dot(z, S[j, 0, :, :Hp], z_err)
        ho, lo = _split_dot(w, S[j, 1, :, :Hp], w_err)
        s, e = two_sum(he, ho)
        y[:, :, :BH, j] = s + (e + (le + lo))
        s, e = two_sum(he, -ho)
        y[:, :, BH:, j] = (s + (e + (le - lo))).flip(-1)
    return y.reshape(C, nb * 2 * BH * up)


def sym_ops_high(ops: torch.Tensor, lo: torch.Tensor,
                 lo_rows: LoRows) -> torch.Tensor:
    """The float64 operators that precision "high" computes with: ops plus
    the residual rows of lo at lo_rows.  ``sym_conv_ref`` in float64 on
    them, with the input in float64 (the fold then exact), is the function
    that ``sym_conv`` on ``sym_parts(ops, lo, lo_rows)`` approximates."""
    eff = ops.double().clone()
    for j, ph in enumerate(lo_rows):
        for i, (r0, n) in enumerate(ph):
            eff[j, i, r0 : r0 + n] += lo[j, i, :n].double()
    return eff


_F32_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
_F64_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p]


def _launcher(dtype):
    lib = _cuda.load("sym_conv")
    if dtype == torch.float32:
        fn, fn.argtypes = lib.r8b_sym_conv_f32, _F32_ARGS
    else:
        fn, fn.argtypes = lib.r8b_sym_conv_f64, _F64_ARGS
    fn.restype = ctypes.c_int
    return fn


@spanned("r8b.kernel.sym_conv")
def sym_conv(xp: torch.Tensor, parts: torch.Tensor, L_fs: Sequence[int],
             nb: int, hop: int) -> torch.Tensor:
    """y [C, nb*256*up]: every phase of one folded conv stage, in the
    stage's output order y[c, (b*256 + t)*up + j].

    xp: [C, L], L >= (nb-1)*hop + max(L_fs), unit stride along time (any
    row stride), column 0 the phases' common frame origin; parts:
    ``sym_parts(ops, lo, lo_rows)`` of xp's dtype on xp's device; L_fs: the
    phases' frame lengths; hop: a multiple of 256.  On a CUDA tensor this
    launches the kernel (counted in ``sym_conv.launches``) or raises; on a
    CPU tensor it is ``sym_conv_ref``.  It has no gradient: an input that
    autograd or torch.func tracks raises (``_cuda.no_gradient``).

    The float32 kernel sums on the tensor cores in their own order, so it
    matches ``sym_conv_ref`` to a few ulps of max |y|, not bit for bit."""
    _check(xp, parts, L_fs, nb, hop)
    _cuda.no_gradient("sym_conv", xp)
    if xp.device.type == "cpu":
        return sym_conv_ref(xp, parts, L_fs, nb, hop)
    if xp.device.type != "cuda":
        raise RuntimeError(f"sym_conv runs on cuda or cpu, not {xp.device}")
    if parts.device != xp.device or not parts.is_contiguous() \
            or parts.data_ptr() % 16:
        raise ValueError("parts must be contiguous and 16-byte aligned on "
                         "xp's device")
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
            rc = fn(xp.data_ptr(), xp.stride(0), parts.data_ptr(),
                    parts.shape[4], parts.shape[2], y.data_ptr(), C, nb, hop,
                    up, Lf, stream)
        else:
            rc = fn(xp.data_ptr(), xp.stride(0), parts.data_ptr(),
                    y.data_ptr(), C, nb, hop, up, parts.shape[2], Lf, stream)
    if rc != 0:
        raise RuntimeError(f"sym_conv kernel launch failed: CUDA error {rc}")
    sym_conv.launches += 1
    return y


sym_conv.launches = 0
