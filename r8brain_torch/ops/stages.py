"""Stage executors and the helpers they share.

Counterparts of the reference package's ``ops/stages.py``.  Each planned
stage gets a batched executor: ``apply(x[C, N]) -> y[C, M]`` with
M = stage_out_len(spec, N), plus the two seam protocols of the chain:

* ``apply_v(x, n_valid)``: the valid-prefix protocol.
  ``x[:, :n_valid]`` is the logical input and columns beyond it are a
  previous stage's raw framing surplus; returns ``(buf, m)`` with the
  logical output in ``buf[:, :m]``.  For every kept output the banded
  operator reads only the valid prefix, so the surplus never reaches the
  result.
* ``apply_df(h, l, n_valid, emit_pair)``: the df32 inter-stage carry of
  the guarantee chain.  Stages hand raw (hi float32, lo bfloat16) pair
  buffers plus the logical count across the seams, so the per-seam
  float32 store rounding never happens; only the chain's last output
  rounds.  Returns ``(h, l, n_out)``.

Ported: every stage kind the planner makes.

* ``ConvExec``: the float32 matmul engines ``toeplitz`` (the banded
  operator on ``frac_whole``, ops/pallas_frac.py), ``toeplitz_sym`` (the
  folded operators on ``sym_conv``, ops/pallas_symconv.py), ``pallas``
  (the B=64 mini-Toeplitz on ``frac_whole``) and ``direct`` (the
  superkernel's strided product on ``frac_whole``); the ozaki (error-free
  split-operand) engine on ``ozaki_framed`` (ops/pallas_ozaki.py); the
  df32-FFT guarantee
  engines ``pallas_fft5``, ``pallas_fft4``, ``pallas_fft`` and, under
  ``precision="high"``, ``fft`` on ``df_fft_conv`` (ops/pallas_dfft.py),
  the FP64 overlap-save kernel; ``fft`` otherwise is ``torch.fft.rfft`` in
  float32 (hi + lo spectrum) or float64.  Each keeps the reference's
  geometry.
* ``FracWholeExec``: the ozaki engine, and the ``im2col``, ``pallas`` and
  ``conv`` engines, all one contraction on ``frac_whole`` (with the
  float32 operator residual and 16-term folds under ``precision="high"``).
* ``HBUpExec``, ``HBDownExec``: the half-band stages, one framed product
  on ``frac_whole`` (float32) or ``ozaki_framed`` (the guarantee chain),
  or the oracle's stencil (float64).  Runs of two or more half-band
  upsamplers fuse into one product (ops/hb_cascade.py).
* ``FracPolyExec``: polynomial mode, a banded batched product against
  operators built from host-side float64 positions (IEEE float32, or the
  error-free split form under frac_engine="ozaki"), or a per-tap gather
  in float64.

Each kernel wrapper runs the CUDA kernel on a CUDA tensor and its plain
version on a CPU tensor.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.lengths import frac_positions, stage_out_len
from ..models.plan import ConvStage, FracStage, HBDownStage, HBUpStage
from ..utils.trace import trace
from .dfloat import two_sum
from .ozaki import (K0, N_DIAG, N_PARTS, channel_scale, framed_cheap,
                    split_input, split_operator_batched,
                    split_operator_host)
from .pallas_dfft import (DfFFTPlan, df_fft_conv, framed_supported,
                          supported_n)
from .pallas_frac import KC, KC_LO, frac_whole, operator_parts
from .pallas_ozaki import ozaki_framed, pack_operator
from .pallas_symconv import BH, sym_conv, sym_parts

__all__ = ["truncate_residual", "ConvExec", "FracWholeExec", "HBUpExec",
           "HBDownExec", "FracPolyExec", "chunk_drift_groups",
           "banded_contract", "banded_contract_ozaki", "place_operator",
           "poly_operators", "poly_contract", "build_exec",
           "FFT_ENGINES", "MATMUL_ENGINES"]

#: ConvExec's FFT engines: df_fft_conv under precision "high".
FFT_ENGINES = ("fft", "pallas_fft", "pallas_fft4", "pallas_fft5")
#: ConvExec's engines on the polyphase superkernel (float32 or float64).
MATMUL_ENGINES = ("toeplitz", "toeplitz_sym", "pallas", "direct")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


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


def _check_ozaki(dtype, precision):
    if dtype != torch.float32:
        raise NotImplementedError(
            f"the ozaki engine runs in float32 only (got {dtype}); float64 "
            f"runs conv_engine='fft'")
    _check_precision(precision)


def _check_precision(precision):
    if precision not in ("fast", "high"):
        raise ValueError(f"precision must be 'fast' or 'high', got "
                         f"{precision!r}")


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")


def _banded(sk: np.ndarray, B: int, down: int) -> np.ndarray:
    """The banded Toeplitz operator of B cycles of a polyphase superkernel
    sk [up, D]: T[t*down + d, t*up + j] = sk[j, d], [(B-1)*down + D, B*up]."""
    up, D = sk.shape
    T = np.zeros(((B - 1) * down + D, B * up), dtype=np.float64)
    for t in range(B):
        T[t * down : t * down + D, t * up : (t + 1) * up] = sk.T
    return T


def _placed(rows: np.ndarray, r0: int, n_rows: int) -> torch.Tensor:
    """A row-truncated residual (rows from r0) placed in a zero operator
    of n_rows rows."""
    out = np.zeros((n_rows, rows.shape[1]), dtype=rows.dtype)
    out[r0 : r0 + rows.shape[0]] = rows
    return torch.from_numpy(out)


def _shifted(x: torch.Tensor, start: int, need: int, dtype) -> torch.Tensor:
    """[C, >= need] tensor of ``dtype`` whose column 0 is x's column
    ``start`` (zeros outside x): one padded copy, or a view of x when x
    already covers [start, start + need)."""
    pad_l = max(0, -start)
    pad_r = max(0, need + start - x.shape[1])
    x = x.to(dtype)
    if pad_l or pad_r:
        x = F.pad(x, (pad_l, pad_r))
    return x[:, start + pad_l :]


def _register_ozaki(ex: nn.Module, parts: torch.Tensor) -> None:
    """The ozaki engine's operator as buffers of ``ex``: the slices
    ``oz_parts`` (the plain version's) and their packing for the kernel,
    ``oz_tiles`` and ``oz_bands`` (``pack_operator``), built once."""
    ex.register_buffer("oz_parts", parts)
    tiles, bands = pack_operator(parts)
    ex.register_buffer("oz_tiles", tiles)
    ex.register_buffer("oz_bands", bands)


class ConvExec(nn.Module):
    """Convolver with integer up/down resampling.

    Content semantics (the oracle's): u = zero-stuffed input, w = kernel
    (*) u (causal), y[r] = w[r*down + offset], r in [0, M).

    The polyphase superkernel SK[j, d] = k[(j*down + off) - (s_min+d)*up]
    makes y[m*up + j] = sum_d SK[j, d] * x[m*down + s_min + d].

    Engines:
      * "toeplitz" (float32's "auto"): B cycles form one banded Toeplitz
        operator [L_f, B*up] (B = 256, halved while B*down > 2*D),
        applied at hop B*down on ``frac_whole`` with 32-term folds; under
        ``precision="high"`` the row-truncated float32 residual of the
        operator rides the same call (``skT_lo``).
      * "toeplitz_sym": for a symmetric kernel each phase's operator is
        centrosymmetric and folds into Te, To of half the rows and columns
        (``sym_conv``: half the products); under "high" with the fold-error
        compensation and the operators' residual rows.  A kernel that is
        not symmetric, or a phase row that is not a palindrome (min-phase
        kernels), falls back to "toeplitz", visibly (the
        ``conv_toeplitz_sym_fallback`` trace).
      * "pallas": the mini-Toeplitz of B=64 cycles on ``frac_whole`` (the
        full operator residual under "high").  The reference falls back to
        "toeplitz" where its channel tiles do not fit the TPU;
        ``frac_whole`` has no channel tiles, so this engine never falls
        back.
      * "direct": the strided product of x with SK itself (no band), on
        ``frac_whole`` at I = down, D = D_direct, O = up with 32-term folds
        and, under "high", the residual ``skT_direct_lo`` and 16-term
        folds.  The reference ran an XLA convolution; cuDNN's float32
        ``F.conv1d`` sums the taps without folds and misses the -141 dB
        class (chip_smoke.py prints both on the card; PERF.md).
      * "ozaki": the toeplitz engine's operator in the error-free split
        form on ``ozaki_framed``.
      * "pallas_fft5", "pallas_fft4", "pallas_fft": overlap-save at nfft =
        hop + P on ``df_fft_conv`` (the f64 convolution rounded to
        float32).  ``pallas_fft5`` keeps the reference's geometry: the
        polyphase fold for up = 2 (``framed5_poly``: the unstuffed signal
        against k_even and k_odd at nx, head nx/4), the framed mode (hop
        3n/4, head n/4) where ``framed_supported``, and its rename to
        ``pallas_fft4`` where ``supported_n`` fails.
      * "fft": under ``precision="high"`` the same kernel at nfft, head
        P (the reference's XLA df32 FFT, which computes the same function:
        the float64 convolution rounded to float32); ``torch.fft.rfft``
        otherwise.
      * "auto": "toeplitz" in float32, "fft" in float64.
    """

    def __init__(self, spec: ConvStage, dtype=torch.float32,
                 precision: str = "fast", B: int = 256,
                 engine: str = "auto"):
        super().__init__()
        if engine == "auto":
            engine = "fft" if dtype == torch.float64 else "toeplitz"
        if engine not in ("ozaki", *FFT_ENGINES, *MATMUL_ENGINES):
            raise ValueError(f"unknown conv engine {engine!r}")
        self.spec = spec
        self.dtype = dtype
        self.engine = engine
        #: terms a frac_whole big-pair partial sums before its fold, on
        #: the "toeplitz" and "pallas" engines (a long chain asks KC_LO:
        #: models/resampler.py LONG_CHAIN, HB_TAIL)
        self.kc = KC
        self.framed5 = self.framed5_poly = False
        k = np.asarray(spec.filt.kernel, dtype=np.float64)
        self.K = k.shape[0]
        if engine in FFT_ENGINES:
            self._build_fft(k, precision)
            return
        if engine == "ozaki":
            _check_ozaki(dtype, precision)
        _check_dtype(dtype)
        _check_precision(precision)
        self.precision = precision if dtype == torch.float32 else "fast"
        self._build_direct(k)
        if engine == "ozaki":
            self._build_ozaki(B)
        elif engine == "toeplitz":
            self._build_toeplitz(B)
        elif engine == "toeplitz_sym":
            if not self._build_toeplitz_sym():
                trace("conv_toeplitz_sym_fallback", K=self.K, up=spec.up,
                      down=spec.down)
                self.engine = "toeplitz"
                self._build_toeplitz(B)
        elif engine == "pallas":
            self._build_pallas()

    def _build_fft(self, k: np.ndarray, precision: str, ext: int = 2):
        """The reference's FFT geometry (its ConvExec.__init__): nfft =
        max(128, next_pow2(P) << ext), doubled while the saved overlap P
        exceeds the hop; the engines' plans and spectra."""
        spec, engine = self.spec, self.engine
        _check_dtype(self.dtype)
        _check_precision(precision)
        if engine != "fft":
            if self.dtype != torch.float32:
                raise ValueError(f"conv_engine={engine!r} takes float32; "
                                 f"float64 runs conv_engine='fft'")
            precision = "high"
        elif self.dtype != torch.float32:
            precision = "fast"
        self.precision = precision
        P = self.K - 1
        nfft = max(128, _next_pow2(max(1, P)) << ext)
        while nfft - P < P:
            nfft *= 2
        self.nfft, self.hop = nfft, nfft - P
        if precision == "high":
            Hfull = np.fft.fft(k, n=nfft) / nfft
            if engine == "pallas_fft5":
                if spec.up == 2:
                    # polyphase fold: the stuffed up=2 convolution is two
                    # convolutions of the unstuffed input with k_even and
                    # k_odd, one forward transform at half the size
                    ke, ko = k[0::2], k[1::2]
                    Px = max(ke.shape[0], ko.shape[0]) - 1
                    nx = max(4096, _next_pow2(max(1, Px)) << ext)
                    while Px > nx // 4:
                        nx *= 2
                    if framed_supported(nx):
                        self.dfft_plan = DfFFTPlan(
                            nx, np.fft.fft(ke, n=nx) / nx,
                            np.fft.fft(ko, n=nx) / nx)
                        self.framed5_poly = True
                        return
                if supported_n(nfft):
                    # overlap-save at hop 3n/4, head n/4 >= P
                    self.framed5 = framed_supported(nfft) and P <= nfft // 4
                    if self.framed5:
                        self.hop = 3 * nfft // 4
                else:
                    trace("conv_pallas_fft5_fallback", nfft=nfft)
                    self.engine = "pallas_fft4"
            self.dfft_plan = DfFFTPlan(nfft, Hfull)
        else:
            Hf = np.fft.rfft(k, n=nfft)
            if self.dtype == torch.float32:
                hi = Hf.astype(np.complex64)
                lo = (Hf - hi.astype(np.complex128)).astype(np.complex64)
                self.register_buffer("H_hi", torch.from_numpy(hi))
                self.register_buffer("H_lo", torch.from_numpy(lo))
            else:
                self.register_buffer("H_hi", torch.from_numpy(Hf))
                self.register_buffer("H_lo", None)

    def _build_direct(self, k: np.ndarray):
        """Polyphase superkernel: SK[j, d] = k[(j*down + off) - (s_min+d)*up]
        so that y[m*up + j] = sum_d SK[j, d] * x[m*down + s_min + d];
        ``skT_direct`` = SK.T in the stage's dtype and, under "high", its
        float32 residual ``skT_direct_lo`` (the reference's sk_direct and
        sk_lo, transposed)."""
        spec = self.spec
        up, down, off = spec.up, spec.down, spec.offset
        K = self.K
        s_los = [-(-(j * down + off - K + 1) // up) for j in range(up)]
        s_his = [(j * down + off) // up for j in range(up)]
        s_min = min(s_los)
        D = max(s_his) - s_min + 1
        sk = np.zeros((up, D), dtype=np.float64)
        for j in range(up):
            tj = j * down + off
            for d in range(D):
                kidx = tj - (s_min + d) * up
                if 0 <= kidx < K:
                    sk[j, d] = k[kidx]
        self._sk64 = sk
        self.s_min = s_min
        self.D_direct = D
        self.register_buffer("skT_direct", torch.from_numpy(
            np.ascontiguousarray(sk.T.astype(self._np_dtype()))))
        lo = None
        if self.precision == "high":
            lo = torch.from_numpy(np.ascontiguousarray((sk - sk.astype(
                np.float32).astype(np.float64)).astype(np.float32).T))
        self.register_buffer("skT_direct_lo", lo)
        self.register_buffer("skT_direct_parts", operator_parts(
            self.skT_direct, lo) if self.engine == "direct" else None)

    def _np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def _build_toeplitz(self, B: int = 256):
        """The banded Toeplitz operator (the reference's _build_toeplitz):

            y[(b*B + t)*up + j] = frames[b] . T[:, t*up + j]
            frames[b, l] = x[b*B*down + s_min + l],  l < (B-1)*down + D
            T[t*down + d, t*up + j] = SK[j, d]

        built from the float64 superkernel over all D taps (the
        reference's single chunk) and its truncated residual ``toep_lo`` =
        (r0, rows) under "high"."""
        down = self.spec.down
        D = self.D_direct
        while B * down > 2 * D and B > 128:
            B //= 2
        np_dt = self._np_dtype()
        T = _banded(self._sk64, B, down)
        Thi = T.astype(np_dt)
        Tlo = None
        if self.precision == "high":
            Tlo = truncate_residual(
                (T - Thi.astype(np.float64)).astype(np_dt),
                float(np.abs(Thi).max()))
        self.toep_lo = Tlo
        self.B_toep = B
        self.register_buffer("T_toep", torch.from_numpy(Thi))
        self.register_buffer("T_toep_lo", None if Tlo is None else
                             _placed(Tlo[1], Tlo[0], T.shape[0]))
        self.register_buffer("T_toep_parts",
                             operator_parts(self.T_toep, self.T_toep_lo))

    def _build_toeplitz_sym(self) -> bool:
        """Centrosymmetry-folded operators (the reference's
        _build_toeplitz_sym, bit for bit): per phase j the superkernel row
        of a symmetric kernel is a palindrome, its banded operator T is
        centrosymmetric, and with z = fr + flip(fr), w = fr - flip(fr)

            y[t] + y[B-1-t] = 2 z[:Hp] . Te,   Te = (T[:H] + flip(T[H:])) / 2
            y[t] - y[B-1-t] = 2 w[:Hp] . To,   To = (T[:H] - flip(T[H:])) / 2

        so two (Hp x B/2) products replace one (L_f x B).  Each phase row
        is padded symmetrically to the common origin ``sym_dmin``.  B is
        pinned at 256 (sym_conv's blocks).  Returns False (the caller
        falls back to the plain operator) when the kernel is not
        bit-symmetric or a phase row is not a palindrome."""
        spec = self.spec
        up, down = spec.up, spec.down
        k = np.asarray(spec.filt.kernel, dtype=np.float64)
        if not np.array_equal(k, k[::-1]):
            return False
        sk64 = self._sk64
        phases = []
        for j in range(up):
            nz = np.nonzero(sk64[j])[0]
            if nz.size == 0:
                return False
            dlo, dhi = int(nz.min()), int(nz.max())
            row = sk64[j, dlo : dhi + 1]
            if not np.array_equal(row, row[::-1]):
                return False
            phases.append((dlo, row))
        dmin = min(dlo for dlo, _ in phases)
        phases = [(dmin, np.pad(row, (dlo - dmin, dlo - dmin)))
                  for dlo, row in phases]
        np_dt = self._np_dtype()
        self.B_sym = B = 2 * BH
        self.sym_dmin = dmin
        self.sym_comp = self.precision == "high"
        self.toep_sym = []
        for dlo, row in phases:
            Dj = row.shape[0]
            L_f = (B - 1) * down + Dj
            T = np.zeros((L_f, B), dtype=np.float64)
            for t in range(B):
                T[t * down : t * down + Dj, t] = row
            H = L_f // 2
            Hp = (L_f + 1) // 2
            Bh = B // 2
            Te = np.zeros((Hp, Bh), dtype=np.float64)
            To = np.zeros((Hp, Bh), dtype=np.float64)
            Te[:H] = 0.5 * (T[:H, :Bh] + T[L_f - 1 : L_f - 1 - H : -1, :Bh])
            To[:H] = 0.5 * (T[:H, :Bh] - T[L_f - 1 : L_f - 1 - H : -1, :Bh])
            if L_f % 2:
                Te[Hp - 1] = 0.5 * T[Hp - 1, :Bh]
            Te_hi = Te.astype(np_dt)
            To_hi = To.astype(np_dt)
            Te_lo = To_lo = None
            if self.precision == "high":
                scale = float(max(np.abs(Te_hi).max(), np.abs(To_hi).max()))

                def _aligned(tr):
                    # the reference's 128-aligned residual row range
                    r0, rows = tr
                    if rows.shape[0] == 0:
                        return tr
                    r1 = r0 + rows.shape[0]
                    r0a = (r0 // 128) * 128
                    r1a = min(Hp, -(-r1 // 128) * 128)
                    out = np.zeros((r1a - r0a, rows.shape[1]), rows.dtype)
                    out[r0 - r0a : r1 - r0a] = rows
                    return (r0a, out)

                Te_lo = _aligned(truncate_residual(
                    (Te - Te_hi.astype(np.float64)).astype(np_dt), scale))
                To_lo = _aligned(truncate_residual(
                    (To - To_hi.astype(np.float64)).astype(np_dt), scale))
            self.toep_sym.append(dict(dlo=dlo, L_f=L_f, Hp=Hp, Te=Te_hi,
                                      To=To_hi, Te_lo=Te_lo, To_lo=To_lo))
        self._pack_sym()
        return True

    def _pack_sym(self):
        """``sym_conv``'s operands: ``sym_ops`` [up, 2, Hp_max, 128] (Te,
        To of each phase, zero rows past its Hp), under "high" ``sym_lo``
        [up, 2, R, 128] with the row blocks of Te_lo, To_lo at
        ``sym_lo_rows``, and ``sym_parts``, their packing as the kernel
        takes it (``sym_parts``: float32 bf16 slices, a fourth under
        "high")."""
        ph = self.toep_sym
        np_dt = self._np_dtype()
        ops = np.zeros((len(ph), 2, max(p["Hp"] for p in ph), BH), np_dt)
        for j, p in enumerate(ph):
            ops[j, 0, : p["Hp"]], ops[j, 1, : p["Hp"]] = p["Te"], p["To"]
        self.sym_Lf = tuple(p["L_f"] for p in ph)
        self.register_buffer("sym_ops", torch.from_numpy(ops))
        self.sym_lo_rows = lo = None
        if self.precision == "high":
            blocks = [(p["Te_lo"], p["To_lo"]) for p in ph]
            R = max(1, max(b[1].shape[0] for bb in blocks for b in bb))
            lo = np.zeros((len(ph), 2, R, BH), np_dt)
            for j, bb in enumerate(blocks):
                for i, (_r0, rows) in enumerate(bb):
                    lo[j, i, : rows.shape[0]] = rows
            self.sym_lo_rows = tuple(
                tuple((r0, rows.shape[0]) for r0, rows in bb)
                for bb in blocks)
            lo = torch.from_numpy(lo)
        self.register_buffer("sym_lo", lo)
        self.register_buffer("sym_parts", sym_parts(
            self.sym_ops, self.sym_lo, self.sym_lo_rows).clone())

    def _build_pallas(self, B: int = 64):
        """The mini-Toeplitz of B=64 cycles (the reference's
        _build_pallas): band waste (B*down + D)/D ~ 1.1x; ``T_pallas`` and,
        under "high", the full residual ``T_pallas_lo`` in float32 as the
        reference keeps them (float64 stages use the float64 operator)."""
        up, down = self.spec.up, self.spec.down
        T = _banded(self._sk64, B, down)
        self.T_pallas = T.astype(np.float32)
        self.T_pallas_lo = (
            (T - self.T_pallas.astype(np.float64)).astype(np.float32)
            if self.precision == "high" else None)
        self.B_pallas = B
        self.Lf_pallas = T.shape[0]
        self.register_buffer("T_pal", torch.from_numpy(
            self.T_pallas if self.dtype == torch.float32 else T))
        self.register_buffer("T_pal_lo", None if self.T_pallas_lo is None
                             else torch.from_numpy(self.T_pallas_lo))
        self.register_buffer("T_pal_parts",
                             operator_parts(self.T_pal, self.T_pal_lo))

    def _build_ozaki(self, B: int):
        """Split form of the banded-Toeplitz operator (ops/ozaki.py): the
        block count B halves while B*down > 2*D, down to 128."""
        down = self.spec.down
        D = self.D_direct
        while B * down > 2 * D and B > 128:
            B //= 2
        T = _banded(self._sk64, B, down)
        parts, self.oz_scale = split_operator_host(T)
        _register_ozaki(self, parts)
        self.oz_Lf = T.shape[0]
        self.B_toep = B

    @property
    def oz_packed(self):
        """The ozaki engine's operator as the kernel takes it."""
        return self.oz_tiles, self.oz_bands

    def geometry(self, M: int):
        """(L_f, hop, Kcols, n_blocks) of the framed product behind M
        outputs: blocks of B_toep cycles, each cycle ``up`` outputs."""
        B, up = self.B_toep, self.spec.up
        n_blocks = -(-(-(-M // up)) // B)
        return self.oz_Lf, B * self.spec.down, B * up, n_blocks

    def _apply_ozaki(self, x: torch.Tensor, M: int, raw: bool = False,
                     x_lo=None, pair: bool = False):
        L_f, hop, Kcols, n_blocks = self.geometry(M)
        need = (n_blocks - (-L_f // hop)) * hop
        xp = _shifted(x, self.s_min, need, torch.float32)
        xl = None
        if x_lo is not None:  # bf16 seam-residual stream: keep its dtype
            xl = _shifted(x_lo, self.s_min, need, x_lo.dtype)
        sx = channel_scale(xp[:, : (n_blocks - 1) * hop + L_f])
        res = ozaki_framed(xp, sx, self.oz_parts, L_f, hop, Kcols, n_blocks,
                           x_lo=xl, emit_pair=pair, packed=self.oz_packed)
        if pair:
            yh, yl = res
            return (yh, yl) if raw else (yh[:, :M], yl[:, :M])
        return res if raw else res[:, :M]

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

    def _apply_fft(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The FFT engines (the reference's ConvExec.apply): the stuffed
        convolution stream w at positions [0, t_needed), then y[r] =
        w[r*down + off]."""
        spec = self.spec
        up, down, off = spec.up, spec.down, spec.offset
        C, N = x.shape
        P, hop, nfft = self.K - 1, self.hop, self.nfft
        t_needed = (M - 1) * down + off + 1
        pick = slice(off, off + (M - 1) * down + 1, down)
        if self.framed5_poly:
            # the unstuffed signal against k_even / k_odd, interleaved
            plan = self.dfft_plan
            head = plan.n // 4
            n_frames = -(-((t_needed + 1) // 2) // (plan.n - head))
            w = df_fft_conv(F.pad(x.float(), (head, 0)), plan, n_frames, head)
            return w[:, pick]
        if up > 1:
            u = x.new_zeros((C, N * up), dtype=self.dtype)
            u[:, ::up] = x
        else:
            u = x.to(self.dtype)
        n_frames = -(-t_needed // hop)
        if self.precision == "high":
            # frames read straight from the padded signal: framed5's head
            # n/4, else the overlap P (the reference's frame tensor)
            head = nfft // 4 if self.framed5 else P
            w = df_fft_conv(F.pad(u.float(), (head, 0)), self.dfft_plan,
                            n_frames, head)
            return w[:, pick]
        # u_p = [zeros(P), u, zeros(pad_r)] of length (n_frames + 1) * hop
        total = (n_frames + 1) * hop
        pad_r = total - P - u.shape[1]
        if pad_r < 0:
            u = u[:, : u.shape[1] + pad_r]
            pad_r = 0
        chunks = F.pad(u, (P, pad_r)).reshape(C, n_frames + 1, hop)
        frames = torch.cat([chunks[:, :n_frames, :], chunks[:, 1:, :P]],
                           dim=-1)
        X = torch.fft.rfft(frames, dim=-1)
        Y = X * self.H_hi
        if self.H_lo is not None:
            Y = Y + X * self.H_lo
        W = torch.fft.irfft(Y, n=nfft, dim=-1).to(self.dtype)
        return W[:, :, P:].reshape(C, n_frames * hop)[:, pick]

    def _apply_toeplitz(self, x: torch.Tensor, M: int,
                        raw: bool = False) -> torch.Tensor:
        """The banded operator on frac_whole: I = hop = B*down, D = L_f, O
        = B*up, one window a block; the output [C, n_blocks*B*up] is in
        the stage's order.  ``raw`` returns every block's columns."""
        up, down, B = self.spec.up, self.spec.down, self.B_toep
        L_f = self.T_toep.shape[0]
        n_blocks = -(-(-(-M // up)) // B)
        hop = B * down
        xp = _shifted(x, self.s_min, (n_blocks - (-L_f // hop)) * hop,
                      self.dtype)
        y = frac_whole(xp, self.T_toep_parts, hop, L_f, B * up, n_blocks,
                       kc=self.kc)
        return y if raw else y[:, :M]

    def _apply_toeplitz_sym(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The folded operators on sym_conv, every phase in one launch:
        frames of hop B*down from the common origin s_min + dmin."""
        up, down, B = self.spec.up, self.spec.down, self.B_sym
        nb = -(-(-(-M // up)) // B)
        hop = B * down
        xp = _shifted(x, self.s_min + self.sym_dmin,
                      (nb - 1) * hop + max(self.sym_Lf), self.dtype)
        return sym_conv(xp, self.sym_parts, self.sym_Lf, nb, hop)[:, :M]

    def _apply_pallas(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The mini-Toeplitz on frac_whole: I = 64*down, D = L_f, O =
        64*up."""
        up, down, B = self.spec.up, self.spec.down, self.B_pallas
        n_grp = -(-(-(-M // up)) // B)
        L_f = self.Lf_pallas
        xp = _shifted(x, self.s_min, (n_grp - 1) * B * down + L_f, self.dtype)
        return frac_whole(xp, self.T_pal_parts, B * down, L_f, B * up, n_grp,
                          kc=self.kc)[:, :M]

    def _apply_direct(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The superkernel's strided product on frac_whole: I = down, D =
        D_direct, O = up, one window a cycle; under "high" with 16-term
        folds, the counterpart of the reference's compensated 128-tap
        chunks (tests/test_torch_stage_chain.py holds the chain at
        -141 dB)."""
        up, down, D = self.spec.up, self.spec.down, self.D_direct
        n_cyc = -(-M // up)
        lo = self.skT_direct_lo
        xp = _shifted(x, self.s_min, (n_cyc - 1) * down + D, self.dtype)
        return frac_whole(xp, self.skT_direct_parts, down, D, up, n_cyc,
                          kc=KC if lo is None else KC_LO)[:, :M]

    def apply_v(self, x: torch.Tensor, n_valid: int):
        M = self.out_len(n_valid)
        if M > 0 and self.engine == "toeplitz":
            return self._apply_toeplitz(x, M, raw=True), M
        if M > 0 and self.engine == "ozaki":
            return self._apply_ozaki(x, M, raw=True), M
        if M > 0:
            y = self.apply(x if x.shape[1] == n_valid else x[:, :n_valid])
            return y, y.shape[1]
        return x.new_zeros((x.shape[0], 0), dtype=self.dtype), 0

    def apply_df(self, h: torch.Tensor, l, n_valid=None,
                 emit_pair: bool = True):
        """Consume the previous seam's raw (hi, lo-bfloat16) pair (``l``
        None for a chain's first stage) and emit this stage's raw pair
        with its logical count when ``emit_pair`` (False for a chain's
        last stage, whose output is collapsed anyway)."""
        if n_valid is None:
            n_valid = h.shape[1]
        M = self.out_len(n_valid)
        if M <= 0:
            return h.new_zeros((h.shape[0], 0), dtype=self.dtype), None, 0
        res = self._apply_ozaki(h, M, raw=True, x_lo=l, pair=emit_pair)
        if emit_pair:
            return res[0], res[1], M
        return res, None, M

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        M = self.out_len(x.shape[1])
        if M <= 0:
            return x.new_zeros((x.shape[0], 0), dtype=self.dtype)
        run = {"ozaki": self._apply_ozaki, "toeplitz": self._apply_toeplitz,
               "toeplitz_sym": self._apply_toeplitz_sym,
               "pallas": self._apply_pallas,
               "direct": self._apply_direct}.get(self.engine, self._apply_fft)
        return run(x, M)

    forward = apply


class FracWholeExec(nn.Module):
    """Whole-stepping fractional interpolator.

    For output n = m*O + j (O = out_step, I = in_step):
        g_j = W0 + j*I;  f_j = g_j mod O;  s_j = g_j // O
        y[n] = sum_i bank[f_j][i] * x[s_j + m*I - (fl2 - 1) + i]
    Rows of the superkernel SK[j] hold bank[f_j] at offset s_j - s_0, so
    y[:, m*O + j] = sum_d SK[j, d] * x[m*I + a0 + d]: a framed matmul at
    stride I with O output columns.

    Engines: "ozaki", the error-free split form on ``ozaki_framed``;
    "im2col" on ``frac_whole``, with the float32 residual of the operator
    (``skT_lo``) and 16-term folds (``KC_LO``: a column's ~24 nonzero taps
    would otherwise share one partial) under ``precision="high"``;
    "pallas" and "conv", the same call (the reference's pallas tile
    constraint is the TPU's, and its strided convolution computes the same
    contraction; see ConvExec's "direct" for why it is not ``F.conv1d``);
    "auto", the reference's rule: "im2col" in float32 when D <= 4*I, else
    "conv"."""

    def __init__(self, spec: FracStage, dtype=torch.float32,
                 precision: str = "fast", engine: str = "auto"):
        super().__init__()
        if not spec.is_whole:
            raise ValueError("FracWholeExec needs a whole-stepping stage")
        self.spec = spec
        self.dtype = dtype
        O, I, W0 = spec.out_step, spec.in_step, spec.init_frac_pos_w
        fl = spec.filter_len
        fll = fl // 2 - 1
        g = W0 + np.arange(O, dtype=np.int64) * I
        f = g % O
        a = g // O - fll  # window start (absolute input index) of phase j
        self.a0 = int(a[0])
        D = int(a[-1] - a[0]) + fl
        table = np.asarray(spec.bank.table, dtype=np.float64)  # [O, fl]
        sk = np.zeros((O, D), dtype=np.float64)
        cols = (a - a[0])[:, None] + np.arange(fl)[None, :]
        sk[np.arange(O)[:, None], cols] = table[f]
        self.D = D
        if engine == "auto":
            engine = ("im2col" if dtype == torch.float32 and D <= 4 * I
                      else "conv")
        if engine not in ("ozaki", "im2col", "pallas", "conv"):
            raise ValueError(f"unknown frac engine {engine!r}")
        self.engine = engine
        if engine == "ozaki":
            _check_ozaki(dtype, precision)
            parts, self.oz_scale = split_operator_host(
                np.ascontiguousarray(sk.T))
            _register_ozaki(self, parts)
            return
        _check_dtype(dtype)
        _check_precision(precision)
        self.precision = precision if dtype == torch.float32 else "fast"
        skT = np.ascontiguousarray(sk.T)
        lo = None
        if self.precision == "high":
            lo = (skT - skT.astype(np.float32).astype(np.float64)).astype(
                np.float32)
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        self.register_buffer("skT", torch.from_numpy(skT.astype(np_dt)))
        self.register_buffer("skT_lo", None if lo is None else
                             torch.from_numpy(lo))
        self.register_buffer("sk_parts", operator_parts(self.skT,
                                                        self.skT_lo))
        self.kc = KC if lo is None else KC_LO

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

    @property
    def oz_packed(self):
        """The ozaki engine's operator as the kernel takes it."""
        return self.oz_tiles, self.oz_bands

    def geometry(self, M: int):
        """(L_f, hop, Kcols, n_blocks) of the framed product behind M
        outputs: windows of D samples at stride in_step, out_step outputs
        each."""
        O = self.spec.out_step
        return self.D, self.spec.in_step, O, -(-M // O)

    def _frame(self, x: torch.Tensor, M: int, x_lo=None):
        """(xp, xl): the signal shifted and padded so that xp[:, m*I : m*I
        + D] is window m (float32 for the ozaki engine, else the stage's
        dtype), and the bfloat16 seam residual ``x_lo`` alike (or None)."""
        D, I, _O, n_cyc = self.geometry(M)
        need = (n_cyc + -(-D // I)) * I
        dt = torch.float32 if self.engine == "ozaki" else self.dtype
        xp = _shifted(x, self.a0, need, dt)
        xl = None if x_lo is None else _shifted(x_lo, self.a0, need,
                                                x_lo.dtype)
        return xp, xl

    def _scale(self, xp: torch.Tensor, M: int) -> torch.Tensor:
        """Per-channel power-of-two scales over the windows (ozaki)."""
        D, I, _O, n_cyc = self.geometry(M)
        return channel_scale(xp[:, : (n_cyc - 1) * I + D])

    def _run(self, x: torch.Tensor, M: int) -> torch.Tensor:
        xp, _ = self._frame(x, M)
        D, I, O, n_cyc = self.geometry(M)
        if self.engine == "ozaki":
            return ozaki_framed(xp, self._scale(xp, M), self.oz_parts, D, I,
                                O, n_cyc, packed=self.oz_packed)[:, :M]
        return frac_whole(xp, self.sk_parts, I, D, O, n_cyc,
                          kc=self.kc)[:, :M]

    def apply_v(self, x: torch.Tensor, n_valid: int):
        """Valid-prefix seam protocol; latency-shifted specs slice to the
        logical prefix first (the latency folds into window positions)."""
        M = stage_out_len(self.spec, n_valid)
        if self.spec.in_latency or M <= 0:
            xl = x if x.shape[1] == n_valid else x[:, :n_valid]
            y = self.apply(xl)
            return y, y.shape[1]
        return self._run(x, M), M

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        C, N = x.shape
        M = stage_out_len(spec, N)
        if spec.in_latency:
            x = x[:, spec.in_latency :]
        if M <= 0:
            return x.new_zeros((C, 0), dtype=self.dtype)
        return self._run(x, M)

    forward = apply

    def apply_df(self, h: torch.Tensor, l, n_valid=None,
                 emit_pair: bool = True):
        """df32 carry (see ConvExec.apply_df).  In the ozaki engine, as
        the last stage of a chain it consumes the seam residual with one
        segmented bfloat16 pass (``framed_cheap``) while the kernel emits
        its (hi, lo) pair, so the collapse hi + (lo + cheap) rounds once
        (adding the residual to a collapsed output would round twice:
        -149.5 against -151.9 dB on the flagship in the reference
        package).  The other engines have no carry path: they collapse
        the pair over the logical prefix first."""
        spec = self.spec
        C, N = h.shape
        if n_valid is None:
            n_valid = N
        M = stage_out_len(spec, n_valid)
        if spec.in_latency:
            # a latency fold into raw buffers is unsound: slice first
            h = h[:, spec.in_latency : n_valid]
            l = None if l is None else l[:, spec.in_latency : n_valid]
        if M <= 0:
            return h.new_zeros((C, 0), dtype=self.dtype), None, 0
        if self.engine != "ozaki":
            # no carry path: collapse the pair over the logical prefix
            # (the reference's _df_collapse_input)
            nv = h.shape[1] if spec.in_latency else n_valid
            x = h[:, :nv] if l is None else h[:, :nv] + l[:, :nv]
            return self._run(x, M), None, M
        if l is None and not emit_pair:
            return self._run(h, M), None, M
        geo = self.geometry(M)
        _D, I, _O, n_cyc = geo
        xp, xl = self._frame(h, M, l)
        sx = self._scale(xp, M)
        if not emit_pair:
            cheap = framed_cheap(xl, self.oz_parts[0], n_cyc, I)
            yh, yl = ozaki_framed(xp, sx, self.oz_parts, *geo, emit_pair=True,
                                  packed=self.oz_packed)
            y = yh + (yl.float() + cheap.reshape(C, -1))
            return y[:, :M], None, M
        yh, yl = ozaki_framed(xp, sx, self.oz_parts, *geo, x_lo=xl,
                              emit_pair=True, packed=self.oz_packed)
        return yh[:, :M], yl[:, :M], M




def _df_collapse_input(h, l, n_valid):
    """A df32 seam pair collapsed to one input for a stage (or engine)
    without a carry path: both streams sliced to the logical prefix and
    added once, exactly the seam rounding of the chain without the
    carry."""
    hl = h if h.shape[1] == n_valid else h[:, :n_valid]
    if l is not None:
        hl = hl + (l if l.shape[1] == n_valid else l[:, :n_valid])
    return hl


#: The half-band framed engines' block: 128 pairs (up) or outputs (down)
#: a frame, the reference's B.
HB_BLOCK = 128


class _HalfBandExec(nn.Module):
    """What the two half-band executors share: the engine rule, the
    operator of the framed engines and their product, the carry.

    Engines: "matmul" (float32's "auto"), the framed product against the
    banded operator on ``frac_whole`` (32-term folds; under
    ``precision="high"`` with the row-truncated residual of the rounded
    taps, ``T_lo``, and 16-term folds, as FracWholeExec: a column's 2*nt
    taps would otherwise share one partial); "stencil" (float64's
    "auto"), the symmetric shifted adds in the oracle's summation order;
    "ozaki", the same
    operator in the error-free split form on ``ozaki_framed`` (float64
    runs "stencil" instead, as in the reference)."""

    def __init__(self, spec, dtype, engine: str, precision: str):
        super().__init__()
        _check_dtype(dtype)
        _check_precision(precision)
        if engine == "auto":
            engine = "matmul" if dtype == torch.float32 else "stencil"
        if engine == "ozaki" and dtype != torch.float32:
            engine = "stencil"  # the split form is a float32 tool
        if engine not in ("matmul", "stencil", "ozaki"):
            raise ValueError(f"unknown half-band engine {engine!r}")
        self.spec = spec
        self.dtype = dtype
        self.engine = engine
        self.nt = spec.hb.num_taps
        self.precision = (precision if dtype == torch.float32
                          and engine in ("matmul", "ozaki") else "fast")
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        t64 = np.asarray(spec.hb.taps, dtype=np.float64)
        self.register_buffer("taps", torch.from_numpy(t64.astype(np_dt)))
        if engine == "stencil":
            return
        T = self._operator(t64)
        self.L_f, self.Kcols = T.shape
        if engine == "ozaki":
            parts, self.oz_scale = split_operator_host(T)
            _register_ozaki(self, parts)
            return
        Thi = T.astype(np_dt)
        lo = None
        if self.precision == "high":
            # the rounded taps' residual (the identity entries are exact)
            r0, rows = truncate_residual(
                (T - Thi.astype(np.float64)).astype(np.float32),
                float(np.abs(T).max()))
            if rows.shape[0]:
                lo = _placed(rows, r0, T.shape[0])
        self.register_buffer("T", torch.from_numpy(Thi))
        self.register_buffer("T_lo", lo)
        self.register_buffer("T_parts", operator_parts(self.T, self.T_lo))
        self.kc = KC_LO if self.precision == "high" else KC

    @property
    def oz_packed(self):
        """The ozaki engine's operator as the kernel takes it."""
        return self.oz_tiles, self.oz_bands

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

    def _framed(self, x, n_in: int, x_lo=None, pair: bool = False):
        """The framed product over the blocks behind n_in input samples,
        every block's columns ([C, n_blocks * Kcols], or the (hi, lo)
        pair)."""
        start, n_blocks, hop = self._geometry(n_in)
        need = (n_blocks - 1) * hop + self.L_f
        if self.engine == "matmul":
            xp = _shifted(x, start, need, self.dtype)
            return frac_whole(xp, self.T_parts, hop, self.L_f, self.Kcols,
                              n_blocks, kc=self.kc)
        xp = _shifted(x, start, need, torch.float32)
        xl = None if x_lo is None else _shifted(x_lo, start, need,
                                                x_lo.dtype)
        return ozaki_framed(xp, channel_scale(xp[:, :need]), self.oz_parts,
                            self.L_f, hop, self.Kcols, n_blocks, x_lo=xl,
                            emit_pair=pair, packed=self.oz_packed)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        C, N = x.shape
        M = self.out_len(N)
        if M <= 0:
            return x.new_zeros((C, 0), dtype=self.dtype)
        lat = self.spec.out_latency
        if self.engine == "stencil":
            return self._stencil(x.to(self.dtype))[:, lat : lat + M]
        return self._framed(x, N)[:, lat : lat + M]

    forward = apply

    def apply_df(self, h: torch.Tensor, l, n_valid=None,
                 emit_pair: bool = True):
        """df32 carry (see ConvExec.apply_df): the ozaki engine reads the
        raw pair; window reads past ``n_valid`` land only in outputs past
        M.  The other engines collapse the pair first."""
        C, N = h.shape
        if n_valid is None:
            n_valid = N
        M = self.out_len(n_valid)
        if M <= 0:
            return h.new_zeros((C, 0), dtype=self.dtype), None, 0
        if self.engine != "ozaki":
            y = self.apply(_df_collapse_input(h, l, n_valid))
            return y, None, y.shape[1]
        lat = self.spec.out_latency
        res = self._framed(h, n_valid, x_lo=l, pair=emit_pair)
        if emit_pair:
            return res[0][:, lat : lat + M], res[1][:, lat : lat + M], M
        return res[:, lat : lat + M], None, M


class HBUpExec(_HalfBandExec):
    """Half-band 2X upsampler: y[2n] = x[n]; y[2n+1] = the symmetric
    stencil sum_i taps[i] * (x[n+1+i] + x[n-i]) (CDSPHBUpsampler.h).

    The framed engines run blocks of B = 128 pairs against a [B + 2*nt, 2B]
    operator whose even columns are the identity and odd columns the
    stencil, so the product writes the interleaved stream: one
    ``frac_whole`` (or ``ozaki_framed``) call at I = 128, D = 128 + 2*nt,
    O = 256."""

    def __init__(self, spec: HBUpStage, dtype=torch.float32,
                 engine: str = "auto", precision: str = "fast"):
        super().__init__(spec, dtype, engine, precision)

    def _operator(self, t64: np.ndarray) -> np.ndarray:
        nt, B = self.nt, HB_BLOCK
        T = np.zeros((B + 2 * nt, 2 * B), dtype=np.float64)
        j = np.arange(B)
        T[j + nt, 2 * j] = 1.0  # even output: the centre sample
        for i in range(nt):
            T[j + nt + 1 + i, 2 * j + 1] = t64[i]
            T[j + nt - i, 2 * j + 1] = t64[i]
        return T

    def _geometry(self, n_in: int):
        """(first sample of block 0, blocks, hop): pair n reads x[n - nt +
        l], l in [1, 2*nt]."""
        return -self.nt, -(-(n_in - self.nt) // HB_BLOCK), HB_BLOCK

    def _stencil(self, x: torch.Tensor) -> torch.Tensor:
        """The symmetric shifted adds in the oracle's order."""
        C, N = x.shape
        nt = self.nt
        n_pairs = N - nt
        xp = F.pad(x, (nt, 0))  # xp[k] = x[k - nt]
        odd = x.new_zeros((C, n_pairs))
        for i in range(nt):
            a = xp[:, nt + 1 + i : nt + 1 + i + n_pairs]
            odd = odd + self.taps[i] * (a + xp[:, nt - i : nt - i + n_pairs])
        return torch.stack([x[:, :n_pairs], odd], dim=-1).reshape(
            C, 2 * n_pairs)


class HBDownExec(_HalfBandExec):
    """Half-band 2X decimator (gain 2): y[n] = x[2n] + sum_i taps[i] *
    (x[2n+1+2i] + x[2n-1-2i]) (CDSPHBDownsampler.h).

    The framed engines run blocks of B = 128 outputs at hop 2B against a
    [2B + 4*nt - 2, B] operator holding the half-band kernel at stride-2
    column offsets: one ``frac_whole`` (or ``ozaki_framed``) call at I =
    256, D = 254 + 4*nt, O = 128."""

    def __init__(self, spec: HBDownStage, dtype=torch.float32,
                 engine: str = "auto", precision: str = "fast"):
        super().__init__(spec, dtype, engine, precision)

    def _operator(self, t64: np.ndarray) -> np.ndarray:
        nt, B = self.nt, HB_BLOCK
        h = np.zeros(4 * nt - 1, dtype=np.float64)
        h[2 * nt - 1] = 1.0  # the centre sample x[2n]
        for i in range(nt):
            h[2 * nt + 2 * i] = t64[i]
            h[2 * nt - 2 - 2 * i] = t64[i]
        T = np.zeros((2 * B + h.shape[0] - 1, B), dtype=np.float64)
        for b in range(B):
            T[2 * b : 2 * b + h.shape[0], b] = h
        return T

    def _geometry(self, n_in: int):
        """(first sample of block 0, blocks, hop): y[n] reads x[2n + d -
        (2*nt - 1)], d in [0, 4*nt - 1)."""
        cnt = (n_in - 2 * self.nt) // 2 + 1
        return 1 - 2 * self.nt, -(-cnt // HB_BLOCK), 2 * HB_BLOCK

    def _stencil(self, x: torch.Tensor) -> torch.Tensor:
        """The deinterleaved symmetric shifted adds in the oracle's order
        (the even/odd split of CDSPHBDownsampler.h)."""
        N = x.shape[1]
        nt = self.nt
        cnt = (N - 2 * nt) // 2 + 1
        if N % 2:
            x = F.pad(x, (0, 1))
        xo = F.pad(x[:, 1::2], (nt, nt))  # xo[k] = x[2(k - nt) + 1]
        y = x[:, 0::2][:, :cnt]
        for i in range(nt):
            y = y + self.taps[i] * (xo[:, nt + i : nt + i + cnt]
                                    + xo[:, nt - 1 - i : nt - 1 - i + cnt])
        return y


def chunk_drift_groups(sg: np.ndarray, vals: np.ndarray, scale: int,
                       S: int, fl: int, budget: int, ngrp_max: int,
                       W: int):
    """Chunks of [n_grp, G] output groups for the banded contraction.

    Frames are read at the uniform stride ``S``; a chunk of ``nloc`` groups
    from ``g0`` is anchored at A = min over its rows m of (sg[g0+m].min() -
    m*S) and its group-local window offsets are off = vals[g0:g0+nloc] -
    scale*(A + m*S) (``scale`` maps the frame grid to the grid of
    ``vals``).  A chunk is accepted when off.max() + fl <= budget and
    halved otherwise; a single group must fit.

    Returns (chunks, need_len, shift): ``chunks`` a list of (g0, nloc, A,
    off int32) with every A >= 0 after the frame origin moves right by
    ``shift`` samples; ``need_len`` the frame samples needed from the
    shifted origin."""
    n_grp = sg.shape[0]
    chunks = []
    need_len = 0
    g0 = 0
    while g0 < n_grp:
        nloc = min(ngrp_max, n_grp - g0)
        while True:
            m = np.arange(nloc)
            A = int((sg[g0 : g0 + nloc].min(axis=1) - m * S).min())
            off = vals[g0 : g0 + nloc] - scale * (A + m * S)[:, None]
            assert off.min() >= 0
            if off.max() + fl <= budget or nloc == 1:
                break
            nloc //= 2  # the drift exceeds the operator's band: split
        assert off.max() + fl <= budget, "drift budget exceeded"
        chunks.append((g0, nloc, A, off.astype(np.int32)))
        need_len = max(need_len, A + (nloc - 1) * S + W)
        g0 += nloc
    shift = max(0, -min(a for _, _, a, _ in chunks))
    if shift:
        need_len += shift
        chunks = [(g_, n_, a_ + shift, o_) for g_, n_, a_, o_ in chunks]
    return chunks, need_len, shift


def _stride_segments(xc: torch.Tensor, nloc: int, S: int, W: int):
    """([..., C, nloc + n_seg, S] reshape view of xc [..., C, T], n_seg):
    frame m covers xc[..., m*S : m*S + W], read in n_seg = ceil(W/S)
    shifted segments."""
    n_seg = -(-W // S)
    total = (nloc + n_seg) * S
    if xc.shape[-1] < total:
        xc = F.pad(xc, (0, total - xc.shape[-1]))
    return xc[..., :total].reshape(*xc.shape[:-1], nloc + n_seg, S), n_seg


@contextlib.contextmanager
def _ieee_fp32():
    """float32 matmuls with IEEE products inside, whatever the caller set
    (TF32's 10-bit mantissa cannot hold the -141 dB class)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def banded_contract(xc: torch.Tensor, R: torch.Tensor, nloc: int, S: int,
                    W: int) -> torch.Tensor:
    """sum_w frames[c, m, w] * R[m, w, g] with the [C, nloc, W] frames at
    stride S read as reshape views of ``xc`` (no gather), segment by
    segment: a batched matmul over m (the operator differs per output
    group).  Returns [C, nloc, G] in xc's dtype; the caller picks the
    matmul precision.  Leading dims batch independent windows: xc
    [..., C, T] against R [..., nloc, W, G] gives [..., C, nloc, G]."""
    ch3, n_seg = _stride_segments(xc, nloc, S, W)
    o = None
    for e in range(n_seg):
        w_e = min(S, W - e * S)
        oe = torch.matmul(ch3[..., e : nloc + e, :w_e].transpose(-3, -2),
                          R[..., e * S : e * S + w_e, :])
        o = oe if o is None else o + oe
    return o.transpose(-3, -2)


def banded_contract_ozaki(xc: torch.Tensor, R_parts: torch.Tensor,
                          nloc: int, S: int, W: int, x_lo=None,
                          pair: bool = False):
    """banded_contract in the error-free split-operand form (the exactness
    lemma of ops/ozaki.py, per (channel, m, g) output cell): slice-pair
    products are integers < 2^16 on a power-of-two grid and every <= K0
    deep float32 sum of them is exact.  The slices are multiplied as
    float32 tensors holding bfloat16 values, so the products stay exact
    and float32 even under TF32.

    R_parts: [N_PARTS, nloc, W, G] bfloat16 (``split_operator_batched``,
    scales folded).  x_lo: the previous seam's residual stream, one pass
    against the top slice.  pair=True returns the two_sum-normalized (hi
    float32, lo bfloat16); [C, nloc, G] either way.  Leading dims batch
    independent windows as in ``banded_contract`` (R_parts [N_PARTS, ...,
    nloc, W, G]), each row of each window split on its own scale."""
    ch, n_seg = _stride_segments(xc, nloc, S, W)
    xparts, x_scale = split_input(ch.reshape(-1, ch.shape[-2] * S))
    ch = [xparts[p].reshape(ch.shape).transpose(-3, -2)
          for p in range(N_PARTS)]
    chl = None
    if x_lo is not None:
        chl = _stride_segments(x_lo, nloc, S, W)[0].to(
            torch.bfloat16).transpose(-3, -2)

    def dot(seg, Rq):
        return torch.matmul(seg.float(), Rq.float())

    hi = lo = rest = cheap = None
    for e in range(n_seg):
        w_e = min(S, W - e * S)
        for c0 in range(0, w_e, K0):
            a0 = e * S + c0
            a1 = min(e * S + w_e, a0 + K0)
            cols = slice(a0 - e * S, a1 - e * S)
            d0 = small = None
            for p in range(N_PARTS):
                for q in range(N_DIAG - p):
                    o = dot(ch[p][..., e : nloc + e, :, cols],
                            R_parts[q][..., a0:a1, :])
                    if p + q == 0:
                        d0 = o
                    else:
                        small = o if small is None else small + o
            if hi is None:
                hi, lo = d0, torch.zeros_like(d0)
            else:
                hi, err = two_sum(hi, d0)
                lo = lo + err
            rest = small if rest is None else rest + small
            if chl is not None:
                o = dot(chl[..., e : nloc + e, :, cols],
                        R_parts[0][..., a0:a1, :])
                cheap = o if cheap is None else cheap + o
    sc = x_scale.reshape(*xc.shape[:-2], 1, xc.shape[-2], 1)
    y_hi = hi * sc
    y_small = (lo + rest) * sc
    if cheap is not None:
        y_small = y_small + cheap
    if not pair:
        return (y_hi + y_small).transpose(-3, -2)
    H, L = two_sum(y_hi, y_small)
    return H.transpose(-3, -2), L.to(torch.bfloat16).transpose(-3, -2)


#: Input lengths whose host-built state a FracPolyExec keeps.
POLY_CACHE = 4
#: The largest group size G the banded engine considers (the reference's).
POLY_G_MAX = 256


def place_operator(vals: torch.Tensor, off: torch.Tensor,
                   W: int) -> torch.Tensor:
    """[..., W, G]: the filter values vals [..., G, fl] placed at the
    group-local offsets off [..., G] (distinct rows for each (m, g, i):
    the placement is exact), by a one-hot scatter of each tap where the
    values lie."""
    fl = vals.shape[-1]
    idx = off.long()[..., None] + torch.arange(fl, device=vals.device)
    R = vals.new_zeros((*vals.shape[:-1], W)).scatter_(-1, idx, vals)
    return R.transpose(-2, -1).contiguous()


def poly_operators(flt64: torch.Tensor, off: torch.Tensor, W: int, dtype,
                   precision: str, oz_products: bool,
                   check: bool = False) -> dict:
    """The banded operators of a polynomial stage's groups from their
    float64 filter values flt64 [..., G, fl] at the group-local offsets
    off [..., G], placed where the values lie: {"R_oz"} for the split
    products (the float64 values split into bfloat16 slices: no residual
    pass needed, the slices carry it to 32 bits), else {"R", "R_lo",
    "R64"} with R the values rounded once to ``dtype``, R_lo the spline
    residual pass and R64 the float64 copy of R that "high" sums against
    (None where unused).  ``check`` asserts the slices bfloat16-exact."""
    if oz_products:
        fps = split_operator_batched(flt64, axis=-1, check=check)
        return {"R_oz": torch.stack([
            place_operator(fps[q].float(), off, W).to(torch.bfloat16)
            for q in range(N_PARTS)])}
    R = place_operator(flt64.to(dtype), off, W)
    if precision != "high":
        return {"R": R, "R_lo": None, "R64": None}
    return {"R": R, "R64": R.double(), "R_lo": place_operator(
        (flt64 - flt64.float().double()).float(), off, W)}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and an
    asynchronous copy on a card, so the host goes on with the next call."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def poly_contract(xc: torch.Tensor, ops: dict, nloc: int, S: int, W: int,
                  precision: str, x_lo=None, pair: bool = False):
    """A polynomial stage's banded contraction of xc [..., C, T] against
    ``poly_operators`` ops: (main, small) with the output main + small,
    small None where nothing rides beside the main product (or, with the
    split products and pair=True, the pair's lo).  The main product runs
    in IEEE float32 whatever the caller's TF32 setting; under "high" it
    sums in float64 (the float32 products are exact there) and rounds
    once, its rounding carried in small with the spline residual pass;
    x_lo is the previous seam's residual stream, one pass."""
    if "R_oz" in ops:
        res = banded_contract_ozaki(xc, ops["R_oz"], nloc, S, W, x_lo=x_lo,
                                    pair=pair)
        return res if pair else (res, None)
    small = None
    if precision == "high":
        o64 = banded_contract(xc.double(), ops["R64"], nloc, S, W)
        o = o64.float()
        small = (o64 - o.double()).float()
    else:
        with _ieee_fp32():
            o = banded_contract(xc, ops["R"], nloc, S, W)
    if ops["R_lo"] is not None:
        # the spline operator's rounding residual: ~2^-24 of the main
        # term, any float32 matmul precision will do
        lo = banded_contract(xc, ops["R_lo"], nloc, S, W)
        small = lo if small is None else small + lo
    if x_lo is not None:
        # the seam residual (|x_lo| <= 2^-24 |x|), one pass
        c = banded_contract(x_lo.to(ops["R"].dtype), ops["R"], nloc, S, W)
        small = c if small is None else small + c
    return o, small


class FracPolyExec(nn.Module):
    """Polynomial-mode fractional interpolator
    (CDSPFracInterpolator.h, convolve2): output n reads fl input samples
    from floor(p_n) - fll with the spline filter c0[f] + (c1[f] + c2[f]*t)
    * t of its fractional position.  The read positions are independent
    of the data: the host computes them in float64, as the oracle does.

    Engines:
      * "banded" (float32's "auto"): a rational S/G near the ratio (G
        outputs advance the read position by about S inputs), frames of W
        samples at the uniform stride S read as reshape views, and each
        group of G outputs one [W] x [W, G] product against a banded
        operator R holding the filters at their group-local offsets.  The
        offsets drift by |G*r - S| a group, so the groups are chunked to
        the band (``chunk_drift_groups``).  The filter values are evaluated
        in float64 on the device from host positions, rounded once and
        placed into R (``operators``); under "high" the rounding's residual
        rides a second pass; with ``oz_products`` (frac_engine="ozaki")
        the float64 values are split into bfloat16 slices and contracted
        error-free (``banded_contract_ozaki``).  The main contraction runs
        in IEEE float32 whatever the caller's TF32 setting; under "high"
        it sums in float64 (the float32 products are exact there) and
        rounds once, where the reference sums in float32: a plain float32
        sum of a window's taps was the chain's largest error on an H100
        (about -146 dB re full scale, against -150 for each frac_whole
        stage); ``poly_contract`` runs it, for the oneshot and the
        stream.
      * "gather" (float64's "auto"): one gather a tap with the filter
        evaluated in the stage's dtype, in the oracle's summation order
        (``gather``).

    The streamed interpolator (models/stream.py) builds its operators and
    taps through the same ``operators`` / ``gather_taps``.  The oneshot's
    state (positions, chunks, operators on the device) depends only on
    the output count: it is built once for each input length and kept
    for the last ``POLY_CACHE`` lengths."""

    def __init__(self, spec: FracStage, dtype=torch.float32,
                 engine: str = "auto", precision: str = "fast",
                 oz_products: bool = False):
        super().__init__()
        if spec.is_whole:
            raise ValueError("FracPolyExec needs a polynomial-mode stage")
        _check_dtype(dtype)
        _check_precision(precision)
        self.spec = spec
        self.dtype = dtype
        self.precision = precision if dtype == torch.float32 else "fast"
        self.oz_products = bool(oz_products) and self.precision == "high"
        if engine == "auto":
            engine = "banded" if dtype == torch.float32 else "gather"
        if engine not in ("banded", "gather"):
            raise ValueError(f"unknown poly engine {engine!r}")
        self.engine = engine
        # the spline table, float64 [rows, fl, (c0, c1, c2)]
        self.register_buffer("tab", torch.tensor(spec.bank.table,
                                                 dtype=torch.float64))
        self.fracs = spec.bank.fracs
        self.fl = spec.filter_len
        self.fll = self.fl // 2 - 1
        self._state = OrderedDict()
        if engine == "banded":
            self._prep_banded()

    def _prep_banded(self):
        """The (S, G) pair minimizing the product's work per output, W *
        ceil(G/128)*128/G * (1 + 0.5/ngrp_max) with W ~ S + fl + slack:
        the convergents of the ratio and G in (64, 96, ..., 256), the
        reference's scoring, kept so the geometry is the reference's."""
        r = self.spec.src_rate / self.spec.dst_rate
        fr = Fraction(r).limit_denominator(POLY_G_MAX)
        cands = []
        if 8 <= fr.denominator <= POLY_G_MAX:
            for k in range(1, POLY_G_MAX // fr.denominator + 1):
                cands.append((fr.numerator * k, fr.denominator * k))
        for G in (64, 96, 128, 160, 192, 256):
            S = int(round(G * r))
            if S >= 1:
                cands.append((S, G))
        slack = 6
        best = None
        for S, G in cands:
            drift = abs(G * r - S)
            if drift > slack:  # a single group must fit the band
                continue
            W = -(-(S + self.fl + slack + 2) // 8) * 8
            lane_pad = (-(-G // 128) * 128) / G
            ngrp_max = max(8, int(slack / max(drift, 1e-12)))
            eff = W * lane_pad * (1.0 + 0.5 / ngrp_max)
            if best is None or eff < best[0]:
                best = (eff, S, G, drift, ngrp_max, W)
        _, self.S, self.G, self.drift, self.ngrp_max, self.W = best
        self.slack = slack

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

    def host_positions(self, M: int):
        """(window_start int32, frac_index int32, t float64) of outputs [0,
        M), in float64 on the host (models/lengths.py frac_positions)."""
        s, f = frac_positions(self.spec, 0, M)
        fr = f * self.fracs
        fti = np.floor(fr).astype(np.int64)
        t = (fr - fti).astype(np.float64)
        return (s - self.fll).astype(np.int32), fti.astype(np.int32), t

    def apply_v(self, x: torch.Tensor, n_valid: int):
        """Valid-prefix seam protocol (see ConvExec.apply_v): the raw
        group buffer and the logical count.  The positions are closed-form
        in the output index, so the surplus columns are real outputs.
        Latency-shifted specs take the sliced path (folding in_latency into
        the window starts would read samples of the latency prefix where
        apply reads zeros)."""
        M = stage_out_len(self.spec, n_valid)
        if self.engine != "banded" or M <= 0 or self.spec.in_latency:
            y = self.apply(x if x.shape[1] == n_valid else x[:, :n_valid])
            return y, y.shape[1]
        Mp = -(-M // self.G) * self.G
        return self._apply_banded(x, Mp, raw=True), M

    def apply_df(self, h: torch.Tensor, l, n_valid=None,
                 emit_pair: bool = True):
        """df32 carry (see ConvExec.apply_df): the banded engine emits its
        main contraction and its corrections (spline residual, seam
        residual) as a two_sum pair on raw group buffers; latency-shifted
        specs and the gather engine collapse the pair first."""
        C, N = h.shape
        if n_valid is None:
            n_valid = N
        M = stage_out_len(self.spec, n_valid)
        if self.engine != "banded" or self.spec.in_latency or M <= 0:
            y = self.apply(_df_collapse_input(h, l, n_valid))
            return y, None, y.shape[1]
        Mp = -(-M // self.G) * self.G
        res = self._apply_banded(h, Mp, raw=True, x_lo=l, pair=emit_pair)
        if emit_pair:
            return res[0], res[1], M
        return res, None, M

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        C = x.shape[0]
        M = stage_out_len(spec, x.shape[1])
        if spec.in_latency:
            x = x[:, spec.in_latency :]
        if M <= 0:
            return x.new_zeros((C, 0), dtype=self.dtype)
        if self.engine == "banded":
            return self._apply_banded(x, M)
        return self._apply_gather(x, M)

    forward = apply

    def _cached(self, key, build):
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = build()
            while len(self._state) > POLY_CACHE:
                self._state.popitem(last=False)
        else:
            self._state.move_to_end(key)
        return st

    def values(self, fti: torch.Tensor, t: torch.Tensor,
               dtype=torch.float64) -> torch.Tensor:
        """[..., fl] spline values c0 + (c1 + c2 t) t of the table rows fti
        at the float64 phases t, evaluated in ``dtype`` where they lie."""
        tb = self.tab[fti].to(dtype)
        t = t.to(dtype)[..., None]
        return tb[..., 0] + (tb[..., 1] + tb[..., 2] * t) * t

    def operators(self, fti, t, off, W: int, dev,
                  check: bool = False) -> dict:
        """``poly_operators`` of groups [..., G] from host positions: the
        table rows fti, the float64 phases t and the group-local offsets
        off, shipped in one copy and evaluated on ``dev``."""
        d = _to_device(np.stack([fti, t, off]).astype(np.float64), dev)
        return poly_operators(self.values(d[0].long(), d[1]), d[2].long(),
                              W, self.dtype, self.precision,
                              self.oz_products, check=check)

    def gather_taps(self, start, fti, t, dev):
        """(idx, flt) of ``gather`` from host positions: the window starts
        and the values evaluated in the stage's dtype (the reference's
        gather engine, bit for bit)."""
        d = _to_device(np.stack([start, fti, t]).astype(np.float64), dev)
        return d[0].long(), self.values(d[1].long(), d[2], self.dtype)

    def gather(self, xp: torch.Tensor, idx, flt) -> torch.Tensor:
        """One gather a tap of xp [C, T] at the window starts idx [M]
        against the values flt [M, fl], in the oracle's summation order."""
        y = xp.new_zeros((xp.shape[0], idx.shape[0]), dtype=self.dtype)
        for i in range(self.fl):
            y = y + flt[None, :, i] * xp[:, idx + i]
        return y

    def _apply_gather(self, x: torch.Tensor, M: int) -> torch.Tensor:
        N = x.shape[1]
        dev = x.device

        def build():
            start, fti, t = self.host_positions(M)
            pad_l = max(0, -int(start.min()))
            pad_r = max(0, int(start.max()) + self.fl - N)
            return (pad_l, pad_r,
                    *self.gather_taps(start + pad_l, fti, t, dev))

        pad_l, pad_r, idx, flt = self._cached(("gather", M, N, dev), build)
        return self.gather(F.pad(x.to(self.dtype), (pad_l, pad_r)), idx, flt)

    def _banded_state(self, M: int, dev):
        """(chunks [(A, nloc, operators)], need_len, pad_l) of M outputs,
        M a multiple of G on the seam paths; a non-seam caller's last
        partial group is edge-extended.  Built once a length, so the split
        slices' exactness is checked here."""
        G, S, W, fl = self.G, self.S, self.W, self.fl
        start, fti, t = self.host_positions(M)
        n_grp = -(-M // G)
        Mp = n_grp * G
        if Mp > M:
            ext = Mp - M
            start = np.concatenate([start, np.repeat(start[-1], ext)])
            fti = np.concatenate([fti, np.repeat(fti[-1], ext)])
            t = np.concatenate([t, np.repeat(t[-1], ext)])
        pad_l = max(0, -int(start.min()))
        sg = (start + pad_l).reshape(n_grp, G)  # window starts a group
        chunks, need_len, shift = chunk_drift_groups(sg, sg, 1, S, fl, W,
                                                     n_grp, W)
        fti2, t2 = fti.reshape(n_grp, G), t.reshape(n_grp, G)
        built = [(A, nloc, self.operators(
            fti2[g0 : g0 + nloc], t2[g0 : g0 + nloc], off, W, dev,
            check=True)) for g0, nloc, A, off in chunks]
        return built, need_len, pad_l + shift

    def _apply_banded(self, x: torch.Tensor, M: int, raw: bool = False,
                      x_lo=None, pair: bool = False):
        C, N = x.shape
        G, S, W = self.G, self.S, self.W
        chunks, need_len, pad_l = self._cached(
            ("banded", M, x.device), lambda: self._banded_state(M, x.device))
        pad_r = max(0, need_len - (N + pad_l))
        xp = F.pad(x.to(self.dtype), (pad_l, pad_r))
        xlp = None if x_lo is None else F.pad(x_lo, (pad_l, pad_r))
        outs = []
        span = -(-W // S) * S  # past the chunk's nloc*S: its last frame
        for A, nloc, ops in chunks:
            end = A + nloc * S + span
            o, small = poly_contract(
                xp[:, A:end], ops, nloc, S, W, self.precision,
                x_lo=None if xlp is None else xlp[:, A:end], pair=pair)
            if not pair and small is not None:
                o = o + small
            outs.append((o.reshape(C, nloc * G),
                         None if small is None or not pair
                         else small.reshape(C, nloc * G)))
        y = torch.cat([a for a, _ in outs], dim=1) if len(outs) > 1 \
            else outs[0][0]
        if not pair:
            return y if raw else y[:, :M]
        ls = [b.float() if b is not None else torch.zeros_like(a)
              for a, b in outs]
        yl = torch.cat(ls, dim=1) if len(ls) > 1 else ls[0]
        if not raw:
            y, yl = y[:, :M], yl[:, :M]
        H, L = two_sum(y, yl)
        return H, L.to(torch.bfloat16)


#: The frac engines a polynomial stage accepts (the whole-stepping ones run
#: its "auto", as in the reference; "ozaki" turns on the split products).
POLY_FRAC_ENGINES = ("auto", "banded", "gather", "ozaki", "im2col",
                     "pallas", "conv")


def build_exec(spec, dtype=torch.float32, precision: str = "fast",
               conv_engine: str = "auto", frac_engine: str = "auto"):
    """The executor of one planned stage (the reference's build_exec): an
    unknown engine raises ValueError.  Half-band stages take the ozaki
    engine under conv_engine="ozaki", their "auto" otherwise; a polynomial
    stage takes frac_engine "banded" or "gather", and under "ozaki"
    precision "high" with the split products."""
    if isinstance(spec, ConvStage):
        return ConvExec(spec, dtype, precision, engine=conv_engine)
    hb_engine = "ozaki" if conv_engine == "ozaki" else "auto"
    if isinstance(spec, HBUpStage):
        return HBUpExec(spec, dtype, engine=hb_engine, precision=precision)
    if isinstance(spec, HBDownStage):
        return HBDownExec(spec, dtype, engine=hb_engine, precision=precision)
    if isinstance(spec, FracStage):
        if spec.is_whole:
            return FracWholeExec(spec, dtype, precision, engine=frac_engine)
        if frac_engine not in POLY_FRAC_ENGINES:
            raise ValueError(f"unknown frac engine {frac_engine!r}")
        return FracPolyExec(
            spec, dtype,
            engine=frac_engine if frac_engine in ("banded", "gather")
            else "auto",
            precision="high" if frac_engine == "ozaki" else precision,
            oz_products=frac_engine == "ozaki")
    raise TypeError(spec)
