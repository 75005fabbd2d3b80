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

Ported, for every [conv, whole-frac] plan:

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
  float32 operator residual and 8-term folds under ``precision="high"``).

Each kernel wrapper runs the CUDA kernel on a CUDA tensor and its plain
version on a CPU tensor.  Half-band and polynomial stages raise
NotImplementedError naming the ROADMAP.md item that ports them; the fast
flagship runs through the fused executor (ops/fused.py) instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.lengths import stage_out_len
from ..models.plan import ConvStage, FracStage, HBDownStage, HBUpStage
from ..utils.trace import trace
from .ozaki import channel_scale, framed_cheap, split_operator_host
from .pallas_dfft import (DfFFTPlan, df_fft_conv, framed_supported,
                          supported_n)
from .pallas_frac import KC, KC_LO, frac_whole
from .pallas_ozaki import ozaki_framed
from .pallas_symconv import BH, sym_conv

__all__ = ["truncate_residual", "ConvExec", "FracWholeExec", "build_exec",
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
            f"runs conv_engine='fft' (ROADMAP.md queue 1 items 3 and 8)")
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
        (``sym_conv``: half the FMAs); under "high" with the fold-error
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
        and, under "high", the residual ``skT_direct_lo`` and 8-term
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
        To of each phase, zero rows past its Hp) and, under "high",
        ``sym_lo`` [up, 2, R, 128] with the row blocks of Te_lo, To_lo at
        ``sym_lo_rows``."""
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

    def _build_ozaki(self, B: int):
        """Split form of the banded-Toeplitz operator (ops/ozaki.py): the
        block count B halves while B*down > 2*D, down to 128."""
        down = self.spec.down
        D = self.D_direct
        while B * down > 2 * D and B > 128:
            B //= 2
        T = _banded(self._sk64, B, down)
        parts, self.oz_scale = split_operator_host(T)
        self.register_buffer("oz_parts", parts)
        self.oz_Lf = T.shape[0]
        self.B_toep = B

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
                           x_lo=xl, emit_pair=pair)
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
        y = frac_whole(xp, self.T_toep, hop, L_f, B * up, n_blocks,
                       skT_lo=self.T_toep_lo, kc=KC)
        return y if raw else y[:, :M]

    def _apply_toeplitz_sym(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The folded operators on sym_conv, every phase in one launch:
        frames of hop B*down from the common origin s_min + dmin."""
        up, down, B = self.spec.up, self.spec.down, self.B_sym
        nb = -(-(-(-M // up)) // B)
        hop = B * down
        xp = _shifted(x, self.s_min + self.sym_dmin,
                      (nb - 1) * hop + max(self.sym_Lf), self.dtype)
        return sym_conv(xp, self.sym_ops, self.sym_Lf, nb, hop,
                        lo=self.sym_lo, lo_rows=self.sym_lo_rows)[:, :M]

    def _apply_pallas(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The mini-Toeplitz on frac_whole: I = 64*down, D = L_f, O =
        64*up."""
        up, down, B = self.spec.up, self.spec.down, self.B_pallas
        n_grp = -(-(-(-M // up)) // B)
        L_f = self.Lf_pallas
        xp = _shifted(x, self.s_min, (n_grp - 1) * B * down + L_f, self.dtype)
        return frac_whole(xp, self.T_pal, B * down, L_f, B * up, n_grp,
                          skT_lo=self.T_pal_lo, kc=KC)[:, :M]

    def _apply_direct(self, x: torch.Tensor, M: int) -> torch.Tensor:
        """The superkernel's strided product on frac_whole: I = down, D =
        D_direct, O = up, one window a cycle; under "high" with 8-term
        folds, the counterpart of the reference's compensated 128-tap
        chunks (tests/test_torch_stage_chain.py holds the chain at
        -141 dB)."""
        up, down, D = self.spec.up, self.spec.down, self.D_direct
        n_cyc = -(-M // up)
        lo = self.skT_direct_lo
        xp = _shifted(x, self.s_min, (n_cyc - 1) * down + D, self.dtype)
        return frac_whole(xp, self.skT_direct, down, D, up, n_cyc, skT_lo=lo,
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
    (``skT_lo``) and 8-term folds (``KC_LO``: a column's ~24 nonzero taps
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
            self.register_buffer("oz_parts", parts)
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
        self.kc = KC if lo is None else KC_LO

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

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
                                O, n_cyc)[:, :M]
        return frac_whole(xp, self.skT, I, D, O, n_cyc, skT_lo=self.skT_lo,
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
            yh, yl = ozaki_framed(xp, sx, self.oz_parts, *geo, emit_pair=True)
            y = yh + (yl.float() + cheap.reshape(C, -1))
            return y[:, :M], None, M
        yh, yl = ozaki_framed(xp, sx, self.oz_parts, *geo, x_lo=xl,
                              emit_pair=True)
        return yh[:, :M], yl[:, :M], M


def build_exec(spec, dtype=torch.float32, precision: str = "fast",
               conv_engine: str = "auto", frac_engine: str = "auto"):
    """The executor of one planned stage: ``ConvExec`` and
    ``FracWholeExec`` (an unknown engine raises ValueError); half-band and
    polynomial stages raise NotImplementedError naming their ROADMAP.md
    item."""
    if isinstance(spec, ConvStage):
        return ConvExec(spec, dtype, precision, engine=conv_engine)
    if isinstance(spec, (HBUpStage, HBDownStage)):
        raise NotImplementedError(
            f"{spec.kind} stages are not ported yet (ROADMAP.md queue 1 "
            f"item 3; their ozaki engine item 7)")
    if isinstance(spec, FracStage):
        if not spec.is_whole:
            raise NotImplementedError(
                "polynomial-mode interpolation is not ported yet (ROADMAP.md "
                "queue 1 item 4; its ozaki products item 7)")
        return FracWholeExec(spec, dtype, precision, engine=frac_engine)
    raise TypeError(spec)
