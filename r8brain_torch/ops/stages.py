"""Stage executors and the helpers they share.

Counterparts of the reference package's ``ops/stages.py``.  Each planned
stage gets a batched executor: ``apply(x[C, N]) -> y[C, M]`` with
M = stage_out_len(spec, N), plus the two seam protocols of the chain:

* ``apply_v(x, n_valid)``: the valid-prefix protocol.  ``x[:, :n_valid]``
  is the logical input and columns beyond it are a previous stage's raw
  framing surplus; returns ``(buf, m)`` with the logical output in
  ``buf[:, :m]``.  For every kept output the banded operator reads only the
  valid prefix, so the surplus never reaches the result.
* ``apply_df(h, l, n_valid, emit_pair)``: the df32 inter-stage carry of
  the guarantee chain.  Stages hand raw (hi float32, lo bfloat16) pair
  buffers plus the logical count across the seams, so the per-seam
  float32 store rounding never happens; only the chain's last output
  rounds.  Returns ``(h, l, n_out)``.

Ported so far, for every [conv, whole-frac] plan:

* ``ConvExec``: the ozaki (error-free split-operand) engine on
  ``ozaki_framed`` (ops/pallas_ozaki.py); the df32-FFT guarantee engines
  ``pallas_fft5``, ``pallas_fft4``, ``pallas_fft`` and, under
  ``precision="high"``, ``fft`` on ``df_fft_conv`` (ops/pallas_dfft.py),
  the FP64 overlap-save kernel, with the reference's engine and geometry
  choices; ``fft`` otherwise is ``torch.fft.rfft`` in float32 (hi + lo
  spectrum) or float64.
* ``FracWholeExec``: the ozaki engine, and the ``im2col`` engine (and the
  float64 ``conv`` engine, the same contraction) on ``frac_whole``
  (ops/pallas_frac.py) with the float32 operator residual and 8-term
  folds under ``precision="high"``.

Each kernel wrapper runs the CUDA kernel on a CUDA tensor and its plain
version on a CPU tensor.  Every other engine and stage kind raises
NotImplementedError naming the ROADMAP.md item that ports it; the fast
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

__all__ = ["truncate_residual", "ConvExec", "FracWholeExec", "build_exec",
           "FFT_ENGINES"]

#: ConvExec's FFT engines: df_fft_conv under precision "high".
FFT_ENGINES = ("fft", "pallas_fft", "pallas_fft4", "pallas_fft5")


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
    if precision not in ("fast", "high"):
        raise ValueError(f"precision must be 'fast' or 'high', got "
                         f"{precision!r}")


class ConvExec(nn.Module):
    """Convolver with integer up/down resampling.

    Content semantics (the oracle's): u = zero-stuffed input, w = kernel
    (*) u (causal), y[r] = w[r*down + offset], r in [0, M).

    Engines:
      * "ozaki": the polyphase superkernel SK[j, d] makes y[m*up + j] =
        sum_d SK[j, d] * x[m*down + s_min + d]; B_toep consecutive cycles
        form one banded Toeplitz operator [L_f, B_toep*up], applied as a
        framed matmul at hop B_toep*down in the error-free split form.
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
      * "auto": "fft" in float64; float32's toeplitz engine is not ported.
    """

    def __init__(self, spec: ConvStage, dtype=torch.float32,
                 precision: str = "high", B: int = 256,
                 engine: str = "ozaki"):
        super().__init__()
        if engine == "auto":
            engine = "fft" if dtype == torch.float64 else "toeplitz"
        if engine != "ozaki" and engine not in FFT_ENGINES:
            raise _unported("ConvStage", engine)
        self.spec = spec
        self.dtype = dtype
        self.engine = engine
        self.framed5 = self.framed5_poly = False
        k = np.asarray(spec.filt.kernel, dtype=np.float64)
        self.K = k.shape[0]
        if engine == "ozaki":
            _check_ozaki(dtype, precision)
            self._build_direct(k)
            self._build_ozaki(B)
        else:
            self._build_fft(k, precision)

    def _build_fft(self, k: np.ndarray, precision: str, ext: int = 2):
        """The reference's FFT geometry (its ConvExec.__init__): nfft =
        max(128, next_pow2(P) << ext), doubled while the saved overlap P
        exceeds the hop; the engines' plans and spectra."""
        spec, engine = self.spec, self.engine
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got "
                            f"{self.dtype}")
        if precision not in ("fast", "high"):
            raise ValueError(f"precision must be 'fast' or 'high', got "
                             f"{precision!r}")
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
        so that y[m*up + j] = sum_d SK[j, d] * x[m*down + s_min + d]."""
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

    def _build_ozaki(self, B: int):
        """Split form of the banded-Toeplitz operator (ops/ozaki.py): the
        block count B halves while B*down > 2*D, down to 128."""
        up, down = self.spec.up, self.spec.down
        D = self.D_direct
        while B * down > 2 * D and B > 128:
            B //= 2
        L_f = (B - 1) * down + D
        T = np.zeros((L_f, B * up), dtype=np.float64)
        for t in range(B):
            for j in range(up):
                T[t * down : t * down + D, t * up + j] = self._sk64[j]
        parts, self.oz_scale = split_operator_host(T)
        self.register_buffer("oz_parts", parts)
        self.oz_Lf = L_f
        self.B_toep = B

    def geometry(self, M: int):
        """(L_f, hop, Kcols, n_blocks) of the framed product behind M
        outputs: blocks of B_toep cycles, each cycle ``up`` outputs."""
        B, up = self.B_toep, self.spec.up
        n_blocks = -(-(-(-M // up)) // B)
        return self.oz_Lf, B * self.spec.down, B * up, n_blocks

    def _apply_ozaki(self, x: torch.Tensor, M: int, raw: bool = False,
                     x_lo=None, pair: bool = False):
        N = x.shape[1]
        L_f, hop, Kcols, n_blocks = self.geometry(M)
        pad_l = max(0, -self.s_min)
        n_seg = -(-L_f // hop)
        need = (n_blocks + n_seg) * hop
        pad_r = max(0, need - (N - self.s_min))
        start = self.s_min + pad_l
        xp = F.pad(x.float(), (pad_l, pad_r))[:, start:]
        xl = None
        if x_lo is not None:  # bf16 seam-residual stream: keep its dtype
            xl = F.pad(x_lo, (pad_l, pad_r))[:, start:]
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

    def apply_v(self, x: torch.Tensor, n_valid: int):
        M = self.out_len(n_valid)
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
        if self.engine == "ozaki":
            return self._apply_ozaki(x, M)
        return self._apply_fft(x, M)

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
    would otherwise share one partial) under ``precision="high"``; "conv",
    the same contraction in float64 (the reference's strided convolution;
    its float32 form is not ported); "auto", the reference's rule:
    "im2col" in float32 when D <= 4*I, else "conv"."""

    def __init__(self, spec: FracStage, dtype=torch.float32,
                 precision: str = "high", engine: str = "ozaki"):
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
        self.pad_l = max(0, -self.a0)
        if engine == "auto":
            engine = ("im2col" if dtype == torch.float32 and D <= 4 * I
                      else "conv")
        self.engine = engine
        if engine == "ozaki":
            _check_ozaki(dtype, precision)
            parts, self.oz_scale = split_operator_host(
                np.ascontiguousarray(sk.T))
            self.register_buffer("oz_parts", parts)
        elif engine == "im2col" or (engine == "conv"
                                    and dtype == torch.float64):
            if dtype not in (torch.float32, torch.float64):
                raise TypeError(f"dtype must be float32 or float64, got "
                                f"{dtype}")
            if precision not in ("fast", "high"):
                raise ValueError(f"precision must be 'fast' or 'high', got "
                                 f"{precision!r}")
            np_dt = np.float32 if dtype == torch.float32 else np.float64
            skT = np.ascontiguousarray(sk.T)
            self.register_buffer("skT", torch.from_numpy(skT.astype(np_dt)))
            lo = None
            if precision == "high" and dtype == torch.float32:
                lo = torch.from_numpy((skT - skT.astype(np.float32).astype(
                    np.float64)).astype(np.float32))
            self.register_buffer("skT_lo", lo)
            self.kc = KC if lo is None else KC_LO
        else:
            raise _unported(f"{dtype} whole-stepping FracStage", engine)

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

    def geometry(self, M: int):
        """(L_f, hop, Kcols, n_blocks) of the framed product behind M
        outputs: windows of D samples at stride in_step, out_step outputs
        each."""
        O = self.spec.out_step
        return self.D, self.spec.in_step, O, -(-M // O)

    def _frame(self, x: torch.Tensor, M: int, x_lo=None):
        """(xp, xl): the signal padded so that xp[:, m*I : m*I + D] is
        window m (float32 for the ozaki engine, else the stage's dtype),
        and the bfloat16 seam residual ``x_lo`` padded alike (or None)."""
        D, I, _O, n_cyc = self.geometry(M)
        need = self.a0 + (n_cyc + -(-D // I)) * I
        pad = (self.pad_l, max(0, need - x.shape[1]))
        start = self.a0 + self.pad_l
        dt = torch.float32 if self.engine == "ozaki" else self.dtype
        xp = F.pad(x.to(dt), pad)[:, start:]
        xl = None if x_lo is None else F.pad(x_lo, pad)[:, start:]
        return xp, xl

    def _scale(self, xp: torch.Tensor, M: int) -> torch.Tensor:
        """Per-channel power-of-two scales over the windows (ozaki)."""
        D, I, _O, n_cyc = self.geometry(M)
        return channel_scale(xp[:, : (n_cyc - 1) * I + D])

    def _run(self, x: torch.Tensor, M: int) -> torch.Tensor:
        xp, _ = self._frame(x, M)
        if self.engine != "ozaki":
            D, I, O, n_cyc = self.geometry(M)
            return frac_whole(xp, self.skT, I, D, O, n_cyc,
                              skT_lo=self.skT_lo, kc=self.kc)[:, :M]
        return ozaki_framed(xp, self._scale(xp, M), self.oz_parts,
                            *self.geometry(M))[:, :M]

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


_ENGINE_ITEMS = {
    "toeplitz": "queue 1 item 3 (the float32 toeplitz engine)",
    "conv": "queue 1 item 3 (the float32 conv engine)",
    "direct": "queue 1 item 11", "toeplitz_sym": "queue 1 item 11",
    "pallas": "queue 1 item 11",
}


def _unported(what: str, engine: str):
    item = _ENGINE_ITEMS.get(engine, "queue 1")
    return NotImplementedError(f"{what} with engine {engine!r} is not "
                               f"ported yet (ROADMAP.md {item})")


def build_exec(spec, dtype=torch.float32, precision: str = "fast",
               conv_engine: str = "auto", frac_engine: str = "auto"):
    """The executor of one planned stage: ``ConvExec`` and
    ``FracWholeExec`` with the engines they port; anything else raises
    NotImplementedError naming its ROADMAP.md item."""
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
