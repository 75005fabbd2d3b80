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

Ported so far: the ozaki (error-free split-operand) engine of ``ConvExec``
and of ``FracWholeExec``, which run every [conv, whole-frac] guarantee
plan.  Their contraction is ``ozaki_framed`` (ops/pallas_ozaki.py): the
CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.  Every
other engine and stage kind raises NotImplementedError naming the
ROADMAP.md item that ports it; the fast flagship runs through the fused
executor (ops/fused.py) instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.lengths import stage_out_len
from ..models.plan import ConvStage, FracStage, HBDownStage, HBUpStage
from .ozaki import channel_scale, framed_cheap, split_operator_host
from .pallas_ozaki import ozaki_framed

__all__ = ["truncate_residual", "ConvExec", "FracWholeExec", "build_exec"]


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
            f"the ozaki engine runs in float32 only (got {dtype}); the "
            f"float64 engines are ROADMAP.md queue 1 items 3 and 8")
    if precision not in ("fast", "high"):
        raise ValueError(f"precision must be 'fast' or 'high', got "
                         f"{precision!r}")


class ConvExec(nn.Module):
    """Convolver with integer up/down resampling, ozaki engine.

    Content semantics (the oracle's): u = zero-stuffed input, w = kernel
    (*) u (causal), y[r] = w[r*down + offset], r in [0, M).  The polyphase
    superkernel SK[j, d] makes y[m*up + j] = sum_d SK[j, d] *
    x[m*down + s_min + d]; B_toep consecutive cycles form one banded
    Toeplitz operator [L_f, B_toep*up], applied as a framed matmul at hop
    B_toep*down in the error-free split form (the backend-independent
    -141 dB guarantee)."""

    def __init__(self, spec: ConvStage, dtype=torch.float32,
                 precision: str = "high", B: int = 256):
        super().__init__()
        _check_ozaki(dtype, precision)
        self.spec = spec
        self.dtype = dtype
        k = np.asarray(spec.filt.kernel, dtype=np.float64)
        self.K = k.shape[0]
        self._build_direct(k)
        self._build_ozaki(B)

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

    def apply_v(self, x: torch.Tensor, n_valid: int):
        M = self.out_len(n_valid)
        if M > 0:
            return self._apply_ozaki(x, M, raw=True), M
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
        return self._apply_ozaki(x, M)

    forward = apply


class FracWholeExec(nn.Module):
    """Whole-stepping fractional interpolator, ozaki engine.

    For output n = m*O + j (O = out_step, I = in_step):
        g_j = W0 + j*I;  f_j = g_j mod O;  s_j = g_j // O
        y[n] = sum_i bank[f_j][i] * x[s_j + m*I - (fl2 - 1) + i]
    Rows of the superkernel SK[j] hold bank[f_j] at offset s_j - s_0, so
    y[:, m*O + j] = sum_d SK[j, d] * x[m*I + a0 + d]: a framed matmul at
    stride I with O output columns, here in the error-free split form."""

    def __init__(self, spec: FracStage, dtype=torch.float32,
                 precision: str = "high"):
        super().__init__()
        if not spec.is_whole:
            raise ValueError("FracWholeExec needs a whole-stepping stage")
        _check_ozaki(dtype, precision)
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
        parts, self.oz_scale = split_operator_host(np.ascontiguousarray(sk.T))
        self.register_buffer("oz_parts", parts)
        self.D = D
        self.pad_l = max(0, -self.a0)

    def out_len(self, n_in: int) -> int:
        return stage_out_len(self.spec, n_in)

    def geometry(self, M: int):
        """(L_f, hop, Kcols, n_blocks) of the framed product behind M
        outputs: windows of D samples at stride in_step, out_step outputs
        each."""
        O = self.spec.out_step
        return self.D, self.spec.in_step, O, -(-M // O)

    def _frame(self, x: torch.Tensor, M: int, x_lo=None):
        """(xp, sx, xl): the float32 signal padded so that xp[:, m*I :
        m*I + D] is window m, its per-channel scales over the windows, and
        the bfloat16 seam residual ``x_lo`` padded alike (or None)."""
        D, I, _O, n_cyc = self.geometry(M)
        need = self.a0 + (n_cyc + -(-D // I)) * I
        pad = (self.pad_l, max(0, need - x.shape[1]))
        start = self.a0 + self.pad_l
        xp = F.pad(x.float(), pad)[:, start:]
        xl = None if x_lo is None else F.pad(x_lo, pad)[:, start:]
        return xp, channel_scale(xp[:, : (n_cyc - 1) * I + D]), xl

    def _run(self, x: torch.Tensor, M: int) -> torch.Tensor:
        xp, sx, _ = self._frame(x, M)
        return ozaki_framed(xp, sx, self.oz_parts, *self.geometry(M))[:, :M]

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
        """df32 carry (see ConvExec.apply_df).  As the last stage of a
        chain it consumes the seam residual with one segmented bfloat16
        pass (``framed_cheap``) while the kernel emits its (hi, lo) pair,
        so the collapse hi + (lo + cheap) rounds once (adding the residual
        to a collapsed output would round twice: -149.5 against -151.9 dB
        on the flagship in the reference package)."""
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
        if l is None and not emit_pair:
            return self._run(h, M), None, M
        geo = self.geometry(M)
        _D, I, _O, n_cyc = geo
        xp, sx, xl = self._frame(h, M, l)
        if not emit_pair:
            cheap = framed_cheap(xl, self.oz_parts[0], n_cyc, I)
            yh, yl = ozaki_framed(xp, sx, self.oz_parts, *geo, emit_pair=True)
            y = yh + (yl.float() + cheap.reshape(C, -1))
            return y[:, :M], None, M
        yh, yl = ozaki_framed(xp, sx, self.oz_parts, *geo, x_lo=xl,
                              emit_pair=True)
        return yh[:, :M], yl[:, :M], M


_ENGINE_ITEMS = {
    "auto": "queue 1 item 3 (toeplitz and im2col engines)",
    "toeplitz": "queue 1 item 3", "im2col": "queue 1 item 3",
    "conv": "queue 1 item 3", "fft": "queue 1 item 8",
    "pallas_fft": "queue 1 item 8", "pallas_fft4": "queue 1 item 8",
    "pallas_fft5": "queue 1 item 8", "direct": "queue 1 item 11",
    "toeplitz_sym": "queue 1 item 11", "pallas": "queue 1 item 11",
}


def _unported(what: str, engine: str):
    item = _ENGINE_ITEMS.get(engine, "queue 1")
    return NotImplementedError(f"{what} with engine {engine!r} is not "
                               f"ported yet (ROADMAP.md {item})")


def build_exec(spec, dtype=torch.float32, precision: str = "fast",
               conv_engine: str = "auto", frac_engine: str = "auto"):
    """The executor of one planned stage.  Only the ozaki engine of the
    convolver and of the whole-stepping interpolator is ported; anything
    else raises NotImplementedError naming its ROADMAP.md item."""
    if isinstance(spec, ConvStage):
        if conv_engine != "ozaki":
            raise _unported("ConvStage", conv_engine)
        return ConvExec(spec, dtype, precision)
    if isinstance(spec, (HBUpStage, HBDownStage)):
        raise NotImplementedError(
            f"{spec.kind} stages are not ported yet (ROADMAP.md queue 1 "
            f"item 3; their ozaki engine item 7)")
    if isinstance(spec, FracStage):
        if not spec.is_whole:
            raise NotImplementedError(
                "polynomial-mode interpolation is not ported yet (ROADMAP.md "
                "queue 1 item 4; its ozaki products item 7)")
        if frac_engine != "ozaki":
            raise _unported("whole-stepping FracStage", frac_engine)
        return FracWholeExec(spec, dtype, precision)
    raise TypeError(spec)
