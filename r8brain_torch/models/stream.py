"""Push-mode streaming resampler (CDSPResampler::process equivalent).

Counterpart of the reference package's ``models/stream.py``.  The
reference's ``process(ip, l, op&)`` is sample-serial with internal ring
buffers (CDSPResampler.h:559-575); here the whole-array stage chain runs
over fixed-size *blocks* with a carried device-side history window:

* Plans with a finite shift-invariance period (every rational rate pair,
  ``parallel/sharding.chain_shift_period``) stream with period-aligned
  blocks: after the first block every block runs the same chain on a
  window of H + L samples and emits exactly ``L * dst/src`` samples.  The
  carried state is the last H input samples (H >= the chain's dependency
  span), the explicit-carry form of the reference's per-stage ring
  buffers.  k blocks at once run the chain ONCE on the k overlapping
  windows stacked as a [k*C, H+L] batch: every kernel treats its rows
  independently, so each block's arithmetic is that of a per-block call
  (bit-equal) and each kernel launches once per k blocks.
* Plans with a polynomial-mode interpolator stream the rational prefix the
  same way and drive the interpolator with read positions computed on the
  host for each block (the resettable-counter timing of
  CDSPFracInterpolator.h:907-919); the interpolator's float64 spline
  values are evaluated on the device from those positions, rounded once
  (and split, for the guarantee chain) exactly as the oneshot's operators
  are.  A suffix after the interpolator (conv up and half-band 2X: the
  intermediate-interpolation branch, CDSPResampler.h:286-324) is integer
  upsampling, shift-invariant under every integer shift, so the
  interpolator's varying per-block counts re-block onto the suffix's own
  block grid through a device ring (``_SufReblock``).

Every count is known on the host, so nothing on the stream's path reads a
device value back.  The streamed output equals the oneshot over the same
total input (float64: to its rounding; tests/test_torch_stream.py).
"""

from __future__ import annotations

import functools
import math
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused import FusedUpExec, fuse_stage_list
from ..ops.dfloat import two_sum
from ..ops.hb_cascade import HBUpCascadeExec
from ..ops.stages import build_exec, poly_contract
from ..parallel.sharding import chain_input_span, chain_shift_period
from .lengths import chain_out_len, frac_positions, stage_out_len
from .plan import FracStage, Plan
from .resampler import Resampler, run_chain, set_folds

__all__ = ["StreamResampler"]

#: Output groups from which the polynomial tail gives each span of
#: ``TAIL_SPAN_GROUPS`` groups its own window base (k-block calls): one
#: base for a long span would widen every group's window by the offsets'
#: drift.
TAIL_SPAN_MIN = 256
TAIL_SPAN_GROUPS = 64
#: Zero margin left of the polynomial tail's window, past S + fl (the
#: reference's static margin): every span base must land at or right of
#: it.
TAIL_MARGIN = 64


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _opt(f, t):
    """f(t) for a tensor, None for None (a pair's absent lo stream)."""
    return None if t is None else f(t)


def _subplan(plan: Plan, stages) -> Plan:
    return Plan(plan.src_rate, plan.dst_rate, plan.trans_band, plan.atten,
                plan.phase, tuple(stages), plan.latency_frac)


def _sub_execs(rs: Resampler, stages):
    """Executors for ``stages``, a run of ``rs.plan.stages``: the parent's
    own when the run is the whole plan or the parent runs one executor a
    stage; else a fused sub-plan when the parent fused, or one
    ``build_exec`` a stage with the parent's engines (and its folds)."""
    plan_stages = rs.plan.stages
    if len(rs.execs) == len(plan_stages):
        i0 = next(i for i, s in enumerate(plan_stages) if s is stages[0])
        return list(rs.execs[i0 : i0 + len(stages)])
    if len(stages) == len(plan_stages):
        return list(rs.execs)
    build = functools.partial(build_exec, conv_engine=rs.conv_engine,
                              frac_engine=rs.frac_engine)
    execs = None
    if any(isinstance(e, (FusedUpExec, HBUpCascadeExec)) for e in rs.execs):
        execs = fuse_stage_list(_subplan(rs.plan, stages), rs.dtype,
                                rs.precision, build, engine=rs.conv_engine)
    if execs is None:
        execs = [build(s, rs.dtype, rs.precision) for s in stages]
    set_folds(execs, rs.conv_kc, rs.fold_kc)
    return [e.to(rs.device) for e in execs]


class _PeriodStream:
    """Streaming executor for a chain with shift period (p_in, p_out).

    Under the df32 carry a piece of a split chain carries the pair across
    its own ends: ``emit_pair`` (a prefix before the interpolator) hands
    back the last stage's (hi, lo), and a suffix takes its input's lo
    stream beside it (``process_blocks(..., xk_lo)``)."""

    def __init__(self, rs: Resampler, stages, block_len: int, p_in: int,
                 p_out: int, span: int, emit_pair: bool = False):
        self.execs = _sub_execs(rs, stages)
        self.stages = stages
        self.p_in, self.p_out = p_in, p_out
        L = _round_up(max(block_len, 2 * p_in), p_in)
        H = _round_up(span + 64, p_in)
        # steady-state latency in output samples: n*r - out_len(n) is
        # constant for period-aligned n past warmup
        n0 = _round_up(H + L + span, p_in)
        lat_o = n0 * p_out // p_in - chain_out_len(stages, n0)
        # the first block must complete the chain warmup: its emission
        # count must already be on the steady-state line, else every later
        # block's slice would be misplaced
        L = self._steady_len(L, p_in, p_out, span, lat_o)
        W0 = H * p_out // p_in - lat_o
        while W0 < 0:
            H += _round_up(-W0 * p_in // p_out + p_in, p_in)
            W0 = H * p_out // p_in - lat_o
        # the first block must carry the FULL real history: a left-zero-
        # padded first history would switch the stream head to mid-stream
        # (zero-prefixed) semantics, which differ from the fresh-start
        # chain in the first ~span outputs (later stages read their
        # predecessors' pre-start look-ahead); so L grows to H
        if L < H:
            L = self._steady_len(_round_up(H, p_in), p_in, p_out, span,
                                 lat_o)
        self.L, self.H, self.W0 = L, H, W0
        self.out_per_block = L * p_out // p_in
        # the df32 carry runs within each block's chain (blocks recompute
        # from the carried raw input window, so block boundaries add no
        # rounding)
        self.df_carry = rs.df_carry
        self.emit_pair = emit_pair and self.df_carry
        self.reset()

    def _steady_len(self, L, p_in, p_out, span, lat_o):
        for _ in range(64):
            m = chain_out_len(self.stages, L)
            if m > 0 and m == L * p_out // p_in - lat_o:
                return L
            L += _round_up(max(p_in, span), p_in)
        raise AssertionError("cannot reach steady state; plan too deep")

    def reset(self):
        self.hist = self.hist_lo = None
        self.n_in = 0

    def _chain(self, x, x_lo):
        """(y, y_lo) of the chain on x (and its residual stream x_lo)."""
        if self.emit_pair:
            return run_chain(self.execs, x, True, x_lo, emit_pair=True)
        return run_chain(self.execs, x, self.df_carry, x_lo), None

    def process_blocks(self, xk: torch.Tensor, k: int, xk_lo=None):
        """xk [C, k*L] of k consecutive blocks (xk_lo: their residual
        stream, or None) -> (y, y_lo): their outputs [C, k*out_per_block]
        (fewer for the stream's first block, which runs the chain from
        absolute zero), y_lo the residual stream under ``emit_pair``,
        else None."""
        L, H = self.L, self.H
        if self.hist is None:
            head, head_lo = xk[:, :L], _opt(lambda t: t[:, :L], xk_lo)
            y0 = self._chain(head, head_lo)
            self.hist = head[:, L - H :].clone()
            self.hist_lo = _opt(lambda t: t[:, L - H :].clone(), head_lo)
            self.n_in = L
            if k == 1:
                return y0
            y1 = self.process_blocks(xk[:, L:], k - 1,
                                     _opt(lambda t: t[:, L:], xk_lo))
            return tuple(None if a is None else torch.cat([a, b], dim=1)
                         for a, b in zip(y0, y1))
        if xk_lo is not None and self.hist_lo is None:
            self.hist_lo = torch.zeros_like(self.hist, dtype=xk_lo.dtype)
        C = xk.shape[0]

        def windows(hist, x):
            # the k windows [hist | x_1 .. x_k][j*L : j*L + H + L],
            # block-major
            full = torch.cat([hist, x], dim=1)
            return (full.unfold(1, H + L, L).transpose(0, 1)
                    .reshape(k * C, H + L), full[:, k * L :].clone())

        win, self.hist = windows(self.hist, xk)
        win_lo = None
        if xk_lo is not None:
            win_lo, self.hist_lo = windows(self.hist_lo, xk_lo)
        self.n_in += k * L

        def blocks(y):
            y = y[:, self.W0 : self.W0 + self.out_per_block]
            return y.reshape(k, C, -1).transpose(0, 1).reshape(C, -1)

        y, y_lo = self._chain(win, win_lo)
        return blocks(y), _opt(blocks, y_lo)


def _check_span_bases(a0s: np.ndarray, need: int, length: int) -> None:
    """Every span window [a0, a0 + need) lies inside the padded window of
    ``length`` samples (a negative slice start would wrap in PyTorch)."""
    assert int(a0s.min()) >= 0, \
        f"poly tail span base {int(a0s.min())} left of the padded window"
    assert int(a0s.max()) + need <= length, \
        f"poly tail span [{int(a0s.max())}, +{need}) past the padded " \
        f"window's {length} samples"


class _PolyTailStream:
    """Streaming polynomial interpolator: positions timed on the host, the
    parent's executor's geometry, precision class, operators and taps
    (``FracPolyExec.operators`` / ``gather_taps``) on the device."""

    def __init__(self, ex, emit_pair: bool = False):
        self.exec = ex
        self.spec = spec = ex.spec
        #: hand a suffix the (hi, lo) pair of the df32 carry
        self.emit_pair = emit_pair
        r = spec.src_rate / spec.dst_rate
        self.H = spec.filter_len + int(math.ceil(r)) + 8
        #: calls by path: "single" (one window base), "spans" (a base a
        #: span of TAIL_SPAN_GROUPS groups), "gather" (one gather a tap)
        self.paths = Counter()
        self.reset()

    def reset(self):
        self.n_in = 0  # post-skip input samples received
        self.m_out = 0  # outputs emitted
        self.skip_left = self.spec.in_latency
        self.buf = self.buf_lo = None  # [C, H] history; absolute end n_in

    def process(self, z: torch.Tensor, z_lo=None):
        """z [C, n] interpolator input (z_lo: the prefix's residual stream
        under the df32 carry, or None) -> (y, y_lo): the outputs it
        completes, and their residual stream under ``emit_pair``."""
        C, n = z.shape
        if self.skip_left > 0:
            d = min(self.skip_left, n)
            z, z_lo, n = z[:, d:], _opt(lambda t: t[:, d:], z_lo), n - d
            self.skip_left -= d
        if n == 0:
            return z.new_zeros((C, 0)), None
        if self.buf is None:
            self.buf = z.new_zeros((C, self.H))
        window = torch.cat([self.buf, z], dim=1)
        self.buf = window[:, -self.H :].clone()
        window_lo = None
        if z_lo is not None:
            if self.buf_lo is None:
                self.buf_lo = z_lo.new_zeros((C, self.H))
            window_lo = torch.cat([self.buf_lo, z_lo], dim=1)
            self.buf_lo = window_lo[:, -self.H :].clone()
        base = self.n_in - self.H  # absolute index of window[:, 0]
        self.n_in += n
        m_avail = stage_out_len(self.spec, self.n_in + self.spec.in_latency)
        count = m_avail - self.m_out
        if count <= 0:
            return z.new_zeros((C, 0)), None
        s, f = frac_positions(self.spec, self.m_out, count)
        fr = f * self.exec.fracs
        fti = np.floor(fr)
        t64 = fr - fti  # the exact float64 phase
        start = s - self.exec.fll - base
        assert start.min() >= 0, "poly window underrun"
        assert start.max() + self.exec.fl <= window.shape[1]
        self.m_out = m_avail
        if self.exec.engine == "gather":
            if window_lo is not None:  # no carry path: collapse the pair
                window = window + window_lo
            self.paths["gather"] += 1
            return self.exec.gather(window, *self.exec.gather_taps(
                start, fti, t64, window.device)), None
        return self._banded(window, window_lo, start, fti, t64, count)

    def _geometry(self, start, count: int, P: int):
        """Spans of P groups of G outputs: (n_span, each span's base a0s in
        the window padded by S + fl + TAIL_MARGIN, the group-local offsets
        off [n_span, P, G], W).  The positions past ``count`` continue on
        the S/G grid, so padded outputs read the window's zero margin and
        do not widen W."""
        ex = self.exec
        G, S = ex.G, ex.S
        n_span = -(-(-(-count // G)) // P)  # ceil(groups / P)
        padG = n_span * P * G - count
        jpad = np.arange(1, padG + 1, dtype=np.int64)
        sr = np.concatenate([start.astype(np.int64),
                             int(start[-1]) + (jpad * S) // G])
        rel = sr.reshape(n_span, P, G) - (np.arange(P)[:, None] * S)
        A0s = rel.min(axis=(1, 2))
        off = rel - A0s[:, None, None]
        W = _round_up(int(off.max()) + ex.fl, 32)
        return n_span, A0s + (S + ex.fl + TAIL_MARGIN), off, W

    def _banded(self, window, window_lo, start, fti, t64, count: int):
        """The banded contraction of the oneshot engine on this call's
        groups: one window base for fewer than TAIL_SPAN_MIN groups, else
        a base a span of TAIL_SPAN_GROUPS (fewer where the offsets' drift
        would widen W past the band or push a base left of the margin)."""
        ex = self.exec
        G, S, fl = ex.G, ex.S, ex.fl
        n_grp = -(-count // G)
        P = n_grp if n_grp < TAIL_SPAN_MIN else TAIL_SPAN_GROUPS
        while True:
            n_span, a0s, off, W = self._geometry(start, count, P)
            if P == 1 or (W <= 4 * ex.W + 256 and int(a0s.min()) >= 0):
                break
            P = min(P // 2, TAIL_SPAN_GROUPS)
        need = (P + -(-W // S)) * S
        padl = S + fl + TAIL_MARGIN
        _check_span_bases(a0s, need, padl + window.shape[1] + need)
        Mp = n_span * P * G
        padG = Mp - count
        ops = ex.operators(
            np.pad(fti, (0, padG), mode="edge").reshape(n_span, P, G),
            np.pad(t64, (0, padG), mode="edge").reshape(n_span, P, G),
            off, W, window.device)

        def spans(w):
            wp = F.pad(w, (padl, need))
            if n_span == 1:
                return wp[None, :, int(a0s[0]) : int(a0s[0]) + need]
            return torch.stack([wp[:, a : a + need] for a in a0s.tolist()])

        o, small = poly_contract(spans(window), ops, P, S, W, ex.precision,
                                 x_lo=_opt(spans, window_lo),
                                 pair=self.emit_pair)
        self.paths["single" if n_span == 1 else "spans"] += 1
        C = window.shape[0]

        def outputs(v):  # [n_span, C, P, G] -> [C, count]
            return v.transpose(0, 1).reshape(C, Mp)[:, :count]

        if not self.emit_pair:
            return outputs(o if small is None else o + small), None
        # the pair of the df32 carry, normalized as FracPolyExec's
        hi, lo = two_sum(o, torch.zeros_like(o) if small is None
                         else small.float())
        return outputs(hi), outputs(lo.to(torch.bfloat16))


class _SufReblock:
    """Device ring re-blocking the interpolator's varying counts onto the
    suffix stream's fixed L2-sample blocks: each push writes its outputs
    at the (host-known) fill, runs every whole block in one call and moves
    the remainder to the front.  Under the df32 carry a second ring holds
    the residual stream."""

    def __init__(self, suf: _PeriodStream, cap: int, like: torch.Tensor,
                 like_lo=None):
        self.suf = suf
        self.L2 = suf.L
        self.cap = cap
        self.buf = like.new_zeros((like.shape[0], cap))
        self.buf_lo = _opt(lambda t: t.new_zeros((t.shape[0], cap)), like_lo)
        self.fill = 0

    def grown(self, cap: int) -> "_SufReblock":
        """A ring of capacity ``cap`` holding this one's fill."""
        ring = _SufReblock(self.suf, cap, self.buf, self.buf_lo)
        ring.buf[:, : self.fill] = self.buf[:, : self.fill]
        if self.buf_lo is not None:
            ring.buf_lo[:, : self.fill] = self.buf_lo[:, : self.fill]
        ring.fill = self.fill
        return ring

    def contents(self):
        """(hi, lo) of the filled part, or None when empty."""
        if not self.fill:
            return None
        return (self.buf[:, : self.fill],
                _opt(lambda t: t[:, : self.fill], self.buf_lo))

    def push(self, y: torch.Tensor, y_lo=None) -> Optional[torch.Tensor]:
        """y [C, w] (all valid; y_lo its residual stream under the carry)
        -> the suffix outputs of every block the ring now fills, or
        None."""
        w = y.shape[1]
        assert self.fill + w <= self.cap, \
            f"suffix ring overflow: fill {self.fill} + {w} > {self.cap}"
        if y_lo is not None and self.buf_lo is None:
            self.buf_lo = y_lo.new_zeros(self.buf.shape)
        self.buf[:, self.fill : self.fill + w] = y
        if self.buf_lo is not None:
            self.buf_lo[:, self.fill : self.fill + w] = 0 if y_lo is None \
                else y_lo
        self.fill += w
        m = self.fill // self.L2
        if m == 0:
            return None
        n = m * self.L2
        out, _ = self.suf.process_blocks(
            self.buf[:, :n], m, _opt(lambda t: t[:, :n], self.buf_lo))
        rest = self.fill - n
        if rest:
            self.buf[:, :rest] = self.buf[:, n : self.fill].clone()
            if self.buf_lo is not None:
                self.buf_lo[:, :rest] = self.buf_lo[:, n : self.fill].clone()
        self.fill = rest
        return out


class StreamResampler:
    """Chunked push-mode front-end over a Resampler's plan, on its device
    and in its dtype and precision class.

    process(x[C, n]) accepts arbitrary chunk lengths (arrays or tensors)
    and returns, as a tensor on the stream's device, all output samples
    computable so far; flush() drains the pipeline's latency tail with
    zero input (CDSPResampler.h:592-651 zero-flush semantics).
    process_block_device / process_blocks_device take whole blocks
    (``block`` samples, or k of them at once) and keep everything on the
    device; get_state / set_state checkpoint the stream as host arrays.
    """

    def __init__(self, rs: Resampler, block_len: int = 8192):
        self.rs = rs
        self.plan = rs.plan
        self.device = rs.device
        self.dtype = rs.dtype
        self._tail = self._suf = self._ring = self._suf_pending = None
        self._n_in_total = self._n_out_total = 0
        self._pending = None  # [C, < block] on the device
        self._channels = None
        self._squeeze = False
        stages = self.plan.stages
        period = chain_shift_period(self.plan)
        if period is not None or not stages:
            self._mode = "period"
            self._core = _PeriodStream(
                rs, stages, block_len, *period,
                chain_input_span(self.plan)) if stages else None
            self.block = self._core.L if stages else max(1, block_len)
            return
        # split the chain at its (single) polynomial interpolator: the
        # prefix is rational (periodic), the suffix, when present, integer
        # upsampling (period 1), re-blocked on its own grid
        poly = [i for i, s in enumerate(stages)
                if isinstance(s, FracStage) and not s.is_whole]
        assert len(poly) == 1
        pi = poly[0]
        prefix, suffix = stages[:pi], stages[pi + 1 :]
        pperiod = chain_shift_period(_subplan(self.plan, prefix))
        if pperiod is None:
            raise NotImplementedError(
                "streaming needs a rational-prefix plan; use oneshot")
        self._mode = "poly"
        # under the df32 carry the pair crosses the interpolator's seams,
        # as in the oneshot chain
        self._core = _PeriodStream(
            rs, prefix, block_len, *pperiod,
            chain_input_span(_subplan(self.plan, prefix)),
            emit_pair=True) if prefix else None
        self.block = self._core.L if prefix else max(1, block_len)
        self._tail = _PolyTailStream(_sub_execs(rs, [stages[pi]])[0],
                                     emit_pair=bool(suffix) and rs.df_carry)
        if suffix:
            sub = _subplan(self.plan, suffix)
            speriod = chain_shift_period(sub)
            assert speriod is not None and speriod[0] == 1, \
                "suffix after a polynomial stage must be integer-upsampling"
            self._suf = _PeriodStream(rs, suffix, block_len, *speriod,
                                      chain_input_span(sub))

    def geometry(self) -> dict:
        """The block geometry a checkpoint must match: the block, each
        period stream's L and H, the interpolator's history H."""
        g = {"block": self.block}
        for key, ps in (("core", self._core), ("suf", self._suf)):
            if ps is not None:
                g[f"{key}_L"], g[f"{key}_H"] = ps.L, ps.H
        if self._tail is not None:
            g["tail_H"] = self._tail.H
        return g

    def clear(self) -> None:
        """Reset to the stream start (CDSPResampler::clear)."""
        self._n_in_total = self._n_out_total = 0
        self._pending = None
        for ps in (self._core, self._suf):
            if ps is not None:
                ps.reset()
        if self._tail is not None:
            self._tail.reset()
        self._ring = self._suf_pending = None

    def _as_input(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=self.device, dtype=self.dtype)

    def _start(self, C: int, squeeze: bool) -> None:
        if self._channels is None:
            self._channels, self._squeeze = C, squeeze
        elif C != self._channels:
            raise ValueError(f"chunk has {C} channels, stream started with "
                             f"{self._channels}")

    def _run(self, xk: torch.Tensor, k: int) -> torch.Tensor:
        """k whole blocks [C, k*block] -> the outputs they complete: the
        one body of every entry point."""
        if self._core is None and self._mode == "period":
            return xk  # passthrough
        z, z_lo = self._core.process_blocks(xk, k) \
            if self._core is not None else (xk, None)
        if self._mode == "period":
            return z
        y, y_lo = self._tail.process(z, z_lo)
        return y if self._suf is None else self._suffix(y, y_lo)

    def _suffix(self, y: torch.Tensor, y_lo) -> torch.Tensor:
        """The interpolator's outputs through the suffix ring.  The ring
        grows before the push whenever its fill, a restored pending and
        this call's outputs would not fit."""
        pend = self._suf_pending
        if pend is None and not y.shape[1]:
            return y
        if pend is not None:
            p, p_lo = pend
            if y_lo is not None and p_lo is None:
                p_lo = torch.zeros_like(p, dtype=y_lo.dtype)
            y = torch.cat([p, y], dim=1)
            y_lo = _opt(lambda t: torch.cat([p_lo, t], dim=1), y_lo)
            self._suf_pending = None
        ring = self._ring
        fill = 0 if ring is None else ring.fill
        if ring is None or fill + y.shape[1] > ring.cap:
            cap = max(fill + y.shape[1], self._suf.L + 2 * y.shape[1])
            self._ring = ring = _SufReblock(self._suf, cap, y, y_lo) \
                if ring is None else ring.grown(cap)
        out = ring.push(y, y_lo)
        return y.new_zeros((y.shape[0], 0)) if out is None else out

    def _device_blocks(self, xk: torch.Tensor, k: int) -> torch.Tensor:
        if self._core is None and self._mode == "period":
            raise NotImplementedError(
                "device-resident streaming requires a non-empty plan")
        if self._pending is not None:
            raise RuntimeError(
                "cannot mix device block calls with a partial process() "
                "chunk still pending; feed whole blocks only")
        self._start(int(xk.shape[0]), False)
        self._n_in_total += k * self.block
        y = self._run(xk, k)
        self._n_out_total += y.shape[1]
        return y

    def process_block_device(self, x_block) -> torch.Tensor:
        """Push exactly ``block`` samples [C, block] and receive the
        emitted outputs on the device.  Rational plans emit a fixed count
        a block; polynomial plans a varying count, known on the host."""
        x = self._as_input(x_block)
        if x.dim() != 2 or x.shape[1] != self.block:
            raise ValueError(f"block must be [channels, {self.block}] (got "
                             f"{tuple(x.shape)})")
        return self._device_blocks(x, 1)

    def process_blocks_device(self, xk) -> torch.Tensor:
        """Push k consecutive blocks as one [C, k*block] tensor and receive
        all their outputs as one tensor: each kernel launches once for the
        k blocks.  Rational plans give k successive process_block_device
        calls' output bit for bit; the polynomial interpolator runs once
        over the k blocks' outputs (the same positions, contracted in
        spans of its groups)."""
        x = self._as_input(xk)
        L = self.block
        if x.dim() != 2 or x.shape[1] % L or x.shape[1] == 0:
            raise ValueError(f"batched block must be [channels, k*{L}] (got "
                             f"{tuple(x.shape)})")
        return self._device_blocks(x, x.shape[1] // L)

    def process(self, x) -> torch.Tensor:
        """x: [C, n] or [n] chunk -> [C, m] (or [m]) new outputs."""
        x = self._as_input(x)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        C = x.shape[0]
        self._start(C, squeeze)
        self._n_in_total += x.shape[1]
        buf = x if self._pending is None else torch.cat([self._pending, x],
                                                        dim=1)
        L = self.block
        n_blk = buf.shape[1] // L
        outs = [self._run(buf[:, i * L : (i + 1) * L], 1)
                for i in range(n_blk)]
        rest = buf[:, n_blk * L :]
        self._pending = rest.clone() if rest.shape[1] else None
        y = torch.cat(outs, dim=1) if outs else x.new_zeros((C, 0))
        self._n_out_total += y.shape[1]
        return y[0] if squeeze else y

    def flush(self, out_len: Optional[int] = None) -> torch.Tensor:
        """Feed zeros until ``out_len`` total outputs have been produced
        (default: floor(total_input * dst/src))."""
        if out_len is None:
            out_len = int(math.floor(
                self._n_in_total * self.plan.dst_rate / self.plan.src_rate))
        C = self._channels or 1
        outs = []
        sq, self._squeeze = self._squeeze, False
        for _ in range(10000):
            if self._n_out_total >= out_len:
                break
            outs.append(self.process(torch.zeros(
                (C, self.block), dtype=self.dtype, device=self.device)))
        y = torch.cat(outs, dim=1) if outs else torch.zeros(
            (C, 0), dtype=self.dtype, device=self.device)
        extra = self._n_out_total - out_len
        if extra > 0:
            y = y[:, : y.shape[1] - extra]
            self._n_out_total = out_len
        self._squeeze = sq
        return y[0] if sq else y

    # -- checkpoint / resume ----------------------------------------------
    # The carried state is small and explicit: the reference's would-be
    # checkpoint state is its ring buffers and position counters.  Host
    # arrays, so torch.save or np.savez can write it.

    def get_state(self) -> dict:
        """The stream's state as host arrays (numpy) and integers: the
        input pending a whole block, each period stream's history, the
        interpolator's counters and history, the suffix ring's contents;
        under the df32 carry also the residual streams ("*_lo")."""
        def host(t):  # bfloat16 residuals as float32 (exact)
            if t is None:
                return None
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu(
            ).numpy()

        st = {"geometry": self.geometry(),
              "n_in_total": self._n_in_total,
              "n_out_total": self._n_out_total,
              "pending": host(self._pending),
              "channels": self._channels, "squeeze": self._squeeze}
        if self._core is not None:
            st["core"] = {"hist": host(self._core.hist),
                          "n_in": self._core.n_in}
        if self._tail is not None:
            t = self._tail
            st["tail"] = {"n_in": t.n_in, "m_out": t.m_out,
                          "skip_left": t.skip_left, "buf": host(t.buf),
                          "buf_lo": host(t.buf_lo)}
        if self._suf is not None:
            parts = [p for p in (self._suf_pending, self._ring and
                                 self._ring.contents()) if p]
            hi = torch.cat([p[0] for p in parts], dim=1) if parts else None
            lo = None
            if any(p[1] is not None for p in parts):
                lo = torch.cat([torch.zeros_like(p[0], dtype=torch.bfloat16)
                                if p[1] is None else p[1] for p in parts],
                               dim=1)
            st["suf"] = {"hist": host(self._suf.hist),
                         "hist_lo": host(self._suf.hist_lo),
                         "n_in": self._suf.n_in, "pending": host(hi),
                         "pending_lo": host(lo)}
        return st

    def set_state(self, st: dict) -> None:
        """Resume from ``get_state`` (of this stream or of one with the
        same geometry, or a reference-package state carried across by
        ``convert.stream_state_from_reference``).  Absent residual
        streams resume as zeros."""
        if st.get("geometry") != self.geometry():
            raise ValueError(f"checkpoint geometry {st.get('geometry')} is "
                             f"not this stream's {self.geometry()}")

        def dev(a, dtype=None):
            if a is None:
                return None
            return torch.as_tensor(np.asarray(a)).to(
                device=self.device, dtype=dtype or self.dtype)

        lo = torch.bfloat16
        self._n_in_total = st["n_in_total"]
        self._n_out_total = st["n_out_total"]
        self._pending = dev(st["pending"])
        if self._pending is not None and not self._pending.shape[1]:
            self._pending = None
        self._channels = st["channels"]
        self._squeeze = st["squeeze"]
        if self._core is not None:
            self._core.hist = dev(st["core"]["hist"])
            self._core.hist_lo = None
            self._core.n_in = st["core"]["n_in"]
        if self._tail is not None:
            t, tl = self._tail, st["tail"]
            t.n_in, t.m_out = tl["n_in"], tl["m_out"]
            t.skip_left = tl["skip_left"]
            t.buf = dev(tl["buf"])
            t.buf_lo = dev(tl.get("buf_lo"), lo)
        if self._suf is not None:
            sf = st["suf"]
            self._suf.hist = dev(sf["hist"])
            self._suf.hist_lo = dev(sf.get("hist_lo"), lo)
            self._suf.n_in = sf["n_in"]
            p = dev(sf["pending"])
            self._suf_pending = None if p is None or not p.shape[1] else (
                p, dev(sf.get("pending_lo"), lo))
            self._ring = None
