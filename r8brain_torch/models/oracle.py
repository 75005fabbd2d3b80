"""CPU-exact oracle implementation of the planned resampling pipeline.

The port's own copy of the reference package's oracle: NumPy float64 on
the host over this package's plans (models/plan.py), the specification
that the device paths are held to, not a device path itself.

This is the float64 reference executor: it produces, sample for sample, the
same output stream as the C++ reference (r8brain-free-src CDSPResampler)
given the same plan — validated against goldens generated by compiling the
actual reference headers (see tools/make_goldens.cpp, tests/test_goldens.py).
It serves three purposes:
  1. the correctness oracle for the device path (-141 dB RMS bound),
  2. golden generation for CI where the C++ toolchain is unavailable,
  3. an executable specification of the content semantics documented in
     models/plan.py.

Each stage is implemented from its *content formula* (stateless LTI mapping
+ consumed latency), not from the reference's ring-buffer mechanics; the
streaming wrapper below feeds chunks and tracks absolute positions, which is
mathematically identical to the reference's incremental buffering
(overlap-save output is invariant to block segmentation).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .plan import (ConvStage, FracStage, HBDownStage, HBUpStage, Plan,
                   Stage, make_plan)

__all__ = ["OracleStage", "OracleResampler", "oneshot"]


class OracleStage:
    """Streaming wrapper: accumulates input history, emits all outputs whose
    dependency window is satisfied."""

    def __init__(self):
        self.n_in = 0  # total input samples received (post input-latency skip)
        self.n_out = 0  # total output samples emitted
        self.hist = np.zeros(0, dtype=np.float64)  # unconsumed + history
        self.hist_start = 0  # absolute index of hist[0]
        self.in_skip_left = 0  # input-side latency left to drop

    def reset(self):
        self.n_in = 0
        self.n_out = 0
        self.hist = np.zeros(0, dtype=np.float64)
        self.hist_start = 0
        self.in_skip_left = self.in_skip_init()

    # -- per-kind hooks --
    def in_skip_init(self) -> int:
        return 0

    def max_out_len(self, max_in: int) -> int:
        raise NotImplementedError

    def _emit(self) -> np.ndarray:
        """Compute outputs [n_out, n_out_new) from hist."""
        raise NotImplementedError

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if self.in_skip_left > 0:
            d = min(self.in_skip_left, x.shape[0])
            x = x[d:]
            self.in_skip_left -= d
        if x.shape[0]:
            self.hist = np.concatenate([self.hist, x])
            self.n_in += x.shape[0]
        y = self._emit()
        self.n_out += y.shape[0]
        self._trim()
        return y

    def _trim(self):
        keep = self.keep_hist()
        drop = max(0, self.hist.shape[0] - keep)
        if drop:
            self.hist = self.hist[drop:]
            self.hist_start += drop

    def keep_hist(self) -> int:
        raise NotImplementedError

    def _window(self, start_abs: int, length: int) -> np.ndarray:
        """hist samples [start_abs, start_abs+length), zero-padded on the
        left for negative absolute indices."""
        i0 = start_abs - self.hist_start
        if i0 >= 0:
            return self.hist[i0 : i0 + length]
        pad = -i0
        return np.concatenate(
            [np.zeros(pad, dtype=np.float64), self.hist[: length - pad]]
        )


class OracleConv(OracleStage):
    """Convolver stage: y[r] = w[r*down + offset], w = kernel (*) zero-stuff(x).

    Output r computable when r*down + offset <= n_in*up - 1 + lookahead,
    where causal w[t] depends on u[t-K+1 .. t]; u is known up to
    n_in*up - 1 (trailing stuffed zeros of the last sample count as known:
    u[m] for m in [ (n_in-1)*up+1, n_in*up ) are zeros).
    """

    def __init__(self, spec: ConvStage):
        super().__init__()
        self.spec = spec
        self.kernel = spec.filt.kernel
        self.K = spec.filt.kernel_len
        self.reset()

    def max_out_len(self, max_in: int) -> int:
        return (max_in * self.spec.up + self.spec.down - 1) // self.spec.down

    def keep_hist(self) -> int:
        # w[t] needs u[t-K+1..t]; in input-sample units: K/up + down + 2 slack
        return self.K // self.spec.up + self.spec.down + 4

    def _emit(self) -> np.ndarray:
        up, down, off = self.spec.up, self.spec.down, self.spec.offset
        n_u = self.n_in * up  # u known on [0, n_u)
        # largest r with r*down + off <= n_u - 1
        r_max = (n_u - 1 - off) // down if n_u - 1 - off >= 0 else -1
        n_new = r_max + 1 - self.n_out
        if n_new <= 0:
            return np.zeros(0, dtype=np.float64)
        r0 = self.n_out
        # w positions t in [t0, t1]: t = r*down + off
        t0 = r0 * down + off
        t1 = r_max * down + off
        # need u[t0-K+1 .. t1] -> input samples ceil/floor of that range
        m_lo = t0 - self.K + 1
        m_hi = t1
        n_lo = math.floor(m_lo / up)  # first input index involved (may be <0)
        n_hi = m_hi // up
        xw = self._window(n_lo, n_hi - n_lo + 1)
        # zero-stuff
        u = np.zeros((n_hi - n_lo + 1) * up, dtype=np.float64)
        u[::up] = xw
        # u array covers absolute u-range [n_lo*up, (n_hi+1)*up)
        w_full = np.convolve(u, self.kernel)  # w_full[j] = w[n_lo*up + j]
        idx = np.arange(t0, t1 + 1, down) - n_lo * up
        return w_full[idx]


class OracleHBUp(OracleStage):
    """Half-band 2X upsampler: y[2n] = x[n], y[2n+1] = interp; then drop the
    first ``out_latency`` outputs."""

    def __init__(self, spec: HBUpStage):
        super().__init__()
        self.spec = spec
        self.taps = spec.hb.taps
        self.nt = spec.hb.num_taps
        self.reset()

    def max_out_len(self, max_in: int) -> int:
        return max_in * 2

    def keep_hist(self) -> int:
        return 2 * self.nt + 4

    def _emit(self) -> np.ndarray:
        nt = self.nt
        # pre-skip output index s corresponds to: even s=2n -> x[n] needs
        # x up to n; odd s=2n+1 -> needs x[n+nt].  The reference produces
        # outputs in pairs once x[n+nt] is available (BufLeft > fl2=nt),
        # i.e. pairs for n <= n_in - 1 - nt.
        n_pair_max = self.n_in - 1 - nt
        s_avail = 2 * (n_pair_max + 1)  # pre-skip outputs available
        lat = self.spec.out_latency
        n_new = s_avail - lat - self.n_out
        if n_new <= 0:
            return np.zeros(0, dtype=np.float64)
        s0 = self.n_out + lat
        s1 = s_avail  # exclusive
        n_lo = s0 // 2 - nt + 1 - 1  # generous left bound
        n_hi = (s1 - 1) // 2 + nt
        xw = self._window(n_lo, n_hi - n_lo + 1)
        # even lane
        y = np.zeros(s1 - s0, dtype=np.float64)
        s = np.arange(s0, s1)
        even = (s % 2) == 0
        n_even = s[even] // 2 - n_lo
        y[even] = xw[n_even]
        n_odd = s[~even] // 2 - n_lo
        acc = np.zeros(n_odd.shape[0], dtype=np.float64)
        for i in range(nt):
            acc += self.taps[i] * (xw[n_odd + 1 + i] + xw[n_odd - i])
        y[~even] = acc
        return y


class OracleHBDown(OracleStage):
    """Half-band 2X downsampler (gain 2): y[n] = x[2n] + interp; drops the
    first ``out_latency`` outputs."""

    def __init__(self, spec: HBDownStage):
        super().__init__()
        self.spec = spec
        self.taps = spec.hb.taps
        self.nt = spec.hb.num_taps
        self.reset()

    def max_out_len(self, max_in: int) -> int:
        return (max_in + 1) // 2

    def keep_hist(self) -> int:
        return 4 * self.nt + 8

    def _emit(self) -> np.ndarray:
        nt = self.nt
        # y[n] needs x[2n + 2nt - 1]; outputs for n <= (n_in - 2nt) // 2 ...
        # largest n with 2n + 2*nt - 1 <= n_in - 1:
        n_max = (self.n_in - 2 * nt) // 2
        lat = self.spec.out_latency
        avail = n_max + 1
        n_new = avail - lat - self.n_out
        if n_new <= 0:
            return np.zeros(0, dtype=np.float64)
        s0 = self.n_out + lat
        s1 = avail
        m_lo = 2 * s0 - 2 * nt + 1
        m_hi = 2 * (s1 - 1) + 2 * nt - 1
        xw = self._window(m_lo, m_hi - m_lo + 1)
        n = np.arange(s0, s1)
        base = 2 * n - m_lo
        y = xw[base].copy()
        for i in range(nt):
            y += self.taps[i] * (xw[base + 1 + 2 * i] + xw[base - 1 - 2 * i])
        return y


class OracleFrac(OracleStage):
    """Fractional interpolator, whole-stepping or polynomial mode."""

    def __init__(self, spec: FracStage):
        super().__init__()
        self.spec = spec
        self.bank = spec.bank
        self.fl = spec.filter_len
        self.fl2 = self.fl // 2
        self.fll = self.fl2 - 1
        self.reset()

    def in_skip_init(self) -> int:
        return self.spec.in_latency

    def max_out_len(self, max_in: int) -> int:
        return int(math.ceil(max_in * self.spec.dst_rate / self.spec.src_rate)) + 1

    def keep_hist(self) -> int:
        return self.fl + int(math.ceil(self.spec.src_rate / self.spec.dst_rate)) + 8

    def _read_pos(self, n: np.ndarray):
        """(int read position s_n, filter selector) for output indices n."""
        spec = self.spec
        if spec.is_whole:
            g = spec.init_frac_pos_w + n * spec.in_step
            return g // spec.out_step, g % spec.out_step
        r = spec.src_rate / spec.dst_rate
        shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
        p = np.where(n == 0, spec.init_frac_pos, (n + shift) * r)
        pi = np.floor(p).astype(np.int64)
        return pi, p - pi

    def _emit(self) -> np.ndarray:
        # Output n requires x[s_n + fl2 - 1]... the reference's loop
        # condition is BufLeft - fl2 > 0 before producing the output at read
        # position s_n, i.e. n_in - s_n > fl2.
        spec = self.spec
        n0 = self.n_out
        # Find n_max: largest n with s_n <= n_in - fl2 - 1.
        lim = self.n_in - self.fl2 - 1
        if lim < 0:
            return np.zeros(0, dtype=np.float64)
        if spec.is_whole:
            # s_n = (W0 + n*I) // O <= lim  ->  n <= ((lim+1)*O - 1 - W0)//I
            n_max = ((lim + 1) * spec.out_step - 1 - spec.init_frac_pos_w) // spec.in_step
        else:
            r = spec.src_rate / spec.dst_rate
            shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
            n_max = int(math.floor((lim + 1) / r - shift))
            # guard against fp edge: adjust
            while True:
                p = spec.init_frac_pos if n_max == 0 else (n_max + shift) * r
                if math.floor(p) <= lim:
                    break
                n_max -= 1
            while True:
                nn = n_max + 1
                p = spec.init_frac_pos if nn == 0 else (nn + shift) * r
                if math.floor(p) <= lim:
                    n_max = nn
                else:
                    break
        if n_max < n0:
            return np.zeros(0, dtype=np.float64)
        n = np.arange(n0, n_max + 1)
        s, f = self._read_pos(n)
        start = s - self.fll
        m_lo = int(start.min())
        m_hi = int(start.max()) + self.fl - 1
        xw = self._window(m_lo, m_hi - m_lo + 1)
        base = (start - m_lo).astype(np.int64)
        idx = base[:, None] + np.arange(self.fl)[None, :]
        windows = xw[idx]  # [n, fl]
        if spec.is_whole:
            filt = self.bank.table[f]  # [n, fl]
            return np.sum(windows * filt, axis=1)
        fr = f * self.bank.fracs
        fti = np.floor(fr).astype(np.int64)
        x = fr - fti
        tab = self.bank.table[fti]  # [n, fl, 3]
        filt = tab[:, :, 0] + tab[:, :, 1] * x[:, None] + tab[:, :, 2] * (x * x)[:, None]
        return np.sum(windows * filt, axis=1)


def _build_stage(spec: Stage) -> OracleStage:
    if isinstance(spec, ConvStage):
        return OracleConv(spec)
    if isinstance(spec, HBUpStage):
        return OracleHBUp(spec)
    if isinstance(spec, HBDownStage):
        return OracleHBDown(spec)
    if isinstance(spec, FracStage):
        return OracleFrac(spec)
    raise TypeError(spec)


class OracleResampler:
    """Streaming front-end over a plan (CDSPResampler equivalent, f64 CPU).

    API mirrors the reference: process(chunk) -> output chunk; oneshot();
    clear(); latency queries.
    """

    def __init__(self, src_rate: float, dst_rate: float,
                 max_in_len: int = 4096, trans_band: float = 2.0,
                 atten: float = 206.91, phase: int = 0,
                 plan: Optional[Plan] = None):
        self.plan = plan if plan is not None else make_plan(
            src_rate, dst_rate, trans_band, atten, phase)
        self.max_in_len = max_in_len
        self.stages: List[OracleStage] = [
            _build_stage(s) for s in self.plan.stages
        ]

    @property
    def latency_frac(self) -> float:
        return self.plan.latency_frac

    def clear(self):
        for s in self.stages:
            s.reset()

    def process(self, x: np.ndarray) -> np.ndarray:
        y = np.asarray(x, dtype=np.float64)
        for s in self.stages:
            y = s.process(y)
        return y

    def max_out_len(self, max_in: int) -> int:
        n = max_in
        for s in self.stages:
            n = s.max_out_len(n)
        return n

    def oneshot(self, x: np.ndarray, out_len: Optional[int] = None) -> np.ndarray:
        """Offline conversion with zero-flush (CDSPResampler.h:592-651)."""
        x = np.asarray(x, dtype=np.float64)
        if out_len is None:
            out_len = int(math.floor(x.shape[0] * self.plan.dst_rate /
                                     self.plan.src_rate))
        out = np.zeros(out_len, dtype=np.float64)
        pos = 0
        ipos = 0
        zeros = np.zeros(self.max_in_len, dtype=np.float64)
        while pos < out_len:
            if ipos < x.shape[0]:
                chunk = x[ipos : ipos + self.max_in_len]
                ipos += chunk.shape[0]
            else:
                chunk = zeros
            y = self.process(chunk)
            n = min(y.shape[0], out_len - pos)
            out[pos : pos + n] = y[:n]
            pos += n
        self.clear()
        return out

    def get_input_required_for_output(self, req_out: int) -> int:
        """Exact inverse of the emission conditions: the minimal input count
        that yields at least ``req_out`` output samples.  Counterpart of
        getInputRequiredForOutput (CDSPResampler.h:476-484); exact here
        (each stage's emission is a deterministic function of its input
        count), where the reference's instant query may differ from the
        iterative one by a few samples (bench/zerotest.cpp:115-128 records
        the min/max spread)."""
        if req_out < 1:
            return 0
        count = req_out
        for st in reversed(self.stages):
            count = self._stage_in_for_out(st, count)
        return count

    @staticmethod
    def _stage_in_for_out(st: OracleStage, m: int) -> int:
        """Minimal input count for >= m outputs of this stage."""
        spec = st.spec
        if isinstance(spec, ConvStage):
            # emission: (m-1)*down + offset <= n_in*up - 1
            t = (m - 1) * spec.down + spec.offset
            return t // spec.up + 1
        if isinstance(spec, HBUpStage):
            # pre-skip outputs available: 2*(n_in - nt); need m + out_latency
            s = m + spec.out_latency
            return (s + 1) // 2 + spec.hb.num_taps
        if isinstance(spec, HBDownStage):
            # available: (n_in - 2nt)//2 + 1 >= m + out_latency
            n = m + spec.out_latency
            return 2 * (n - 1) + 2 * spec.hb.num_taps
        if isinstance(spec, FracStage):
            fl2 = spec.filter_len // 2
            n = m - 1  # last required output index
            if spec.is_whole:
                s = (spec.init_frac_pos_w + n * spec.in_step) // spec.out_step
            else:
                r = spec.src_rate / spec.dst_rate
                shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
                p = spec.init_frac_pos if n == 0 else (n + shift) * r
                s = int(math.floor(p))
            return spec.in_latency + s + fl2 + 1
        raise TypeError(spec)

    def get_in_len_before_out_pos(self, req_out_pos: int) -> int:
        """CDSPResampler.h:406-419 equivalent: input samples required to
        advance past output position ``req_out_pos``."""
        return self.get_input_required_for_output(req_out_pos + 1) - 1


def oneshot(src_rate: float, dst_rate: float, x: np.ndarray,
            out_len: Optional[int] = None, trans_band: float = 2.0,
            atten: float = 206.91, phase: int = 0) -> np.ndarray:
    """Convenience one-shot conversion through the oracle."""
    rs = OracleResampler(src_rate, dst_rate, trans_band=trans_band,
                         atten=atten, phase=phase)
    return rs.oneshot(x, out_len)
