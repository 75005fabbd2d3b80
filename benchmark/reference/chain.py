"""A plan's stage chain in float64, on absolute sample ranges.

Each stage is computed from its content formula (the CPU oracle's, stage
by stage: ``plan.py``'s docstrings): outputs ``[a, b)`` of a stage are a
function of its input over a range that ``stage_need`` gives, with every
index left of 0 reading zero, as a stream that starts from silence does.
So one function serves a oneshot (outputs ``[0, out_len)`` of the input
followed by zeros) and any stretch of a stream (outputs ``[a, b)`` of the
concatenated blocks).  Rows are independent; a ``source(c, d)`` hands the
chain's input samples ``[c, d)`` (``0 <= c <= d``) of every row.

``precision="tf32"`` is the control: the same chain with every product's
operands (each stage's input and its coefficients) rounded to TF32's 10
mantissa bits and each stage's output to float32, the precision a
float32 path with TF32 switched on would give (its products exact, so no
worse than the hardware's).
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from .plan import ConvStage, FracStage, HBDownStage, HBUpStage, Stage

__all__ = ["Chain", "stage_need", "stage_out_len", "frac_read_pos",
           "work_counts"]


def frac_read_pos(spec: FracStage, n: np.ndarray):
    """(s, f) for output indices n: the integer read position and the
    filter selector (whole mode: the bank row; poly mode: the fraction of
    a sample), in the oracle's float64 arithmetic."""
    if spec.is_whole:
        g = spec.init_frac_pos_w + n * spec.in_step
        return g // spec.out_step, g % spec.out_step
    r = spec.src_rate / spec.dst_rate
    shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
    p = np.where(n == 0, spec.init_frac_pos, (n + shift) * r)
    s = np.floor(p).astype(np.int64)
    return s, p - s


def _taps_per_phase(spec: ConvStage) -> int:
    return -(-spec.filt.kernel_len // spec.up)


def stage_need(spec: Stage, a: int, b: int):
    """The input range [c, d) that outputs [a, b) (b > a) of the stage
    read.  c may be negative (zeros); a fractional stage's range is in its
    input's coordinates before the ``in_latency`` samples it skips."""
    if isinstance(spec, ConvStage):
        J = _taps_per_phase(spec)
        return ((a * spec.down + spec.offset) // spec.up - (J - 1),
                ((b - 1) * spec.down + spec.offset) // spec.up + 1)
    if isinstance(spec, HBUpStage):
        nt, lat = spec.hb.num_taps, spec.out_latency
        return (a + lat) // 2 - nt, (b - 1 + lat) // 2 + nt + 1
    if isinstance(spec, HBDownStage):
        nt, lat = spec.hb.num_taps, spec.out_latency
        return 2 * (a + lat) - 2 * nt + 1, 2 * (b - 1 + lat) + 2 * nt
    if isinstance(spec, FracStage):
        fll = spec.filter_len // 2 - 1
        s, _ = frac_read_pos(spec, np.array([a, b - 1], dtype=np.int64))
        return (int(s[0]) - fll + spec.in_latency,
                int(s[1]) - fll + spec.filter_len + spec.in_latency)
    raise TypeError(spec)


def stage_out_len(spec: Stage, n_in: int) -> int:
    """Outputs a stage has emitted once fed ``n_in`` samples: the
    oracle's emission rule (an output is due once every input it reads
    has arrived)."""
    if isinstance(spec, ConvStage):
        t = n_in * spec.up - 1 - spec.offset
        return max(0, t // spec.down + 1)
    if isinstance(spec, HBUpStage):
        return max(0, 2 * (n_in - spec.hb.num_taps) - spec.out_latency)
    if isinstance(spec, HBDownStage):
        nt = spec.hb.num_taps
        return max(0, (n_in - 2 * nt) // 2 + 1 - spec.out_latency)
    if isinstance(spec, FracStage):
        lim = (n_in - spec.in_latency) - spec.filter_len // 2 - 1
        if lim < 0:
            return 0
        if spec.is_whole:
            return max(0, ((lim + 1) * spec.out_step - 1
                           - spec.init_frac_pos_w) // spec.in_step + 1)
        r = spec.src_rate / spec.dst_rate
        shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
        n = int(math.floor((lim + 1) / r - shift))

        def pos(m):
            return int(frac_read_pos(spec, np.array([m]))[0][0])

        while pos(n) > lim:
            n -= 1
        while pos(n + 1) <= lim:
            n += 1
        return max(0, n + 1)
    raise TypeError(spec)


def work_counts(stages, out_len: int) -> List[int]:
    """Outputs of each stage that a oneshot of ``out_len`` final outputs
    needs (the chain's input zero-flushed)."""
    counts = [0] * len(stages)
    m = out_len
    for i in range(len(stages) - 1, -1, -1):
        counts[i] = m
        m = stage_need(stages[i], 0, m)[1] if m > 0 else 0
    return counts


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero as the hardware's conversion), returned in float64."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = torch.bitwise_and(i + 0x1000, -0x2000)
    return i.view(torch.float32).to(torch.float64)


class Chain:
    """The stage chain of a frozen plan on ``device`` in float64 (or the
    TF32 control)."""

    def __init__(self, plan, device, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.stages = plan.stages
        self.device = torch.device(device)
        self.control = precision == "tf32"
        f64 = dict(dtype=torch.float64, device=self.device)
        self.coef = []
        for st in self.stages:
            if isinstance(st, ConvStage):
                h = np.asarray(st.filt.kernel, dtype=np.float64)
                J = _taps_per_phase(st)
                w = np.zeros((st.up, 1, J))
                for phi in range(st.up):
                    g = h[phi :: st.up]
                    w[phi, 0, J - len(g):] = g[::-1]  # cross-correlation
                self.coef.append(self._op(torch.tensor(w, **f64)))
            elif isinstance(st, (HBUpStage, HBDownStage)):
                self.coef.append(self._op(torch.tensor(
                    np.asarray(st.hb.taps, dtype=np.float64), **f64)))
            else:
                self.coef.append(torch.tensor(
                    np.asarray(st.bank.table, dtype=np.float64), **f64))

    def _op(self, t):
        return _tf32(t) if self.control else t

    def _out_round(self, y):
        return y.to(torch.float32).to(torch.float64) if self.control else y

    def run(self, source: Callable, a: int, b: int) -> torch.Tensor:
        """Final outputs [a, b) of every row of ``source``, float64."""
        return self._out(len(self.stages) - 1, source, a, b)

    # -- the chain, stage by stage ------------------------------------

    def _empty(self, source, n):
        e = source(0, 0)
        return torch.zeros((e.shape[0], n), dtype=torch.float64,
                           device=self.device)

    def _input(self, i: int, source, c: int, d: int) -> torch.Tensor:
        """Stage i's input samples [c, d); indices left of 0 read 0."""
        lo = max(c, 0)
        if d <= lo:
            return self._empty(source, max(0, d - c))
        body = (source(lo, d).to(device=self.device, dtype=torch.float64)
                if i == 0 else self._out(i - 1, source, lo, d))
        return F.pad(body, (lo - c, 0)) if c < lo else body

    def _out(self, i: int, source, a: int, b: int) -> torch.Tensor:
        if b <= a:
            return self._empty(source, 0)
        st = self.stages[i]
        if isinstance(st, FracStage):
            return self._frac(i, st, source, a, b)
        c, d = stage_need(st, a, b)
        x = self._input(i, source, c, d)
        if self.control:
            x = _tf32(x)
        if isinstance(st, ConvStage):
            y = self._conv(st, self.coef[i], x, c, a, b)
        elif isinstance(st, HBUpStage):
            y = self._hb_up(st, self.coef[i], x, c, a, b)
        else:
            y = self._hb_down(st, self.coef[i], x, c, a, b)
        return self._out_round(y)

    def _conv(self, st, w, x, c, a, b):
        # w[t] = sum_k h[k] u[t-k], u the zero-stuffed input; phase phi of
        # t = m*up + phi reads x[m - j] h[j*up + phi]; conv1d's output
        # [phi, n] is w[(c + n + J - 1)*up + phi]
        J = w.shape[-1]
        o = F.conv1d(x[:, None, :], w)  # [R, up, n]
        t = torch.arange(a, b, device=self.device) * st.down + st.offset
        n = t // st.up - c - (J - 1)
        return o.reshape(o.shape[0], -1)[:, (t % st.up) * o.shape[-1] + n]

    def _hb_up(self, st, taps, x, c, a, b):
        s = torch.arange(a + st.out_latency, b + st.out_latency,
                         device=self.device)
        n = s // 2 - c
        odd = (s % 2) == 1
        acc = torch.zeros((x.shape[0], b - a), dtype=torch.float64,
                          device=self.device)
        for k in range(st.hb.num_taps):
            acc += taps[k] * (x[:, n + 1 + k] + x[:, n - k])
        return torch.where(odd, acc, x[:, n])

    def _hb_down(self, st, taps, x, c, a, b):
        base = 2 * torch.arange(a + st.out_latency, b + st.out_latency,
                                device=self.device) - c
        y = x[:, base].clone()
        for k in range(st.hb.num_taps):
            y += taps[k] * (x[:, base + 1 + 2 * k] + x[:, base - 1 - 2 * k])
        return y

    def _frac(self, i, st, source, a, b):
        fl = st.filter_len
        n = np.arange(a, b, dtype=np.int64)
        s, f = frac_read_pos(st, n)
        tab = self.coef[i]
        if st.is_whole:
            filt = tab[torch.from_numpy(f).to(self.device)]
        else:
            fr = f * st.bank.fracs
            fti = np.floor(fr).astype(np.int64)
            xf = torch.from_numpy(fr - fti).to(self.device)[:, None]
            c3 = tab[torch.from_numpy(fti).to(self.device)]  # [n, fl, 3]
            filt = c3[:, :, 0] + c3[:, :, 1] * xf + c3[:, :, 2] * (xf * xf)
        filt = self._op(filt)
        start = s - (fl // 2 - 1)  # post-skip positions; < 0 read zero
        q0, q1 = int(start[0]), int(start[-1]) + fl
        lat = st.in_latency
        lo = max(q0, 0)
        x = (self._input(i, source, lo + lat, q1 + lat) if q1 > lo
             else self._empty(source, 0))
        x = F.pad(x, (lo - q0, 0)) if q0 < lo else x
        if self.control:
            x = _tf32(x)
        base = torch.from_numpy(start - q0).to(self.device)
        y = torch.zeros((x.shape[0], b - a), dtype=torch.float64,
                        device=self.device)
        for k in range(fl):
            y += x[:, base + k] * filt[:, k]
        return self._out_round(y)
