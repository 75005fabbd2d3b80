"""Emission-length algebra for planned stages.

Pure functions mapping input-sample counts to output-sample counts (and the
inverse) for each stage kind.  These are the exact totals the streaming
oracle (models/oracle.py) emits for a given input length, and the reference's
latency-query call stack walks the same relations backwards
(CDSPResampler.h:406-419,476-484; CDSPBlockConvolver.h:192-196;
CDSPHBUpsampler.h:632-635; CDSPHBDownsampler.h:100-103;
CDSPFracInterpolator.h:802-815).

The executors (ops/fused.py) use these to derive output shapes; the
reference package's tests/test_lengths.py asserts agreement with the
streaming oracle sample-for-sample.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional, Sequence, Tuple

from .plan import ConvStage, FracStage, HBDownStage, HBUpStage, Plan, Stage

__all__ = ["stage_out_len", "stage_in_for_out", "chain_out_len",
           "chain_in_for_out", "stage_max_out_len", "chain_max_out_len",
           "chain_shift_period", "chain_input_span", "round_up",
           "frac_positions"]


def _frac_read_pos_scalar(spec: FracStage, n: int):
    """Integer read position s_n for output index n (poly mode, f64 math
    identical to the oracle's)."""
    r = spec.src_rate / spec.dst_rate
    shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
    p = spec.init_frac_pos if n == 0 else (n + shift) * r
    return math.floor(p)


def stage_out_len(spec: Stage, n_in: int) -> int:
    """Total outputs emitted by a stage fed ``n_in`` samples (then idle)."""
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
            n_max = ((lim + 1) * spec.out_step - 1
                     - spec.init_frac_pos_w) // spec.in_step
            return max(0, n_max + 1)
        # poly: largest n with floor(p_n) <= lim  (oracle's guarded search)
        r = spec.src_rate / spec.dst_rate
        shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
        n_max = int(math.floor((lim + 1) / r - shift))
        while _frac_read_pos_scalar(spec, n_max) > lim:
            n_max -= 1
        while _frac_read_pos_scalar(spec, n_max + 1) <= lim:
            n_max += 1
        return max(0, n_max + 1)
    raise TypeError(spec)


def stage_in_for_out(spec: Stage, m: int) -> int:
    """Minimal input count for >= m outputs (inverse of stage_out_len)."""
    if m <= 0:
        return 0
    if isinstance(spec, ConvStage):
        t = (m - 1) * spec.down + spec.offset
        return t // spec.up + 1
    if isinstance(spec, HBUpStage):
        s = m + spec.out_latency
        return (s + 1) // 2 + spec.hb.num_taps
    if isinstance(spec, HBDownStage):
        n = m + spec.out_latency
        return 2 * (n - 1) + 2 * spec.hb.num_taps
    if isinstance(spec, FracStage):
        fl2 = spec.filter_len // 2
        n = m - 1
        if spec.is_whole:
            s = (spec.init_frac_pos_w + n * spec.in_step) // spec.out_step
        else:
            s = _frac_read_pos_scalar(spec, n)
        return spec.in_latency + s + fl2 + 1
    raise TypeError(spec)


def chain_out_len(stages: Sequence[Stage], n_in: int) -> int:
    for s in stages:
        n_in = stage_out_len(s, n_in)
    return n_in


def chain_in_for_out(stages: Sequence[Stage], m: int) -> int:
    for s in reversed(stages):
        m = stage_in_for_out(s, m)
    return m


def stage_max_out_len(spec: Stage, max_in: int) -> int:
    """Upper bound on outputs a stage can emit for a max_in-sample block
    at ANY stream position (getMaxOutLen, CDSPProcessor.h:117-127) —
    unlike stage_out_len this ignores start latency, so it bounds
    mid-stream blocks too."""
    if isinstance(spec, ConvStage):
        return (max_in * spec.up + spec.down - 1) // spec.down
    if isinstance(spec, HBUpStage):
        return max_in * 2
    if isinstance(spec, HBDownStage):
        return (max_in + 1) // 2
    if isinstance(spec, FracStage):
        return int(math.ceil(
            max_in * spec.dst_rate / spec.src_rate)) + 1
    raise TypeError(spec)


def chain_max_out_len(stages: Sequence[Stage], max_in: int) -> int:
    for s in stages:
        max_in = stage_max_out_len(s, max_in)
    return max_in


def chain_shift_period(plan: Plan) -> Optional[Tuple[int, int]]:
    """Minimal (p_in, p_out) integer shift-invariance period of the chain,
    or None when the plan contains a polynomial-mode interpolator."""
    stages = plan.stages
    if any(isinstance(s, FracStage) and not s.is_whole for s in stages):
        return None
    p = 1
    for _ in range(16):
        q = Fraction(p)
        mult = 1
        for s in stages:
            if isinstance(s, ConvStage):
                q = q * s.up / s.down
            elif isinstance(s, HBUpStage):
                q = q * 2
            elif isinstance(s, HBDownStage):
                q = q / 2
            elif isinstance(s, FracStage):
                q = q * s.out_step / s.in_step
            if q.denominator != 1:
                mult = mult * q.denominator // math.gcd(mult, q.denominator)
        if mult == 1 and q.denominator == 1:
            return p, int(q)
        p *= mult
    return None


def chain_input_span(plan: Plan) -> int:
    """Conservative dependency width: any output sample depends on at most
    this many consecutive input samples."""
    span = 1
    for s in reversed(plan.stages):
        if isinstance(s, ConvStage):
            span = ((span - 1) * s.down + s.filt.kernel_len) // s.up + 2
        elif isinstance(s, HBUpStage):
            span = span // 2 + 2 * s.hb.num_taps + 2
        elif isinstance(s, HBDownStage):
            span = 2 * span + 4 * s.hb.num_taps + 2
        elif isinstance(s, FracStage):
            span = int(math.ceil(span * s.src_rate / s.dst_rate)) \
                + s.filter_len + 2
    return span


def round_up(n: int, m: int) -> int:
    """n rounded up to a multiple of m."""
    return -(-n // m) * m


def frac_positions(spec: FracStage, n0: int, count: int):
    """Host-side f64 read positions for poly-mode outputs [n0, n0+count):
    returns (s[int64], xfrac[float64]) exactly as the oracle computes them
    (CDSPFracInterpolator.h:907-919 resettable-counter semantics)."""
    import numpy as np

    n = np.arange(n0, n0 + count, dtype=np.int64)
    r = spec.src_rate / spec.dst_rate
    shift = spec.init_frac_pos * spec.dst_rate / spec.src_rate
    p = np.where(n == 0, spec.init_frac_pos, (n + shift) * r)
    pi = np.floor(p).astype(np.int64)
    return pi, p - pi
