"""Shift-invariance period and dependency span of a planned chain.

Shifting the input of a chain without a polynomial-mode interpolator by
p_in samples shifts its output by p_out = p_in*dst/src samples with
identical filter phases (all stage decimation/interpolation phases cycle).
``chain_shift_period`` computes the minimal such (p_in, p_out); the fused
executor (ops/fused.py) builds one supercycle of its operator from it, and
the push-mode stream (models/stream.py) its period-aligned blocks.
``chain_input_span`` bounds the input history the stream carries.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional, Tuple

from ..models.plan import ConvStage, FracStage, HBDownStage, HBUpStage, Plan

__all__ = ["chain_shift_period", "chain_input_span"]


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
