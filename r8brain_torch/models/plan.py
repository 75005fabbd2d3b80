"""Resampling pipeline planner.

Host-side counterpart of the CDSPResampler constructor's stage-selection
decision tree (reference: CDSPResampler.h:117-394).  Planning happens on the
host and produces a list of declarative stage specs; the device-side
resampler and the CPU oracle both build their executors from the same plan,
so stage plans (and hence output content) match by construction.

Decision tree, in order (CDSPResampler.h):
  1. src == dst                      -> no stages (:135-138)
  2. common single-step ratios       -> one convolver (:144-172)
     {1/2, 1/3, 2/3, 3/2, 3/4}
  3. whole i*2^c upsampling, i in    -> steep iX convolver + c half-band
     {2, 3}                            upsamplers (:174-216)
  4. dst*2 > src                     -> 2X convolver, then either direct
     (upsampling / mild downsampling)   fractional interpolation or
                                        intermediate interpolation + numX
                                        convolver + half-band ups (:218-333)
  5. else (downsampling >= 2x)       -> c half-band downsamplers + final
                                        convolver (+ fractional
                                        interpolator) (:335-393)

Latency bookkeeping: every stage consumes the whole-sample part of the
accumulated fractional latency and passes the remainder downstream, exactly
as the reference's PrevLatency threading (CDSPResampler.h:688).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from ..design.fracbank import (FracBank, default_filter_fracs,
                               frac_win_params, get_frac_bank)
from ..design.halfband import HBFilter, get_hb_filter
from ..design.lpfilter import (LINEAR_PHASE, LP_MAX_TRANS_BAND, LPFilter,
                               get_lp_filter)
from ..design.wholestep import get_whole_stepping

__all__ = [
    "ConvStage",
    "HBUpStage",
    "HBDownStage",
    "FracStage",
    "Stage",
    "Plan",
    "subplan",
    "make_plan",
]


@dataclass(frozen=True)
class ConvStage:
    """FFT/FIR convolver with built-in whole-number up/down resampling
    (CDSPBlockConvolver).  Content semantics (derived from
    CDSPBlockConvolver.h:252-354,512-593 with consumed latency):

        u = zero-stuffed input (u[n*up] = x[n])
        w[t] = sum_m kernel[m] * u[t - m]          (causal convolution)
        y[r] = w[r*down + offset]

    where ``offset`` accounts for the filter latency, inherited fractional
    latency, and the power-of-2 downsampling alignment correction
    (CDSPBlockConvolver.h:94-157).
    """

    filt: LPFilter
    up: int
    down: int
    prev_latency_frac: float
    # Resolved:
    offset: int
    latency_frac_out: float

    @property
    def kind(self) -> str:
        return "conv"


@dataclass(frozen=True)
class HBUpStage:
    """Half-band 2X upsampler (CDSPHBUpsampler.h:572-732).

        y[2n]   = x[n]
        y[2n+1] = sum_i flt[i] * (x[n+1+i] + x[n-i])
        output latency consumed: int(prev_latency_frac * 2)
    """

    hb: HBFilter
    prev_latency_frac: float
    out_latency: int
    latency_frac_out: float

    @property
    def kind(self) -> str:
        return "hb_up"


@dataclass(frozen=True)
class HBDownStage:
    """Half-band 2X downsampler, gain 2 (CDSPHBDownsampler.h:47-239).

        y[n] = x[2n] + sum_i flt[i] * (x[2n+1+2i] + x[2n-1-2i])
        output latency consumed: int(prev_latency_frac * 0.5)
    """

    hb: HBFilter
    prev_latency_frac: float
    out_latency: int
    latency_frac_out: float

    @property
    def kind(self) -> str:
        return "hb_down"


@dataclass(frozen=True)
class FracStage:
    """Fractional-delay filter-bank interpolator
    (CDSPFracInterpolator.h:690-1180).

    Whole-stepping mode (exact rational ratio, out_step <= 1500):
        g_n = init_frac_pos_w + n * in_step
        y[n] = sum_i bank[g_n mod out_step][i] * x[floor(g_n / out_step)
                                                   - (fl2 - 1) + i]
    Polynomial mode:
        p_n = (n + pos_shift) * src_rate / dst_rate
        x = frac(p_n) * fracs;  f = floor(x);  x -= f
        y[n] = sum_i (c0[f,i] + c1[f,i]*x + c2[f,i]*x^2)
               * x[floor(p_n) - (fl2 - 1) + i]
    Input latency consumed: int(prev_latency_frac).
    """

    src_rate: float
    dst_rate: float
    req_atten: float
    is_third: bool
    prev_latency_frac: float
    # Resolved:
    is_whole: bool
    in_step: int  # whole mode only
    out_step: int
    init_frac_pos_w: int  # whole mode initial phase
    init_frac_pos: float  # poly mode initial fractional position
    in_latency: int  # whole input samples consumed
    latency_frac_out: float
    filter_len: int
    bank: FracBank = field(repr=False, compare=False, default=None)

    @property
    def kind(self) -> str:
        return "frac"


Stage = Union[ConvStage, HBUpStage, HBDownStage, FracStage]


@dataclass(frozen=True)
class Plan:
    src_rate: float
    dst_rate: float
    trans_band: float
    atten: float
    phase: int
    stages: Tuple[Stage, ...]
    latency_frac: float  # leftover fractional latency in the output

    def describe(self) -> str:
        lines = [
            f"Plan {self.src_rate:g} -> {self.dst_rate:g}  tb={self.trans_band:g} "
            f"atten={self.atten:g} phase={self.phase} lat_frac={self.latency_frac:.6g}"
        ]
        for s in self.stages:
            if isinstance(s, ConvStage):
                lines.append(
                    f"  conv  up={s.up} down={s.down} "
                    f"klen={s.filt.kernel_len} offset={s.offset}"
                )
            elif isinstance(s, HBUpStage):
                lines.append(
                    f"  hb_up taps={s.hb.num_taps} att={s.hb.atten:g} "
                    f"out_lat={s.out_latency}"
                )
            elif isinstance(s, HBDownStage):
                lines.append(
                    f"  hb_dn taps={s.hb.num_taps} att={s.hb.atten:g} "
                    f"out_lat={s.out_latency}"
                )
            else:
                mode = "whole" if s.is_whole else "poly"
                lines.append(
                    f"  frac  {mode} src={s.src_rate:g} dst={s.dst_rate:g} "
                    f"taps={s.filter_len} steps={s.in_step}/{s.out_step} "
                    f"in_lat={s.in_latency}"
                )
        return "\n".join(lines)


def subplan(plan: Plan, stages) -> Plan:
    """``plan`` with only ``stages``, a run of its stages."""
    return Plan(plan.src_rate, plan.dst_rate, plan.trans_band, plan.atten,
                plan.phase, tuple(stages), plan.latency_frac)


# -- Stage spec construction (latency algebra) --------------------------------


def _make_conv(filt: LPFilter, up: int, down: int, prev_lf: float) -> ConvStage:
    """Resolve convolver latency algebra (CDSPBlockConvolver.h:62-157).

    The content offset is ``w[r*down + offset]`` with:
      L0   = int(prev_lf * up + filt.latency_frac)
      base = L0 + filt.latency
      pow2 down alignment (CDSPBlockConvolver.h:106-157): the reference
      prepends InputDelay = (-InLatency mod down) zeros to the input and
      keeps decimation phases aligned to its output buffer, whose content at
      stream position s is w[s - InputLen] shifted by OutOffset; the net
      content mapping (derived from copyToOutput, :512-593, and validated
      against compiled-reference goldens in tests/test_goldens.py) is

        offset = base + ((OutOffset - InputDelay - base) mod down)

      with OutOffset = filt.latency (zero-phase) or 0 (min-phase) and
      InLatency = L0 + filt.latency - OutOffset.
    """
    lf = filt.latency_frac + prev_lf * up
    l0 = int(lf)
    lf -= l0
    lf /= down
    base = l0 + filt.latency

    offset = base
    if down > 1 and (down & (down - 1)) == 0:
        out_offset = filt.latency if filt.is_zero_phase else 0
        in_latency = l0 + filt.latency - out_offset
        delta = (-in_latency) % down  # InputDelay
        offset = base + ((out_offset - delta - base) % down)

    return ConvStage(
        filt=filt,
        up=up,
        down=down,
        prev_latency_frac=prev_lf,
        offset=offset,
        latency_frac_out=lf,
    )


def _make_hb_up(req_atten: float, steep_index: int, is_third: bool,
                prev_lf: float) -> HBUpStage:
    hb = get_hb_filter(req_atten, steep_index, is_third)
    lf = prev_lf * 2.0
    lat = int(lf)
    return HBUpStage(hb=hb, prev_latency_frac=prev_lf, out_latency=lat,
                     latency_frac_out=lf - lat)


def _make_hb_down(req_atten: float, steep_index: int, is_third: bool,
                  prev_lf: float) -> HBDownStage:
    hb = get_hb_filter(req_atten, steep_index, is_third)
    lf = prev_lf * 0.5
    lat = int(lf)
    return HBDownStage(hb=hb, prev_latency_frac=prev_lf, out_latency=lat,
                       latency_frac_out=lf - lat)


def _make_frac(src_rate: float, dst_rate: float, req_atten: float,
               is_third: bool, prev_lf: float) -> FracStage:
    """Resolve interpolator latency algebra
    (CDSPFracInterpolator.h:707-791)."""
    init_frac_pos = prev_lf
    in_latency = int(init_frac_pos)
    init_frac_pos -= in_latency

    ws = get_whole_stepping(src_rate, dst_rate)
    if ws is not None:
        in_step, out_step = ws
        spos = init_frac_pos * out_step
        init_frac_pos_w = int(spos)
        lf_out = (spos - init_frac_pos_w) / in_step
        bank = get_frac_bank(out_step, 1, 2, req_atten, is_third,
                             is_static=False)
        return FracStage(
            src_rate=src_rate, dst_rate=dst_rate, req_atten=req_atten,
            is_third=is_third, prev_latency_frac=prev_lf, is_whole=True,
            in_step=in_step, out_step=out_step,
            init_frac_pos_w=init_frac_pos_w, init_frac_pos=0.0,
            in_latency=in_latency, latency_frac_out=lf_out,
            filter_len=bank.filter_len, bank=bank,
        )

    bank = get_frac_bank(-1, 3, 8, req_atten, is_third, is_static=True)
    return FracStage(
        src_rate=src_rate, dst_rate=dst_rate, req_atten=req_atten,
        is_third=is_third, prev_latency_frac=prev_lf, is_whole=False,
        in_step=0, out_step=0, init_frac_pos_w=0,
        init_frac_pos=init_frac_pos, in_latency=in_latency,
        latency_frac_out=0.0, filter_len=bank.filter_len, bank=bank,
    )


# -- The decision tree --------------------------------------------------------


def make_plan(
    src_rate: float,
    dst_rate: float,
    trans_band: float = 2.0,
    atten: float = 206.91,
    phase: int = LINEAR_PHASE,
) -> Plan:
    """Plan the stage chain for src_rate -> dst_rate conversion
    (CDSPResampler.h:117-394)."""
    if not (math.isfinite(src_rate) and math.isfinite(dst_rate)):
        raise ValueError("sample rates must be finite")
    if src_rate <= 0.0 or dst_rate <= 0.0:
        raise ValueError("sample rates must be positive")
    if src_rate / dst_rate > 1e9 or dst_rate / src_rate > 1e9:
        # Same cap the native blob parser and designer enforce; without it
        # the 2^c stage loops run away (the failure surfaces as an opaque
        # OverflowError deep in the decision tree).
        raise ValueError("rate ratio beyond 1e9 is unsupported")

    stages: List[Stage] = []
    lf = 0.0  # running fractional latency (LatencyFrac)

    def add(stage: Stage):
        nonlocal lf
        stages.append(stage)
        lf = stage.latency_frac_out

    if src_rate == dst_rate:
        return Plan(src_rate, dst_rate, trans_band, atten, phase, (), 0.0)

    # 2. Common single-step ratios (:144-172).
    common = ((1, 2), (1, 3), (2, 3), (3, 2), (3, 4))
    for num, den in common:
        if src_rate * num == dst_rate * den:
            filt = get_lp_filter(1.0 / max(num, den), trans_band, atten,
                                 phase, float(num))
            add(_make_conv(filt, num, den, lf))
            return Plan(src_rate, dst_rate, trans_band, atten, phase,
                        tuple(stages), lf)

    # 3. Whole i*2^c upsampling, i in {2, 3} (:174-216).
    for i in (2, 3):
        c = 0
        found = False
        while True:
            new_sr = src_rate * (i << c)
            if new_sr == dst_rate:
                found = True
                break
            if new_sr > dst_rate:
                break
            c += 1
        if found:
            filt = get_lp_filter(1.0 / i, trans_band, atten, phase, float(i))
            add(_make_conv(filt, i, 1, lf))
            is_third = i == 3
            for j in range(c):
                add(_make_hb_up(atten, j, is_third, lf))
            return Plan(src_rate, dst_rate, trans_band, atten, phase,
                        tuple(stages), lf)

    if dst_rate * 2.0 > src_rate:
        # 4. Upsampling or fractional downsampling down to 2X (:218-333).
        norm_freq = 0.5 if dst_rate > src_rate else 0.5 * dst_rate / src_rate
        filt = get_lp_filter(norm_freq, trans_band, atten, phase, 2.0)
        add(_make_conv(filt, 2, 1, lf))

        # Intermediate interpolation threshold (:232-269).
        tbw = 0.0175
        thresh_rate = src_rate / (1.0 - tbw * trans_band)

        c = 0
        div = 1
        while True:
            ndiv = div * 2
            if dst_rate < thresh_rate * ndiv:
                break
            div = ndiv
            c += 1

        c2 = 0
        div2 = 1
        while True:
            ndiv = div * (3 if c2 == 0 else 2)
            if dst_rate < thresh_rate * ndiv:
                break
            div2 = ndiv
            c2 += 1

        src_rate2 = src_rate * 2.0

        if c == 1 and get_whole_stepping(src_rate2, dst_rate) is not None:
            # Whole stepping is very fast; skip intermediate interpolation
            # (:275-282).
            c = 0

        if c > 0:
            # Intermediate interpolation + numX convolver + half-bands
            # (:286-324).
            if c2 > 0 and div2 > div:
                div = div2
                c = c2
                num = 3
            else:
                num = 2

            add(_make_frac(src_rate2 * div, dst_rate, atten, False, lf))

            tb = (1.0 - src_rate * div / dst_rate) / tbw
            tb = min(tb, LP_MAX_TRANS_BAND)

            filt2 = get_lp_filter(1.0 / num, tb, atten, phase, float(num))
            add(_make_conv(filt2, num, 1, lf))

            is_third = num == 3
            for i in range(1, c):
                add(_make_hb_up(atten, i - 1, is_third, lf))
        else:
            add(_make_frac(src_rate2, dst_rate, atten, False, lf))

        return Plan(src_rate, dst_rate, trans_band, atten, phase,
                    tuple(stages), lf)

    # 5. Downsampling >= 2x (:335-393).
    check_sr = dst_rate * 4.0
    c = 0
    fin_gain = 1.0
    while check_sr <= src_rate:
        c += 1
        check_sr *= 2.0
        fin_gain *= 0.5

    src_sr_div = 1 << c
    downf = 1
    norm_freq = 0.5
    use_interp = True
    is_third = False

    for df in (2, 3):
        if dst_rate * src_sr_div * df == src_rate:
            downf = df
            norm_freq = 1.0 / df
            use_interp = False
            is_third = df == 3
            break

    if use_interp:
        downf = 1
        norm_freq = dst_rate * src_sr_div / src_rate
        is_third = norm_freq * 3.0 <= 1.0

    for i in range(c):
        add(_make_hb_down(atten, c - 1 - i, is_third, lf))

    filt = get_lp_filter(norm_freq, trans_band, atten, phase, fin_gain)
    add(_make_conv(filt, 1, downf, lf))

    if use_interp:
        add(_make_frac(src_rate, dst_rate * src_sr_div, atten, is_third, lf))

    return Plan(src_rate, dst_rate, trans_band, atten, phase, tuple(stages), lf)
