"""Low-pass FIR filter designer + cache (host-side, float64).

Host-side counterpart of CDSPFIRFilter / CDSPFIRFilterCache
(reference: CDSPFIRFilter.h:58-730).  Reproduces the reference's empirical
closed-form design model exactly: the (ReqTransBand, ReqAtten) ->
(Kaiser power, half-length hl, -3 dB offset fo1) parameter fits
(CDSPFIRFilter.h:373-448), the three baked attenuation-correction tables
(:278-371, extracted to _tables.py), kernel generation through the Kaiser
windowed-sinc generator (:450-466).  Linear phase only: this frozen copy
leaves out the minimum-phase transform (:476-484), which no configuration of
the benchmark runs, and refuses ``phase != LINEAR_PHASE``.

Unlike the reference, the designed kernel is returned in plain time-domain
form with DC gain normalized to exactly ``req_gain``; FFT-domain preparation
(spectrum, block length, scaling) is owned by the device-side convolver
stage, which is free to choose larger FFT blocks than the reference without
changing the output stream (overlap-save output is invariant to block size).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..utils.fir import normalize_fir
from . import _tables
from .sinc import generate_band_kernel

__all__ = [
    "LP_MIN_TRANS_BAND",
    "LP_MAX_TRANS_BAND",
    "LP_MIN_ATTEN",
    "LP_MAX_ATTEN",
    "LPFilter",
    "build_lp_filter",
    "get_lp_filter",
    "lp_cache_size",
    "clear_lp_cache",
]

# Design parameter ranges (CDSPFIRFilter.h:77-110).
LP_MIN_TRANS_BAND = 0.5
LP_MAX_TRANS_BAND = 45.0
LP_MIN_ATTEN = 49.0
LP_MAX_ATTEN = 218.0

LINEAR_PHASE = 0


@dataclass(frozen=True)
class LPFilter:
    """A designed low-pass FIR filter.

    kernel: causal time-domain taps, length kernel_len, DC gain == req_gain.
    latency: integer latency in samples (fl2 for linear phase).
    latency_frac: fractional latency (0 for linear phase).
    is_zero_phase: true when the kernel is symmetric (linear phase) and the
      convolver may apply it center-aligned.
    """

    kernel: np.ndarray
    latency: int
    latency_frac: float
    is_zero_phase: bool
    norm_freq: float
    trans_band: float
    atten: float
    phase: int
    req_gain: float

    @property
    def kernel_len(self) -> int:
        return int(self.kernel.shape[0])

    @property
    def fl2(self) -> int:
        return (self.kernel_len - 1) // 2


def _atten_correction(tb: float, req_atten: float, atten: float,
                      ext_atten_corrs: Optional[np.ndarray]) -> float:
    """Apply the baked attenuation-correction tables
    (CDSPFIRFilter.h:228-371).  ``atten`` is the (negative) working value.
    Returns corrected ``atten``.
    """
    # Piecewise base corrections (:228-276).
    if tb >= 0.25:
        if req_atten >= 117.0:
            atten -= 1.60
        elif req_atten >= 60.0:
            atten -= 1.91
        else:
            atten -= 2.25
    elif tb >= 0.10:
        if req_atten >= 117.0:
            atten -= 0.69
        elif req_atten >= 60.0:
            atten -= 0.73
        else:
            atten -= 1.13
    else:
        if req_atten >= 117.0:
            atten -= 0.21
        elif req_atten >= 60.0:
            atten -= 0.25
        else:
            atten -= 0.36

    atten_corr_count = 264
    atten_corr_min = 49.0
    atten_corr_diff = 176.25
    idx = int(math.floor((-atten - atten_corr_min) * atten_corr_count /
                         atten_corr_diff + 0.5))
    idx = min(atten_corr_count, max(0, idx))

    if ext_atten_corrs is not None:
        atten -= float(ext_atten_corrs[idx])
    elif tb >= 0.25:
        atten -= _tables.ATTEN_CORRS_TB25[idx] / _tables.ATTEN_CORR_SCALES[0]
    elif tb >= 0.10:
        atten -= _tables.ATTEN_CORRS_TB10[idx] / _tables.ATTEN_CORR_SCALES[1]
    else:
        atten -= _tables.ATTEN_CORRS_TB00[idx] / _tables.ATTEN_CORR_SCALES[2]
    return atten


def lp_design_params(trans_band: float, req_atten: float,
                     ext_atten_corrs: Optional[np.ndarray] = None
                     ) -> Tuple[float, float, float]:
    """The empirical closed-form design model (CDSPFIRFilter.h:222-448).

    Maps (ReqTransBand%, ReqAtten dB) -> (pwr, hl, fo1):
      pwr — Kaiser window power-raise factor,
      hl  — filter half-length parameter (in transition-band units),
      fo1 — -3 dB frequency offset.
    """
    tb = trans_band * 0.01
    atten = -req_atten
    atten = _atten_correction(tb, req_atten, atten, ext_atten_corrs)

    # Kaiser power fit (:373-378).
    pwr = (
        7.43932822146293e-8 * atten * atten
        + 0.000102747434588003
        * math.cos(0.00785021930010397 * atten)
        * math.cos(0.633854318781239 + 0.103208573657699 * atten)
        - 0.00798132247867036
        - 0.000903555213543865 * atten
        - 0.0969365532127236 * math.exp(0.0779275237937911 * atten)
        - 1.37304948662012e-5 * atten * math.cos(0.00785021930010397 * atten)
    )

    if pwr <= 0.067665322581:
        if tb >= 0.25:  # (:382-392)
            hl = 2.6778150875894 / tb + 300.547590563091 * math.atan(
                math.atan(2.68959772209918 * pwr)
            ) / (5.5099277187035 * tb - tb * math.tanh(math.cos(math.asinh(atten))))
            fo1 = 0.987205355829873 * tb + 1.00011788929851 * math.atan2(
                -0.321432067051302 - 6.19131357321578 * math.sqrt(pwr),
                hl
                + -1.14861472207245 / (hl - 14.1821147585957)
                + math.pow(
                    0.9521145021664,
                    math.pow(math.atan2(1.12018764830637, tb),
                             2.10988901686912 * hl - 20.9691278378345),
                ),
            )
        elif tb >= 0.10:  # (:395-404)
            hl = (
                1.56688617018066
                + 142.064321294568 * pwr
                + 0.00419441117131136 * math.cos(243.633511747297 * pwr)
                - 0.022953443903576 * atten
                - 0.026629568860284 * math.cos(127.715550622571 * pwr)
            ) / tb
            fo1 = 0.982299356642411 * tb + 0.999441744774215 * math.asinh(
                (-0.361783054039583 - 5.80540593623676 * math.sqrt(pwr)) / hl
            )
        else:  # (:406-414)
            hl = (
                2.45739657014937
                + 269.183679500541
                * pwr
                * math.cos(
                    5.73225668178813
                    + math.atan2(
                        math.cosh(0.988861169868941 - 17.2201556280744 * pwr),
                        1.08340138240431 * pwr,
                    )
                )
            ) / tb
            fo1 = (
                2.291956939 * tb
                + 0.01942450693 * tb * tb * hl
                - 4.67538973161837 * pwr * tb
                - 1.668433124 * tb * math.pow(pwr, pwr)
            )
    else:
        if tb >= 0.25:  # (:419-426)
            hl = (
                1.50258368698213
                + 158.556968859477
                * math.asinh(pwr)
                * math.tanh(57.9466246871383 * math.tanh(pwr))
                - 0.0105440479814834 * atten
            ) / tb
            fo1 = 0.994024401639321 * tb + (
                -0.236282717577215 - 6.8724924545387 * math.sqrt(math.sin(pwr))
            ) / hl
        elif tb >= 0.10:  # (:429-436)
            hl = (
                1.50277377248945
                + 158.222625721046
                * math.asinh(pwr)
                * math.tanh(1.02875299001715 + 42.072277322604 * pwr)
                - 0.0108380943845632 * atten
            ) / tb
            fo1 = 0.992539376734551 * tb + (
                -0.251747813037178
                - 6.74159892452584
                * math.sqrt(math.tanh(math.tanh(math.tan(pwr))))
            ) / hl
        else:  # (:440-446)
            hl = (
                1.15990238966306 * pwr
                - 5.02124037125213 * pwr * pwr
                - 0.158676856669827
                * atten
                * math.cos(1.1609073390614 * pwr - 6.33932586197475 * pwr * pwr * pwr)
            ) / tb
            fo1 = (
                0.867344453126885 * tb
                + 0.052693817907757 * tb * math.log(pwr)
                + 0.0895511178735932 * tb * math.atan(59.7538527741309 * pwr)
                - 0.0745653568081453 * pwr * tb
            )

    return pwr, hl, fo1


def build_lp_filter(
    norm_freq: float,
    trans_band: float,
    req_atten: float,
    phase: int = LINEAR_PHASE,
    req_gain: float = 1.0,
    ext_atten_corrs: Optional[np.ndarray] = None,
) -> LPFilter:
    """Design a low-pass FIR filter (buildLPFilter, CDSPFIRFilter.h:220-537).

    norm_freq: normalized corner frequency (0, 1]; stop band spans above it.
    trans_band: transition band in percent of [0, norm_freq], 0.5..45.
    req_atten: required stop-band attenuation, dB, 49..218.
    phase: LINEAR_PHASE (minimum phase is refused: not in this copy).
    req_gain: overall DC gain of the returned kernel (exact).
    """
    if not (0.0 < norm_freq <= 1.0):
        raise ValueError("norm_freq must be in (0, 1]")
    if not (LP_MIN_TRANS_BAND <= trans_band <= LP_MAX_TRANS_BAND):
        raise ValueError("trans_band out of range [0.5, 45]")
    if not (LP_MIN_ATTEN <= req_atten <= LP_MAX_ATTEN):
        raise ValueError("req_atten out of range [49, 218]")
    if phase != LINEAR_PHASE:
        raise ValueError("the reference's design is linear phase only")

    pwr, hl, fo1 = lp_design_params(trans_band, req_atten, ext_atten_corrs)

    # Kernel generation (:450-466): Kaiser window with beta capped at 125,
    # power-raised by pwr; Len2 = 0.25*hl/NormFreq; corner at
    # pi*(1-fo1)*NormFreq.
    len2 = 0.25 * hl / norm_freq
    freq2 = math.pi * (1.0 - fo1) * norm_freq
    kernel, fl2 = generate_band_kernel(
        len2, 0.0, freq2, window="kaiser", params=(125.0, pwr), use_power=True
    )

    kernel = normalize_fir(kernel, req_gain)

    return LPFilter(
        kernel=kernel,
        latency=fl2,
        latency_frac=0.0,
        is_zero_phase=True,
        norm_freq=norm_freq,
        trans_band=trans_band,
        atten=req_atten,
        phase=phase,
        req_gain=req_gain,
    )


# -- Filter cache (CDSPFIRFilterCache, CDSPFIRFilter.h:547-719) --------------
# The reference keeps a mutex-guarded intrusive list capped at
# R8B_FILTER_CACHE_MAX = 96 entries (r8bconf.h:90).  Design happens on the
# host here, so a plain LRU dict with the same capacity is the idiomatic
# equivalent.

_LP_CACHE_MAX = 96
_lp_cache: "OrderedDict[tuple, LPFilter]" = OrderedDict()


def get_lp_filter(
    norm_freq: float,
    trans_band: float,
    req_atten: float,
    phase: int = LINEAR_PHASE,
    req_gain: float = 1.0,
    ext_atten_corrs: Optional[np.ndarray] = None,
) -> LPFilter:
    """Cached filter lookup (getLPFilter, CDSPFIRFilter.h:598-694)."""
    key = (norm_freq, trans_band, req_atten, phase, req_gain,
           ext_atten_corrs is None)
    if ext_atten_corrs is None and key in _lp_cache:
        _lp_cache.move_to_end(key, last=False)
        return _lp_cache[key]
    flt = build_lp_filter(norm_freq, trans_band, req_atten, phase, req_gain,
                          ext_atten_corrs)
    if ext_atten_corrs is None:
        _lp_cache[key] = flt
        _lp_cache.move_to_end(key, last=False)
        while len(_lp_cache) > _LP_CACHE_MAX:
            _lp_cache.popitem(last=True)
    return flt


def lp_cache_size() -> int:
    """Number of cached filters (getObjCount, CDSPFIRFilter.h:559-564)."""
    return len(_lp_cache)


def clear_lp_cache() -> None:
    _lp_cache.clear()
