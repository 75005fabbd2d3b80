"""Fractional-delay sinc filter bank construction + cache.

Host-side counterpart of CDSPFracDelayFilterBank / ...Cache
(CDSPFracInterpolator.h:38-597).  The bank samples a Kaiser power-raised
windowed sinc fractional-delay filter at FilterFracs+InterpPoints delay
positions and optionally converts adjacent filters into polynomial-in-x
form (2nd-order spline over 8 points) for interpolated evaluation.

Bank layout here:
  * whole mode (element_size=1, interp_points=2):
      table[f, i] — filter for phase index f in [0, fracs), taps i.
      Used by whole-number-stepping interpolation, one exact filter per
      output phase.
  * poly2 mode (element_size=3, interp_points=8):
      table[f, i, c] — c in {0,1,2}: coefficients of c0 + c1*x + c2*x^2,
      rows f in [0, fracs] inclusive.

The Kaiser (beta, power) parameters and filter lengths come from the baked
Coeffs2/Coeffs3 tables (CDSPFracInterpolator.h:282-312, extracted to
_tables.py); requested attenuation is rounded to the nearest table row
(roundReqAtten, :204-208).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..utils.fir import normalize_fir
from ..utils.math import spline2p8_coeffs
from . import _tables
from .sinc import generate_frac_kernel

__all__ = [
    "FracBank",
    "frac_win_params",
    "round_req_atten",
    "default_filter_fracs",
    "build_frac_bank",
    "get_frac_bank",
    "clear_frac_bank_cache",
]


def frac_win_params(req_atten: float, is_third: bool
                    ) -> Tuple[float, float, float, int]:
    """(beta, power, rounded_atten, filter_len) — getWinParams
    (CDSPFracInterpolator.h:279-341)."""
    if is_third:
        rows, base = _tables.FRAC_COEFFS3, _tables.FRAC_COEFFS3_BASE
    else:
        rows, base = _tables.FRAC_COEFFS2, _tables.FRAC_COEFFS2_BASE
    i = 0
    while i != len(rows) - 1 and rows[i][2] < req_atten:
        i += 1
    beta, power, att = rows[i]
    return beta, power, att, base + i * 2


def round_req_atten(req_atten: float, is_third: bool) -> float:
    """Round attenuation to the nearest effective bank value
    (roundReqAtten, CDSPFracInterpolator.h:204-208)."""
    return frac_win_params(req_atten, is_third)[2]


def default_filter_fracs(rounded_atten: float) -> int:
    """Default fractional position count: ceil(6.4^(atten/50))
    (CDSPFracInterpolator.h:82)."""
    return int(math.ceil(math.pow(6.4, rounded_atten / 50.0)))


@dataclass(frozen=True)
class FracBank:
    """A constructed fractional-delay filter bank."""

    table: np.ndarray  # whole: [fracs, filter_len]; poly2: [fracs+1, filter_len, 3]
    filter_len: int
    fracs: int
    atten: float  # rounded attenuation
    is_third: bool
    mode: str  # "whole" | "poly2"

    @property
    def fl2(self) -> int:
        return self.filter_len // 2


def _raw_filters(num_rows: int, first_i: int, fracs: int, filter_len: int,
                 beta: float, power: float) -> np.ndarray:
    """Rows i = first_i .. first_i+num_rows-1 with FracDelay =
    (fracs - i)/fracs, each normalized to DC gain 1
    (CDSPFracInterpolator.h:103-116)."""
    len2 = filter_len / 2.0
    out = np.empty((num_rows, filter_len), dtype=np.float64)
    for r in range(num_rows):
        i = first_i + r
        fd = (fracs - i) / fracs
        k, _ = generate_frac_kernel(len2, fd, window="kaiser",
                                    params=(beta, power), use_power=True)
        out[r] = normalize_fir(k, 1.0)
    return out


def build_frac_bank(filter_fracs: int, element_size: int, interp_points: int,
                    req_atten: float, is_third: bool) -> FracBank:
    """Construct a bank (CDSPFracDelayFilterBank ctor,
    CDSPFracInterpolator.h:61-189).

    filter_fracs: -1 for the attenuation-derived default, otherwise the
    exact count (whole-stepping passes OutStep).
    element_size / interp_points: (1, 2) whole mode; (3, 8) poly2 mode.
    """
    beta, power, att, filter_len = frac_win_params(req_atten, is_third)
    fracs = default_filter_fracs(att) if filter_fracs == -1 else filter_fracs

    pc2 = interp_points // 2
    first_i = -pc2 + 1
    num_rows = fracs + pc2 - first_i + 1  # i in [first_i, fracs+pc2]

    raw = _raw_filters(num_rows, first_i, fracs, filter_len, beta, power)

    if element_size == 1 and interp_points == 2:
        # Whole-number stepping: one exact filter per phase index
        # f in [0, fracs); row f corresponds to i=f (first_i == 0).
        table = raw[0:fracs].copy()
        mode = "whole"
    elif element_size == 3 and interp_points == 8:
        # 2nd-order spline over 8 adjacent delay rows
        # (CDSPFracInterpolator.h:130-147).  Output row f uses raw rows
        # f..f+7 (raw row r has i = r - 3), giving coefficients at x0 =
        # raw row f+3 == delay index i = f.
        n_out = fracs + 1
        table = np.empty((n_out, filter_len, 3), dtype=np.float64)
        for f in range(n_out):
            c0, c1, c2 = spline2p8_coeffs(
                raw[f], raw[f + 1], raw[f + 2], raw[f + 3],
                raw[f + 4], raw[f + 5], raw[f + 6], raw[f + 7],
            )
            table[f, :, 0] = c0
            table[f, :, 1] = c1
            table[f, :, 2] = c2
        mode = "poly2"
    elif element_size == 2 and interp_points == 2:
        # Linear interpolation between adjacent filters
        # (CDSPFracInterpolator.h:170-183).
        n_out = fracs + 1
        table = np.empty((n_out, filter_len, 2), dtype=np.float64)
        table[:, :, 0] = raw[0:n_out]
        table[:, :, 1] = raw[1 : n_out + 1] - raw[0:n_out]
        mode = "lin"
    else:
        raise ValueError(
            f"unsupported (element_size={element_size}, interp_points={interp_points})"
        )

    return FracBank(table=table, filter_len=filter_len, fracs=fracs,
                    atten=att, is_third=is_third, mode=mode)


# -- Bank cache (CDSPFracDelayFilterBankCache, :421-586) ----------------------
# The reference splits banks into a permanent "static" list (default banks)
# and a refcounted dynamic list capped at R8B_FRACBANK_CACHE_MAX = 12
# (r8bconf.h:103).  Host-side LRU dict with the same cap; "static" entries
# are pinned.

_FRACBANK_CACHE_MAX = 12
_bank_cache: "OrderedDict[tuple, FracBank]" = OrderedDict()
_static_cache: dict = {}


def get_frac_bank(filter_fracs: int, element_size: int, interp_points: int,
                  req_atten: float, is_third: bool,
                  is_static: bool = False) -> FracBank:
    """Cached bank lookup (getFilterBank, CDSPFracInterpolator.h:444-573)."""
    att = round_req_atten(req_atten, is_third)
    key = (filter_fracs, element_size, interp_points, att, is_third)
    if is_static:
        bank = _static_cache.get(key)
        if bank is None:
            bank = build_frac_bank(filter_fracs, element_size, interp_points,
                                   att, is_third)
            _static_cache[key] = bank
        return bank
    if key in _bank_cache:
        _bank_cache.move_to_end(key, last=False)
        return _bank_cache[key]
    bank = build_frac_bank(filter_fracs, element_size, interp_points, att,
                           is_third)
    _bank_cache[key] = bank
    _bank_cache.move_to_end(key, last=False)
    while len(_bank_cache) > _FRACBANK_CACHE_MAX:
        _bank_cache.popitem(last=True)
    return bank


def clear_frac_bank_cache() -> None:
    _bank_cache.clear()
    _static_cache.clear()
