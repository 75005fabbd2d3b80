"""The floor of the guarantee chain's work: the ozaki stages' multiply-adds
at the least cost of a form that reaches the guarantee class.

``harness/work.py`` prices a multiply-add at 3 bf16 tensor-core products,
the least any float32-accurate form costs.  The guarantee class (the
float64 conversion delivered in float32 within about one rounding of the
output) asks more of each product, so its floor has a price of its own,
argued here from the class, never from a kernel's packing:

* Each operand must be carried to 32 bits below its power-of-two scale
  (the row's for the signal, the column's for the operator): 24 for the
  float32 output and 8 guard bits, so the sum's own error stays below
  2^-8 of the output's rounding.
* Carried in slices of 8 bits, 4 a side, the products whose weight
  2^-8(p+q) exceeds 2^-32 are the pairs with p + q <= 3: 10 slice
  products a multiply-add.  No split into narrower multiplies does with
  fewer, since a pair left out is worth up to 2^-24 of the scale, about
  the output's rounding.
* The cheapest multiply that holds an 8-bit slice exactly is int8
  (balanced base-256 digits, exact int32 sums) at 1979 TOP/s on an H100,
  twice the bf16 rate: 10 products cost 5 bf16-product times.  bf16
  slices cost 10, TF32 slices (11 bits, 3 a side, 6 pairs at 495
  TFLOP/s) 12, one FP64 multiply-add at 67 TFLOP/s (the FP64 tensor-core
  rate, twice the CUDA cores') 989 / 67 = 14.8.

So ``PRODUCTS_PER_MAC`` = 5, under the 10 slice pairs of the ozaki form
and under FP64.  The same reasoning at 24 bits (3 slices, 6 pairs, int8)
gives ``work.py``'s 3.

The work counted is that of the stages that run on ``ozaki_framed``
(conv, whole-step fractional and half-band stages; a polynomial stage
runs its own split products and is left out), counted from the frozen
plan as ``work.py`` counts it.  Bytes: the call's input read once and its
output written once.
"""

from __future__ import annotations

from ..reference.chain import work_counts
from ..reference.plan import FracStage
from .work import Peak, macs

__all__ = ["PRODUCTS_PER_MAC", "framed_macs", "oneshot_floor"]

PRODUCTS_PER_MAC = 5


def framed_macs(stages, out_len: int, rows: int) -> float:
    """Multiply-adds of the stages that run on ``ozaki_framed``, for a
    oneshot of ``rows`` rows and ``out_len`` outputs."""
    outs = work_counts(stages, out_len)
    kept = [(st, n) for st, n in zip(stages, outs)
            if not (isinstance(st, FracStage) and not st.is_whole)]
    return macs([st for st, _ in kept], [n for _, n in kept], rows)


def oneshot_floor(stages, peak: Peak, rows: int, n_in: int, out_len: int,
                  item_bytes: int) -> float:
    """Floor seconds of the framed stages of one oneshot of ``rows`` x
    ``n_in`` samples at the guarantee class's price."""
    ops_s = 2 * PRODUCTS_PER_MAC * framed_macs(stages, out_len, rows) \
        / peak.flops
    return max(ops_s, item_bytes * rows * (n_in + out_len) / peak.bytes_per_s)
