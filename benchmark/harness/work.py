"""The work a call needs, counted from the plan, and the card's floor.

The count reads the plan (the reference's frozen copy), never a kernel's
packing, tiles, folds or slices, so it is the same work whatever
implements it:

* a conv stage: its outputs x taps per output phase (ceil(K / up));
* a fractional stage: its outputs x ``filter_len``; in polynomial mode
  also the polynomial's evaluation, 2 multiply-adds a tap and an output
  (Horner on c0 + c1 x + c2 x^2), once a call (every row shares it);
* a half-band stage: its interpolated outputs x 2 ``num_taps`` (up: the
  odd outputs; down: every output).

Operations: 3 tensor-core products a multiply-add at the bf16 peak,
2 x 3 x MACs / peak, the least that any float32-accurate form costs (3 x
TF32, bf16 splits and int8 Ozaki all cost at least that).  Bytes: the
call's input read once and its output written once.  A call's floor is
the larger of the two times.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

from ..reference.chain import stage_out_len, work_counts
from ..reference.plan import ConvStage, FracStage, HBUpStage

__all__ = ["PRODUCTS_PER_MAC", "Peak", "emitted", "item_bytes", "macs",
           "oneshot_floor", "stream_floor"]

PRODUCTS_PER_MAC = 3
ITEM_BYTES = {"float32": 4, "float64": 8}
PEAKS = Path(__file__).with_name("peaks.json")


class Peak:
    """Published peaks of a card (``peaks.json``, by the name that
    ``torch.cuda.get_device_name`` gives)."""

    def __init__(self, flops: float, bytes_per_s: float):
        self.flops, self.bytes_per_s = flops, bytes_per_s

    @classmethod
    def of(cls, kind: str) -> Optional["Peak"]:
        row = json.loads(PEAKS.read_text()).get(kind)
        return None if row is None else cls(row["bf16_flops"],
                                             row["hbm_bytes_per_s"])

    def floor_s(self, macs: float, nbytes: float) -> float:
        return max(2 * PRODUCTS_PER_MAC * macs / self.flops,
                   nbytes / self.bytes_per_s)


def _per_output(st) -> float:
    if isinstance(st, ConvStage):
        return -(-st.filt.kernel_len // st.up)
    if isinstance(st, FracStage):
        return st.filter_len
    return 2 * st.hb.num_taps


def macs(stages, outs: List[int], rows: int) -> float:
    """Multiply-adds of ``rows`` rows whose stages emit ``outs``."""
    total = 0.0
    for st, n in zip(stages, outs):
        if isinstance(st, HBUpStage):
            n = n // 2  # only the odd outputs are interpolated
        total += rows * n * _per_output(st)
        if isinstance(st, FracStage) and not st.is_whole:
            total += 2 * n * st.filter_len
    return total


def oneshot_floor(stages, peak: Peak, rows: int, n_in: int, out_len: int,
                  item_bytes: int) -> float:
    """Floor seconds of one oneshot of ``rows`` x ``n_in`` samples."""
    outs = work_counts(stages, out_len)
    return peak.floor_s(macs(stages, outs, rows),
                        item_bytes * rows * (n_in + out_len))


def item_bytes(config: dict) -> int:
    """Bytes of one sample in the configuration's dtype."""
    return ITEM_BYTES[config["args"]["dtype"]]


def emitted(stages, n_in: int) -> List[int]:
    """What each stage has emitted once ``n_in`` input samples went in."""
    outs = []
    for st in stages:
        n_in = stage_out_len(st, n_in)
        outs.append(n_in)
    return outs


def stream_floor(stages, peak: Peak, rows: int, block: int, first: int,
                 count: int, item_bytes: int) -> float:
    """Floor seconds of stream blocks ``first .. first + count - 1`` (of
    ``block`` samples a row), each block's floor on its own outputs."""
    total = 0.0
    before = emitted(stages, first * block)
    for j in range(first, first + count):
        after = emitted(stages, (j + 1) * block)
        outs = [b - a for a, b in zip(before, after)]
        total += peak.floor_s(macs(stages, outs, rows),
                              item_bytes * rows * (block + outs[-1]))
        before = after
    return total
