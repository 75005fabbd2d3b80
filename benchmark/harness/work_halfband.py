"""The floor of a chain's half-band down stages: their work counted from
the frozen plan as ``harness/work.py`` counts it, never from the
operator's packing, blocks or folds, so it is the same work whatever
implements it.

* Operations: every output of a half-band down stage x 2 ``num_taps``
  multiply-adds (``work.py``'s ``macs``), at 3 bf16 tensor-core products
  a multiply-add: 2 x 3 x MACs / peak.
* Bytes: the cascade's input read once and its last stage's output
  written once; what the stages hand each other is left out, as a
  cascade in one pass would keep it on the chip.

A stage's outputs are those a oneshot of ``out_len`` final outputs needs
(``reference/chain.py::work_counts``).  The half-band down stages of a
plan run first, one after another (the planner's downsampling branch), so
the cascade's input is the call's.  A plan without them has no floor
here: 0.
"""

from __future__ import annotations

from ..reference.chain import work_counts
from ..reference.plan import HBDownStage
from .work import Peak, macs

__all__ = ["halfband_macs", "oneshot_floor"]


def _kept(stages, out_len: int):
    """(stage, outputs a row) of each half-band down stage of a oneshot of
    ``out_len`` final outputs."""
    outs = work_counts(stages, out_len)
    return [(st, n) for st, n in zip(stages, outs)
            if isinstance(st, HBDownStage)]


def _macs(kept, rows: int) -> float:
    return macs([st for st, _ in kept], [n for _, n in kept], rows)


def halfband_macs(stages, out_len: int, rows: int) -> float:
    """Multiply-adds of the half-band down stages of a oneshot of
    ``rows`` rows and ``out_len`` final outputs."""
    return _macs(_kept(stages, out_len), rows)


def oneshot_floor(stages, peak: Peak, rows: int, n_in: int, out_len: int,
                  item_bytes: int) -> float:
    """Floor seconds of the half-band down stages of one oneshot of
    ``rows`` x ``n_in`` samples (0 for a plan without them)."""
    kept = _kept(stages, out_len)
    if not kept:
        return 0.0
    return peak.floor_s(_macs(kept, rows),
                        item_bytes * rows * (n_in + kept[-1][1]))
