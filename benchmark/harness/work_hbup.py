"""The floor of a chain's half-band up stages: their work counted from the
frozen plan as ``harness/work.py`` counts it, never from the cascade's
composite operator, its packing, blocks or folds, so it is the same work
whatever implements it (one composed call, or a call a stage).

* Operations: every odd output of a half-band up stage x 2 ``num_taps``
  multiply-adds (``work.py``'s ``macs``; the even outputs are the input's
  samples), at 3 bf16 tensor-core products a multiply-add: 2 x 3 x MACs /
  peak.
* Bytes: the cascade's input, the output of the stage before it (the
  call's input where the cascade comes first), read once, and its last
  stage's output written once; what the stages hand each other is left
  out, as a cascade in one pass keeps it on the chip.

A stage's outputs are those a oneshot of ``out_len`` final outputs needs
(``reference/chain.py::work_counts``).  The half-band up stages of a plan
run as one run, last (the planner's upsampling branch).  A plan without
them has no floor here: 0.
"""

from __future__ import annotations

from ..reference.chain import work_counts
from ..reference.plan import HBUpStage
from .work import Peak, macs

__all__ = ["cascade_io", "hbup_macs", "oneshot_floor"]


def _kept(stages, out_len: int):
    """(index, stage, outputs a row) of each half-band up stage of a
    oneshot of ``out_len`` final outputs, and every stage's outputs."""
    outs = work_counts(stages, out_len)
    return [(i, st, n) for i, (st, n) in enumerate(zip(stages, outs))
            if isinstance(st, HBUpStage)], outs


def _macs(kept, rows: int) -> float:
    return macs([st for _, st, _ in kept], [n for _, _, n in kept], rows)


def hbup_macs(stages, out_len: int, rows: int) -> float:
    """Multiply-adds of the half-band up stages of a oneshot of ``rows``
    rows and ``out_len`` final outputs."""
    return _macs(_kept(stages, out_len)[0], rows)


def cascade_io(stages, n_in: int, out_len: int):
    """(samples the cascade reads, samples it writes) a row of a oneshot
    of ``n_in`` inputs and ``out_len`` final outputs; (0, 0) without half-
    band up stages."""
    kept, outs = _kept(stages, out_len)
    if not kept:
        return 0, 0
    first = kept[0][0]
    return (outs[first - 1] if first else n_in), kept[-1][2]


def oneshot_floor(stages, peak: Peak, rows: int, n_in: int, out_len: int,
                  item_bytes: int) -> float:
    """Floor seconds of the half-band up stages of one oneshot of
    ``rows`` x ``n_in`` samples (0 for a plan without them)."""
    kept, _ = _kept(stages, out_len)
    if not kept:
        return 0.0
    read, wrote = cascade_io(stages, n_in, out_len)
    return peak.floor_s(_macs(kept, rows), item_bytes * rows * (read + wrote))
