"""Kernels (``ozaki_framed``, ``csrc/ozaki_framed.cu`` via
``ops/pallas_ozaki.py``): the floor time of the framed stages' work in the
window at the guarantee class's price (``harness/work_guarantee.py``: the
larger of 5 bf16-product times a multiply-add at the card's peak and the
calls' input and output bytes at its bandwidth) over the device time of
the operations launched inside the program's ``r8b.kernel.ozaki_framed``
spans, %.  Nothing without those spans, or on a card that
``harness/peaks.json`` does not list."""

from benchmark.harness.check import frozen_plan, out_len
from benchmark.harness.work import Peak, item_bytes
from benchmark.harness.work_guarantee import oneshot_floor

SPAN = "r8b.kernel.ozaki_framed"


def read(run):
    tr = run.trace
    if tr is None or run.kind != "oneshot" or not tr.ops \
            or not tr.spans(SPAN):
        return None
    peak = Peak.of(run.card)
    busy = tr.device_s_under(SPAN)
    if peak is None or busy <= 0:
        return None
    w, cfg = run.window, run.config
    floor = w.items * oneshot_floor(
        frozen_plan(cfg).stages, peak, w.channels, w.item_len,
        out_len(cfg, w.item_len), item_bytes(cfg))
    return 100 * floor / busy
