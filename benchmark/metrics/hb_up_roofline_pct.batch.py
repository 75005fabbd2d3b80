"""Kernels, the half-band up cascade (``frac_whole`` under
``HBUpCascadeExec``): the floor time of the half-band up stages' work in
the window (``harness/work_hbup.py``: the larger of 3 bf16 products a
multiply-add at the card's peak and the cascade's input and last output
bytes at its bandwidth) over the device time of the operations launched
inside the program's ``r8b.exec.HBUpCascadeExec`` spans, %.  Nothing
without those spans, for a plan without such stages, or on a card that
``harness/peaks.json`` does not list."""

from benchmark.harness.check import frozen_plan, out_len
from benchmark.harness.work import Peak, item_bytes
from benchmark.harness.work_hbup import oneshot_floor

SPAN = "r8b.exec.HBUpCascadeExec"


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
    return 100 * floor / busy if floor > 0 else None
