"""Kernels (``csrc/*.cu`` via ``ops/*``): the floor time of the plan's
work in the window (``harness/work.py``: the larger of 3 bf16 products a
multiply-add at the card's peak and the calls' input and output bytes at
its bandwidth) over the device's busy time, %.  Nothing on a card that
``harness/peaks.json`` does not list."""


def read(run):
    if run.trace is None or run.kind != "oneshot" or run.floor_s is None \
            or run.trace.busy_s <= 0:
        return None
    return 100 * run.floor_s / run.trace.busy_s
