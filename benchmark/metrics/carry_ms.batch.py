"""Stage executors, the df32 carry of the guarantee chain
(``ops/stages.py``: the last stage's seam-residual pass and its collapse,
and any other collapse of a seam's pair): device time, ms a call, of the
operations launched inside the program's ``r8b.ozaki.carry`` spans.
Nothing where the program opens no such span."""

SPAN = "r8b.ozaki.carry"


def read(run):
    tr = run.trace
    if tr is None or run.kind != "oneshot" or not tr.ops \
            or not tr.spans(SPAN):
        return None
    return tr.device_s_under(SPAN) / run.window.items * 1e3
