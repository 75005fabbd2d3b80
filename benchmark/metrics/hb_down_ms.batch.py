"""Stage executors, the half-band down cascade (``ops/stages.py::
HBDownExec``): device time, ms a call, of the operations launched inside
the program's ``r8b.exec.HBDownExec`` spans (each stage's framing copy
and its ``frac_whole`` call).  Nothing where the program opens no such
span."""

SPAN = "r8b.exec.HBDownExec"


def read(run):
    tr = run.trace
    if tr is None or run.kind != "oneshot" or not tr.ops \
            or not tr.spans(SPAN):
        return None
    return tr.device_s_under(SPAN) / run.window.items * 1e3
