"""Stage executors, the half-band up cascade (``ops/hb_cascade.py::
HBUpCascadeExec``): device time, ms a call, of the operations launched
inside the program's ``r8b.exec.HBUpCascadeExec`` spans (its
``frac_whole`` call and its float64 edge correction).  Nothing where the
program opens no such span."""

SPAN = "r8b.exec.HBUpCascadeExec"


def read(run):
    tr = run.trace
    if tr is None or run.kind != "oneshot" or not tr.ops \
            or not tr.spans(SPAN):
        return None
    return tr.device_s_under(SPAN) / run.window.items * 1e3
