"""Stage executors, the framing copies (``ops/operators.py::
FramedOperator.apply``: ``shifted``'s padded copy before each
``frac_whole`` call): device time, ms a call, of the operations launched
inside the program's ``r8b.frame`` spans.  Nothing where the program
opens no such span."""

SPAN = "r8b.frame"


def read(run):
    tr = run.trace
    if tr is None or run.kind != "oneshot" or not tr.ops \
            or not tr.spans(SPAN):
        return None
    return tr.device_s_under(SPAN) / run.window.items * 1e3
