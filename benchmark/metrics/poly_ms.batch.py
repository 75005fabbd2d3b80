"""Polynomial stage (``ops/stages.py::FracPolyExec``): device time, ms a
call, of the operations launched inside the executor's span."""

SPAN = "bench.exec.FracPolyExec"


def read(run):
    if run.trace is None or run.kind != "oneshot" or not run.trace.ops \
            or not run.trace.spans(SPAN):
        return None
    return run.trace.device_s_under(SPAN) / run.window.items * 1e3
