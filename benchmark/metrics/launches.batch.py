"""Stage executors (``run_chain`` under ``Resampler.oneshot``): device
operations (kernels, copies, fills) a call, whose launching runtime call
ran inside the program's ``r8b.oneshot`` span, over the traced window's
calls."""

from benchmark.harness.program import launches_per_root


def read(run):
    if run.trace is None or run.kind != "oneshot":
        return None
    return launches_per_root(run.trace, "oneshot")
