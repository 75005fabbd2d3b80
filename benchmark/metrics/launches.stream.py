"""Stream (``StreamResampler``): device operations (kernels, copies,
fills) a block, whose launching runtime call ran inside the program's
``r8b.stream.block`` span, over the traced window's blocks."""

from benchmark.harness.program import launches_per_root


def read(run):
    if run.trace is None or run.kind != "stream":
        return None
    return launches_per_root(run.trace, "stream")
