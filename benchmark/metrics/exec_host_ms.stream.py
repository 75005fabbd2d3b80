"""Stage executors under the stream (``run_chain``'s executor calls,
kernel wrappers included): the median over the traced window's blocks of
the host ms inside ``r8b.exec.*`` spans within the block's
``r8b.stream.block`` span."""

import statistics

from benchmark.harness.program import exec_split_ms


def read(run):
    if run.trace is None or run.kind != "stream":
        return None
    split = exec_split_ms(run.trace, "stream")
    return None if split is None else statistics.median(e for _, e in split)
