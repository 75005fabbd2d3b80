"""Stream (``models/stream.py``): the median over the traced window's
blocks of the host ms inside the program's ``r8b.stream.block`` span that
no ``r8b.exec.*`` span covers (the stream layer's self time: window
copies, the polynomial tail, the suffix ring, slicing)."""

import statistics

from benchmark.harness.program import exec_split_ms


def read(run):
    if run.trace is None or run.kind != "stream":
        return None
    split = exec_split_ms(run.trace, "stream")
    return None if split is None else statistics.median(s for s, _ in split)
