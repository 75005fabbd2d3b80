"""Stream (``models/stream.py``): the median host time, ms, for
``StreamResampler.process_block_device`` to return, before the
synchronise that follows it, over the traced window's blocks (the
profiler's own cost included)."""


def read(run):
    return run.median_entry_ms() if run.kind == "stream" else None
