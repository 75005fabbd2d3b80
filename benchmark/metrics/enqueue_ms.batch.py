"""Front end (``models/resampler.py``: ``oneshot``, ``run_chain``): the
median host time, ms, for ``Resampler.oneshot`` to return, before any
synchronise, over the traced window's calls (the profiler's own cost
included)."""


def read(run):
    return run.median_entry_ms() if run.kind == "oneshot" else None
