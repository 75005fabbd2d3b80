"""Stage executors (``ops/fused.py``, ``ops/stages.py``): the share, %, of
the device's operation time in the window spent in memory-only work:
copies (casts among them), fills, pads, concatenations and elementwise
adds, by the names the profiler gives."""

import re

GLUE = re.compile(r"Memcpy|Memset|copy|Copy|FillFunctor|fill_kernel|_pad|"
                  r"pad_|CatArray|CUDAFunctor_add|AddFunctor")


def read(run):
    if run.trace is None or run.kind != "oneshot":
        return None
    by_name = run.trace.device_s_by_name()
    total = sum(by_name.values())
    if total <= 0:
        return None
    return 100 * sum(s for k, s in by_name.items() if GLUE.search(k)) / total
