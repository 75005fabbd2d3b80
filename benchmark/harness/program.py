"""The program's own spans in the traced run.

r8brain_torch opens ``record_function`` ranges of its own while a
profiler records (``r8brain_torch/utils/trace.py``): ``r8b.oneshot``
around each ``Resampler.oneshot``, ``r8b.stream.block`` around each
stream block, ``r8b.exec.<class>`` around each executor call, and the
stream's and kernels' spans inside them.  These helpers read them from a
``Trace`` (``harness/trace.py``: its main thread's host ranges, device
operations, launches by correlation id and busy intervals); where the
program opened no such span, as before it had any, they find nothing and
the readers return None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .trace import Trace, _merge

__all__ = ["ROOTS", "Intervals", "exec_split_ms", "idle_in_spans_s",
           "launches_per_root"]

#: The root span of one call of a kind of traffic's entry.
ROOTS = {"oneshot": "r8b.oneshot", "stream": "r8b.stream.block"}
EXEC = "r8b.exec."
PROGRAM = "r8b."


class Intervals:
    """The union of host ranges, as sorted disjoint [start, end) intervals
    in nanoseconds."""

    def __init__(self, ranges: List[Tuple[int, int]]):
        self.iv = _merge(ranges)
        self.starts = [s for s, _ in self.iv]
        self.ends = [t for _, t in self.iv]

    @classmethod
    def named(cls, tr: Trace, prefix: str) -> "Intervals":
        """The main thread's ranges whose names start with ``prefix``."""
        return cls([(s, t) for s, t, n in tr.host if n.startswith(prefix)])

    def __bool__(self) -> bool:
        return bool(self.iv)

    def holds(self, at: int) -> bool:
        i = bisect.bisect_right(self.starts, at) - 1
        return i >= 0 and at < self.ends[i]

    def covered(self, s: int, t: int) -> int:
        """Nanoseconds of [s, t] inside the union."""
        total, i = 0, bisect.bisect_right(self.ends, s)
        while i < len(self.iv) and self.starts[i] < t:
            total += min(self.ends[i], t) - max(self.starts[i], s)
            i += 1
        return total


def launches_per_root(tr: Trace, kind: str) -> Optional[float]:
    """Device operations (kernels, copies, fills) whose launching runtime
    call ran inside the kind's root span, over the window's root spans."""
    roots = tr.spans(ROOTS[kind])
    if not roots or not tr.ops:
        return None
    iv = Intervals(roots)
    n = sum(1 for _, _, _, corr in tr.ops
            if corr in tr.launch and iv.holds(tr.launch[corr]))
    return n / len(roots)


def exec_split_ms(tr: Trace, kind: str):
    """Per root span: (host ms inside it that no ``r8b.exec.*`` span
    covers, host ms inside ``r8b.exec.*`` spans), or None without root or
    executor spans."""
    roots, execs = tr.spans(ROOTS[kind]), Intervals.named(tr, EXEC)
    if not roots or not execs:
        return None
    out = []
    for s, t in roots:
        inside = execs.covered(s, t)
        out.append(((t - s - inside) * 1e-6, inside * 1e-6))
    return out


def idle_in_spans_s(tr: Trace, prefix: str = PROGRAM) -> Optional[float]:
    """Idle device seconds in the window whose gap began while a host
    range named ``prefix...`` was open on the main thread."""
    iv = Intervals.named(tr, prefix)
    if not iv:
        return None
    total, prev = 0, tr.t0
    for s, t in tr.busy + [(tr.t1, tr.t1)]:
        if s > prev and iv.holds(prev):
            total += s - prev
        prev = max(prev, t)
    return total * 1e-9
