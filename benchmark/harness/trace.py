"""The traced run: ``torch.profiler`` over the window, reduced to intervals.

Spans are ``record_function`` ranges that the benchmark opens itself
(nothing inside the program changes): ``bench.window`` around the window,
``bench.entry`` around each call of the entry, and
``bench.exec.<class>`` around each executor of ``rs.execs`` (its
``forward``, ``apply_v`` and ``apply_df``, wrapped on the instance in the
traced run only).  A device operation belongs to a span when the host
call that launched it (the runtime event of the same correlation id) ran
inside the span.  Spans are the host's ranges only: the profiler also
echoes each range on the device's timeline, over the device time of what
was launched inside it, which lags the host by the calls in flight; an
echo taken for a host range would claim the launches of later stages.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

__all__ = ["Trace", "profiler", "span", "wrap_executors"]

EXEC_METHODS = ("forward", "apply_v", "apply_df")
TOP = 10  # entries of each breakdown list


def span(name: str):
    return torch.profiler.record_function(name)


def wrap_executors(execs) -> None:
    """Open ``bench.exec.<class>`` around each executor's entry methods."""
    for e in execs:
        name = f"bench.exec.{type(e).__name__}"
        for m in EXEC_METHODS:
            f = getattr(e, m, None)
            if f is None:
                continue

            def wrapped(*a, _f=f, _n=name, **kw):
                with span(_n):
                    return _f(*a, **kw)

            object.__setattr__(e, m, wrapped)


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _on_device(e) -> bool:
    """An event on the device's timeline: a kernel, copy or fill, or the
    device-side echo of a host range."""
    return str(e.device_type()).rsplit(".", 1)[-1] != "CPU"


def _is_echo(e) -> bool:
    return e.is_user_annotation() or e.name().startswith("bench.")


def _is_launch(name: str) -> bool:
    """A runtime or driver call that hands work to the device."""
    return name.startswith("cu")


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


class Trace:
    """The window's device operations and host ranges, in nanoseconds."""

    def __init__(self, prof):
        self._read(prof.profiler.kineto_results.events())

    @classmethod
    def of_events(cls, events) -> "Trace":
        t = cls.__new__(cls)
        t._read(events)
        return t

    def _read(self, events) -> None:
        win = [e for e in events
               if e.name() == "bench.window" and not _on_device(e)]
        if not win:
            raise RuntimeError("traced run: no bench.window span")
        w = win[0]
        self.t0, self.t1 = w.start_ns(), w.end_ns()
        self.window_s = (self.t1 - self.t0) * 1e-9
        thread = w.start_thread_id()
        self.ops: List[Tuple[int, int, str, int]] = []  # device
        self.host: List[Tuple[int, int, str]] = []      # main thread
        launch: Dict[int, int] = {}
        for e in events:
            s, t = e.start_ns(), e.end_ns()
            if _on_device(e):
                if not _is_echo(e) and t > s and t > self.t0 \
                        and s < self.t1:
                    self.ops.append((max(s, self.t0), min(t, self.t1),
                                     e.name(), e.correlation_id()))
            elif e.start_thread_id() == thread:
                self.host.append((s, t, e.name()))
                if _is_launch(e.name()):
                    launch[e.correlation_id()] = s
        self.launch = launch
        self.busy = _merge([(s, t) for s, t, _, _ in self.ops])
        self.busy_s = sum(t - s for s, t in self.busy) * 1e-9

    def device_s_by_name(self) -> Dict[str, float]:
        acc: Dict[str, float] = defaultdict(float)
        for s, t, name, _ in self.ops:
            acc[name] += (t - s) * 1e-9
        return dict(acc)

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return [(s, t) for s, t, n in self.host if n == name]

    def device_s_under(self, name: str) -> float:
        """Device seconds of the operations launched inside any span
        ``name`` (nested spans of one name count once)."""
        iv = _merge(self.spans(name))
        starts = [s for s, _ in iv]
        total = 0
        for s, t, _, corr in self.ops:
            at = self.launch.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= iv[i][1]:
                total += t - s
        return total * 1e-9

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device time in the window, by the innermost host range
        that was open when each gap began ("host: no range" outside every
        range)."""
        gaps, prev = [], self.t0
        for s, t in self.busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))
        acc: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[int, int, str]] = []
        i = 0
        for g0, g1 in gaps:  # gaps and ranges both in time order
            while i < len(host) and host[i][0] <= g0:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] <= g0:
                stack.pop()
            acc[stack[-1][2] if stack else "host: no range"] += \
                (g1 - g0) * 1e-9
        return dict(acc)

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.device_s_by_name()),
                "idle_gaps": top(self.idle_gaps())}

