"""One run of one cell: set-up, the window, the readings, the check."""

from __future__ import annotations

import contextlib
import functools
import gc
import statistics
import time
from dataclasses import dataclass
from typing import Optional

import torch

from . import trace as tracing
from .check import check_window
from .loop import Window, build_system
from .spec import Bench, SpecError
from .work import Peak

__all__ = ["Run", "execute"]


@dataclass
class Run:
    """What a metric's reader (``metrics/<name>.py``) reads."""

    cell: str
    config: dict
    traffic: dict
    window: Window
    trace: Optional[tracing.Trace]
    setup_s: float
    loop: object   # the loop module that ran the window
    card: str      # torch.cuda.get_device_name(), or "cpu"

    @property
    def kind(self) -> str:
        return self.window.kind

    @functools.cached_property
    def floor_s(self) -> Optional[float]:
        """The window's floor seconds on this card (None on a card that
        ``peaks.json`` does not list)."""
        peak = Peak.of(self.card)
        return None if peak is None else self.loop.floor_s(
            self.window, self.config, peak)

    def median_entry_ms(self) -> float:
        return statistics.median(self.window.entry_s) * 1e3


def execute(root, cell: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, traffic_override: dict = None) -> dict:
    """Run cell ``cell`` once; returns the result's fields in order (the
    import check and the printing are the caller's)."""
    device = torch.device(device)
    bench = Bench(root)
    wl = bench.workload(cell)
    config = bench.config(wl["config"])
    traffic = dict(bench.traffic(wl["traffic"]), **(traffic_override or {}))
    loop = bench.loop(traffic["kind"])
    entries = bench.metrics(cell, end_to_end=not trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in entries}

    t_read = time.perf_counter()
    rs = build_system(config, device)
    t_built = time.perf_counter()
    held = {}
    if trace:
        tracing.wrap_executors(rs.execs)

        def window_ctx():
            held["prof"] = tracing.profiler(device)
            return held["prof"]
    else:
        window_ctx = contextlib.nullcontext
    span = tracing.span if trace else (lambda name: contextlib.nullcontext())
    w = loop.run(rs, traffic, config, seed, seconds, device, span,
                 window_ctx)
    cuda = device.type == "cuda"
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    t = time.perf_counter()
    tr = tracing.Trace(held["prof"]) if trace else None
    trace_s = time.perf_counter() - t
    del rs, held
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(cell, config, traffic, w, tr, w.first_call_at - t_start, loop,
              card)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is None and not trace:
            raise SpecError(f"cell {cell!r}: traffic kind {w.kind!r} gives "
                            f"no end-to-end metric {m['name']!r}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t = time.perf_counter()
    check = check_window(w, config, loop, device)
    check_s = time.perf_counter() - t
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    out = {"correct": check["failed"] == 0 and check["compared"] > 0,
           "attempted": w.items, "failed": check["failed"],
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["check"] = {k: {"value": v, "limit": check["limits"][k]}
                    for k, v in check["numbers"].items()}
    out["_info"] = {"compared": check["compared"], "check_s": check_s,
                    "trace_s": trace_s,
                    "window_s": w.seconds, "items": w.items,
                    "block": w.item_len,
                    "setup_parts_s": {
                        "imports": t_read - t_start,
                        "system": t_built - t_read,
                        "pool": w.marks["pool"] - t_built,
                        "warm_up": w.marks["warm"] - w.marks["pool"],
                        "to_window": w.first_call_at - w.marks["warm"]}}
    return out
