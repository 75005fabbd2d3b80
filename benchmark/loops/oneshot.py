"""Batch traffic: ``Resampler.oneshot`` on ``channels`` x (``input_seconds``
of the source rate) batches; ``distinct`` batches are made on the device
from the seed and cycled.  Calls are dispatched back to back with at most
``inflight`` of them unfinished (a CUDA event each), as a dataset
builder's queue runs; the window ends at the synchronise after the last.

Warm-up holds as many outputs at once as the window can (``check_calls``
kept plus ``inflight``), so the allocator has blocks of their size cached
before the window opens.  ``check_calls`` calls are kept for the check,
drawn from the seed over the whole window; they are the program's own
tensors, so keeping them adds no work to the window.
"""

from __future__ import annotations

import time

from benchmark.harness.check import frozen_plan, oneshot_source, out_len
from benchmark.harness.loop import (Device, Reservoir, Window, input_len,
                                    make_pool)
from benchmark.harness.work import item_bytes, oneshot_floor

LIMITS = "oneshot"


def run(rs, tr, config, seed, seconds, device, span, window_ctx) -> Window:
    C, distinct = tr["channels"], tr["distinct"]
    keep, inflight = tr["check_calls"], tr["inflight"]
    N = input_len(config, tr)
    dev = Device(device)
    pool = make_pool(seed, (distinct, C, N), device)
    dev.sync()
    t_pool = time.perf_counter()
    held = [rs.oneshot(pool[k % distinct])
            for k in range(keep + inflight + 2)]
    dev.sync()
    del held
    res = Reservoir(keep, seed)
    w = Window("oneshot", 0.0, 0, C, N, 0.0, pool=pool, distinct=distinct,
               marks={"pool": t_pool, "warm": time.perf_counter()})
    marks = []
    k = 0
    dev.sync()
    with window_ctx(), span("bench.window"):
        t0 = w.first_call_at = time.perf_counter()
        while True:
            x = pool[k % distinct]
            h0 = time.perf_counter()
            with span("bench.entry"):
                y = rs.oneshot(x)
            w.entry_s.append(time.perf_counter() - h0)
            marks.append(dev.mark())
            res.offer((k, y))
            k += 1
            if len(marks) > inflight:
                m = marks.pop(0)
                if m is not None:
                    m.synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        dev.sync()
        w.seconds = time.perf_counter() - t0
    w.items = k
    w.kept = res.items
    return w


def kept(w: Window, config: dict):
    n = out_len(config, w.item_len)
    for k, y in w.kept:
        yield oneshot_source(w.pool[k % w.distinct]), y, 0, n


def control_items(config: dict, pool, picks):
    """Every batch of ``pool`` (``picks`` are a stream's)."""
    n = out_len(config, pool.shape[2])
    return [(oneshot_source(x), 0, n) for x in pool]


def floor_s(w: Window, config: dict, peak) -> float:
    return w.items * oneshot_floor(
        frozen_plan(config).stages, peak, w.channels, w.item_len,
        out_len(config, w.item_len), item_bytes(config))
