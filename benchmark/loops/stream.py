"""Stream traffic: ``StreamResampler.process_block_device`` on
``channels`` streams, blocks of ``block_len`` samples (rounded up by the
stream to its period), ``distinct`` blocks made from the seed and cycled;
the first ``warmup_blocks`` run in set-up, then one block at a time, each
synchronised before the next is sent (a closed loop of one caller).

The check keeps the stream's first block and ``check_pairs`` pairs of
consecutive blocks, drawn from the seed over the whole window, so that
every kept pair holds a block seam; each is held against the reference's
outputs at the block's absolute positions in the conversion of the
concatenated blocks.
"""

from __future__ import annotations

import time

from benchmark.harness.check import frozen_plan, stream_source
from benchmark.harness.loop import Device, Reservoir, Window, make_pool
from benchmark.harness.work import emitted, item_bytes, stream_floor

LIMITS = "stream"


def run(rs, tr, config, seed, seconds, device, span, window_ctx) -> Window:
    from r8brain_torch import StreamResampler

    C, distinct = tr["channels"], tr["distinct"]
    dev = Device(device)
    st = StreamResampler(rs, tr["block_len"])
    L = st.block
    pool = make_pool(seed, (distinct, C, L), device)
    dev.sync()
    t_pool = time.perf_counter()
    held, pos = [], 0
    for j in range(tr["warmup_blocks"]):
        y = st.process_block_device(pool[j % distinct])
        dev.sync()
        held.append((j, pos, y))
        pos += y.shape[1]
    first, prev = held[0], held[-1]
    del held
    res = Reservoir(tr["check_pairs"], seed)
    j = tr["warmup_blocks"]
    w = Window("stream", 0.0, 0, C, L, 0.0, pool=pool, distinct=distinct,
               items_before=j,
               marks={"pool": t_pool, "warm": time.perf_counter()})
    dev.sync()
    with window_ctx(), span("bench.window"):
        t0 = w.first_call_at = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            x = pool[j % distinct]
            h0 = time.perf_counter()
            with span("bench.entry"):
                y = st.process_block_device(x)
            h1 = time.perf_counter()
            dev.sync()
            w.latency_s.append(time.perf_counter() - h0)
            w.entry_s.append(h1 - h0)
            cur = (j, pos, y)
            res.offer((prev, cur))
            prev = cur
            pos += y.shape[1]
            j += 1
        w.seconds = time.perf_counter() - t0
    w.items = j - w.items_before
    kept = {first[0]: first}
    for pair in res.items:
        for item in pair:
            kept[item[0]] = item
    w.kept = [kept[i] for i in sorted(kept)]
    return w


def kept(w: Window, config: dict):
    src = stream_source(w.pool)
    for _, pos, y in w.kept:
        yield src, y, pos, pos + y.shape[1]


def control_items(config: dict, pool, picks):
    """Blocks ``picks`` of the stream that cycles ``pool``, their
    positions from the frozen plan's emission counts."""
    stages, L = frozen_plan(config).stages, pool.shape[2]
    src = stream_source(pool)
    return [(src, emitted(stages, j * L)[-1], emitted(stages, (j + 1) * L)[-1])
            for j in picks]


def floor_s(w: Window, config: dict, peak) -> float:
    return stream_floor(frozen_plan(config).stages, peak, w.channels,
                        w.item_len, w.items_before, w.items,
                        item_bytes(config))
