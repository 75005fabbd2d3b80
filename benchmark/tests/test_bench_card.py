"""On the card: each cell's run is correct on fresh seeds, and the
control fails at the cell's own size on three seeds.  ``-s`` prints the
readings."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness.cell import execute
from benchmark.harness.check import NUMBERS, control_readings
from benchmark.harness.loop import input_len, make_pool
from benchmark.harness.spec import Bench
from benchmark.tests.support import CELLS, ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell, card):
    out = execute(ROOT, cell, 3221225473, 2.0, False, card,
                  time.perf_counter())
    print(cell, out["check"], out["_info"])
    assert out["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell, card):
    b = Bench(ROOT)
    wl = b.workload(cell)
    cfg, tr = b.config(wl["config"]), b.traffic(wl["traffic"])
    loop = b.loop(tr["kind"])
    if tr["kind"] == "oneshot":
        shape = (tr["distinct"], tr["channels"], input_len(cfg, tr))
    else:
        from r8brain_torch import Resampler, StreamResampler

        block = StreamResampler(Resampler(**dict(
            cfg["args"], dtype=torch.float32), device="cpu"),
            tr["block_len"]).block
        shape = (tr["distinct"], tr["channels"], block)
    limits = cfg["limits"][loop.LIMITS]
    for seed in (11, 2147483693, 60000000007):
        pool = make_pool(seed, shape, card)
        got = control_readings(cfg, loop, pool, [0, 6, 7, 1001, 1002],
                               card)
        print(cell, seed, got)
        assert any(got[k] > limits[k] for k in NUMBERS)
