"""On the card, the guarantee cell (``guarantee_96k_batch``): its run is
correct on fresh seeds; its two controls fail at the cell's own size on
three seeds each (the fast float32 chain of the same plan, which is
``cd24_44k1_96k``'s program, and the reference in TF32); a traced run
reads both new metrics, and the program's spans and counter are in it.
``-s`` prints the readings."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness.cell import execute
from benchmark.harness.check import (NUMBERS, _numbers, control_readings,
                                     frozen_plan, oneshot_source, out_len)
from benchmark.harness.loop import build_system, input_len, make_pool
from benchmark.harness.spec import Bench
from benchmark.reference.chain import Chain
from benchmark.tests.support import ROOT

pytestmark = pytest.mark.cuda

CELL = "guarantee_96k_batch"
CONTROL_SEEDS = (11, 2147483693, 60000000007)


def _cell():
    b = Bench(ROOT)
    wl = b.workload(CELL)
    cfg, tr = b.config(wl["config"]), b.traffic(wl["traffic"])
    return b, cfg, tr, b.loop(tr["kind"])


@pytest.mark.parametrize("seed", [3221225473, 4294967311])
def test_cell_is_correct(seed, card):
    out = execute(ROOT, CELL, seed, 2.0, False, card, time.perf_counter())
    print(CELL, seed, out["check"], out["_info"])
    assert out["correct"] is True


def test_fast_chain_fails_at_cell_size(card):
    """The fast float32 chain of the same plan in the program's place, on
    every batch of the cell's pool: a limit exceeded on each seed."""
    b, cfg, tr, loop = _cell()
    fast = b.config("cd24_44k1_96k")
    assert frozen_plan(fast).describe() == frozen_plan(cfg).describe()
    rs = build_system(fast, card)
    chain = Chain(frozen_plan(cfg), card)
    limits = cfg["limits"][loop.LIMITS]
    C, N = tr["channels"], input_len(cfg, tr)
    n = out_len(cfg, N)
    for seed in CONTROL_SEEDS:
        pool = make_pool(seed, (tr["distinct"], C, N), card)
        worst = dict.fromkeys(NUMBERS, 0.0)
        with torch.no_grad():
            for x in pool:
                got = _numbers(chain, oneshot_source(x), rs.oneshot(x), C, 0,
                               n)
                worst = {k: max(worst[k], got[k]) for k in NUMBERS}
        print("fast", seed, worst)
        assert any(worst[k] > limits[k] for k in NUMBERS)


def test_tf32_control_fails_at_cell_size(card):
    _b, cfg, tr, loop = _cell()
    limits = cfg["limits"][loop.LIMITS]
    shape = (tr["distinct"], tr["channels"], input_len(cfg, tr))
    for seed in CONTROL_SEEDS:
        got = control_readings(cfg, loop, make_pool(seed, shape, card), [],
                               card)
        print("tf32", seed, got)
        assert any(got[k] > limits[k] for k in NUMBERS)


def test_traced_run_reads_the_new_metrics(card):
    """``ozaki_roofline_pct.batch`` within (0, 100], ``carry_ms.batch``
    positive; ``ozaki_framed.macs`` counted over the window's calls (the
    profiler records only there), the same each call."""
    from r8brain_torch.utils import trace

    trace.reset_counters()
    out = execute(ROOT, CELL, 2147483659, 2.0, True, card,
                  time.perf_counter())
    macs = trace.counters().get("ozaki_framed.macs", 0)
    trace.reset_counters()
    m = {k: v["value"] for k, v in out["metrics"].items()}
    print(CELL, m, out["breakdown"], macs)
    assert out["correct"] is True
    assert 0 < m["ozaki_roofline_pct.batch"] <= 100
    assert m["carry_ms.batch"] > 0
    items = out["attempted"]
    assert macs > 0 and macs % items == 0
