"""The guarantee cell (``guarantee_96k_batch``) on the CPU: a tiny run of
the harness on the program's plain path (``ozaki_framed_ref``) is correct
at the configuration's limits; the planted oneshot faults and the TF32
control are not; the reference takes the configuration as it is; the
floor's price and count; the two new readers on hand-made and traced
runs."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import trace as tracing
from benchmark.harness.check import NUMBERS, control_readings, frozen_plan
from benchmark.harness.loop import make_pool
from benchmark.harness.spec import Bench
from benchmark.harness.trace import Trace
from benchmark.harness.work import PRODUCTS_PER_MAC as FLOAT32_PRODUCTS
from benchmark.harness.work import Peak, macs
from benchmark.harness.work_guarantee import (PRODUCTS_PER_MAC, framed_macs,
                                              oneshot_floor)
from benchmark.reference import make_plan, work_counts
from benchmark.tests.support import ROOT, run_cpu
from benchmark.tests.test_bench_faults import SEEDS, _oneshot_fault
from benchmark.tests.test_bench_trace import Ev

CELL = "guarantee_96k_batch"
CONFIG = "guarantee24_44k1_96k"
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("ozaki_roofline_pct.batch", "carry_ms.batch")
SPANS = ("r8b.ozaki.prep", "r8b.ozaki.carry", "r8b.kernel.ozaki_framed")


def _config():
    return Bench(ROOT).config(CONFIG)


def test_configuration_runs_the_guarantee_chain():
    """The configuration builds the unfused ozaki chain with the carry on
    (the environment leaves R8BT_DF_CARRY unset)."""
    from benchmark.harness.loop import build_system

    cfg = _config()
    assert cfg["reduced"] == [] and cfg["args"]["precision"] == "high"
    rs = build_system(cfg, torch.device("cpu"))
    assert rs.df_carry
    assert [(type(e).__name__, e.engine) for e in rs.execs] == [
        ("ConvExec", "ozaki"), ("FracWholeExec", "ozaki")]


def test_reference_takes_the_configuration_unchanged():
    """The reference reads only the rates, band, attenuation and phase:
    the plan is cd24_44k1_96k's, stage for stage."""
    cfg, fast = _config(), Bench(ROOT).config("cd24_44k1_96k")
    assert frozen_plan(cfg).describe() == frozen_plan(fast).describe()
    keys = ("src_rate", "dst_rate", "trans_band", "atten", "phase")
    assert {k: cfg["args"][k] for k in keys} == \
        {k: fast["args"][k] for k in keys}


def test_limits_within_the_class():
    """Both limits of each kind no looser than the -150 dB class."""
    for lim in _config()["limits"].values():
        assert lim["worst_row_rms"] <= 10 ** (-150 / 20)
        assert set(lim) == set(NUMBERS)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(trace):
    out = run_cpu(CELL, trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    for v in out["check"].values():
        assert v["value"] <= v["limit"]
    want = {m["name"] for m in Bench(ROOT).metrics(CELL, not trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == {"batch_mrops", "setup_s"}


@pytest.mark.parametrize(
    "fault", ["half_batch_left_out", "answer_altered", "stale_answer"])
def test_fault_is_not_correct(fault, monkeypatch):
    cls, name, broken = _oneshot_fault(fault)
    monkeypatch.setattr(cls, name, broken)
    out = run_cpu(CELL)
    assert out["correct"] is False and out["failed"] > 0
    assert any(v["value"] > v["limit"] for v in out["check"].values())


@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails(seed):
    """The reference in TF32 in the program's place misses a limit by 3x
    or more (the fast float32 chain, the configuration's own control, is
    held to the limits on the card: test_bench_guarantee_card.py)."""
    bench = Bench(ROOT)
    cfg, loop = bench.config(CONFIG), bench.loop("oneshot")
    pool = make_pool(seed, (2, 8, 4410), torch.device("cpu"))
    got = control_readings(cfg, loop, pool, [], "cpu")
    assert any(got[k] > 3 * cfg["limits"]["oneshot"][k] for k in NUMBERS)


def test_price_between_float32_and_the_ozaki_form():
    """The guarantee class costs more than the float32 class, no more than
    the ozaki form's 10 slice pairs, and less than FP64 at 67 TFLOP/s."""
    assert FLOAT32_PRODUCTS < PRODUCTS_PER_MAC <= 10
    assert PRODUCTS_PER_MAC < 989 / 67


def test_flagship_floor():
    """44.1k -> 96k, 1024 rows: both stages run on ozaki_framed; 64,846,308
    multiply-adds a row (work.py's count), priced at 5 products."""
    st = make_plan(44100.0, 96000.0, 2.0, 180.15, 0).stages
    assert framed_macs(st, 96000, 1) == 88212 * 709 + 96000 * 24
    peak = Peak.of(H100)
    ops = 2 * 5 * 1024 * (88212 * 709 + 96000 * 24) / 989e12
    assert ops > 4 * 1024 * (44100 + 96000) / 3.35e12
    assert oneshot_floor(st, peak, 1024, 44100, 96000, 4) == \
        pytest.approx(ops, rel=1e-12)
    assert ops * 1e3 == pytest.approx(0.6714, abs=1e-4)


def test_polynomial_stage_left_out():
    """44.1k -> 96001: the two conv stages run on ozaki_framed, the
    polynomial stage its own products, which the count leaves out."""
    st = make_plan(44100.0, 96001.0, 2.0, 180.15, 0).stages
    outs = work_counts(st, 96001)
    convs = [st[0], st[2]]
    assert framed_macs(st, 96001, 4) == macs(convs, [outs[0], outs[2]], 4)


def _events(program=True):
    """Two oneshots in a 0-100 ns window.  Each launches its conv kernel
    inside an ``r8b.kernel.ozaki_framed`` span and the second the carry's
    pass inside ``r8b.ozaki.carry``; the device runs the kernels 20-50
    and 70-95 and the carry 55-59.  ``program`` False drops the spans, as
    a tree without them runs."""
    evs = [Ev("bench.window", 0, 100, annotation=True),
           Ev("cudaLaunchKernel", 12, 13, corr=1),
           Ev("cudaLaunchKernel", 56, 57, corr=2),
           Ev("cudaLaunchKernel", 62, 63, corr=3),
           Ev("ozaki_framed_kernel", 20, 50, device=True, corr=1),
           Ev("elementwise", 55, 59, device=True, corr=2),
           Ev("ozaki_framed_kernel", 70, 95, device=True, corr=3)]
    if program:
        evs += [Ev("r8b.kernel.ozaki_framed", 10, 15, annotation=True),
                Ev("r8b.ozaki.carry", 54, 58, annotation=True),
                Ev("r8b.kernel.ozaki_framed", 60, 65, annotation=True)]
    return evs


def _run(trace, card=H100):
    w = SimpleNamespace(items=2, channels=1024, item_len=44100)
    return SimpleNamespace(trace=trace, kind="oneshot", window=w,
                           config=_config(), card=card)


def test_readers_on_a_hand_made_trace():
    """The kernels' 55 ns against two calls' floor; the carry's 4 ns over
    two calls."""
    b = Bench(ROOT)
    run = _run(Trace.of_events(_events()))
    floor = 2 * oneshot_floor(frozen_plan(_config()).stages, Peak.of(H100),
                              1024, 44100, 96000, 4)
    assert b.reader("ozaki_roofline_pct.batch").read(run) == \
        pytest.approx(100 * floor / 55e-9)
    assert b.reader("carry_ms.batch").read(run) == pytest.approx(2e-6)
    assert b.reader("ozaki_roofline_pct.batch").read(
        _run(run.trace, card="a card peaks.json does not hold")) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_spans_or_trace(name):
    """No trace, or a trace of a program without the spans (the parent
    has no carry span): the reader gives None and the line leaves the
    metric out."""
    reader = Bench(ROOT).reader(name)
    assert reader.read(_run(None)) is None
    events = _events(False)
    if name == "ozaki_roofline_pct.batch":  # the kernel's span predates
        events += [Ev("r8b.ozaki.carry", 54, 58, annotation=True)]
    assert reader.read(_run(Trace.of_events(events))) is None


def test_traced_tiny_run_holds_the_spans(monkeypatch):
    """A traced tiny run on the CPU records the program's new spans on the
    main thread, where the readers look for them; a CPU trace holds no
    device operation, so both readers give None there (the card's numbers:
    test_bench_guarantee_card.py)."""
    seen = []

    class Kept(Trace):
        def __init__(self, prof):
            super().__init__(prof)
            seen.append(self)

    monkeypatch.setattr(tracing, "Trace", Kept)
    out = run_cpu(CELL, trace=True)
    tr, = seen
    for name in SPANS:
        assert len(tr.spans(name)) >= out["attempted"], name
    assert not tr.ops
    assert not set(READERS) & set(out["metrics"])
