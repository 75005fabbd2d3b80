"""The DSD64 cell (``dsd64_176k4_batch``) on the CPU: the configuration
builds the half-band down cascade; the plain reference against the
program's oracle and its CPU path, and the frozen plan against the
program's own; the control and the faults come out as not correct, and
the tiny run's last line keeps the schema; the cascade's floor
(``harness/work_halfband.py``) counted by hand, and 0 for a plan without
half-band down stages; the three new readers on hand-made and traced
runs.  On the card (``cuda``): the cell's run is correct, and the
control fails at the cell's own size."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import trace as tracing
from benchmark.harness.check import (NUMBERS, control_readings, frozen_plan,
                                     oneshot_source)
from benchmark.harness.loop import make_pool
from benchmark.harness.spec import Bench
from benchmark.harness.trace import Trace
from benchmark.harness.work import Peak, macs
from benchmark.harness.work_halfband import halfband_macs, oneshot_floor
from benchmark.reference import Chain, make_plan, work_counts
from benchmark.tests import test_bench_card as card_tests
from benchmark.tests import test_bench_faults as faults
from benchmark.tests import test_bench_result as result
from benchmark.tests.support import ROOT, run_cpu
from benchmark.tests.test_bench_trace import Ev

CELL = "dsd64_176k4_batch"
CONFIG = "cd24_dsd64_176k4"
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("hb_down_ms.batch", "hb_down_roofline_pct.batch",
           "frame_ms.batch")
HB = "r8b.exec.HBDownExec"
#: A call's input and the stages' outputs at 0.5 s (1,411,200 samples).
N_IN, OUTS = 1411200, [708478, 354234, 177107, 88200]
DSD64 = (2822400.0, 176400.0)
#: Input samples a row of the CPU comparisons: the plan's conv stage
#: emits 256 outputs a block, and 16384 inputs give 1024 (4 blocks).
N_CPU = 16384


def _config():
    return Bench(ROOT).config(CONFIG)


def test_configuration_runs_the_cascade():
    """Three half-band decimators on frac_whole, then the decimating
    toeplitz conv; the cut is the mix's 0.5 s."""
    from benchmark.harness.loop import build_system, input_len

    cfg = _config()
    tr = Bench(ROOT).traffic(Bench(ROOT).workload(CELL)["traffic"])
    assert cfg["reduced"] == ["input_seconds"]
    assert input_len(cfg, tr) == N_IN and tr["channels"] == 1024
    rs = build_system(cfg, torch.device("cpu"))
    assert [(type(e).__name__, e.engine) for e in rs.execs] == [
        ("HBDownExec", "matmul")] * 3 + [("ConvExec", "toeplitz")]
    assert [e.op.L_f for e in rs.execs[:3]] == [274, 278, 298]


def test_limits_within_the_class():
    lim = _config()["limits"]["oneshot"]
    assert lim["worst_row_rms"] == pytest.approx(10 ** (-141 / 20),
                                                 rel=1e-15)
    assert 0 < lim["max_abs"] < 1e-4


def _x(n, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, n), generator=g, dtype=torch.float32) * 2 - 1


def test_reference_equals_the_oracle():
    """The float64 reference against the program's oracle on 2 rows of 4
    conv blocks."""
    from r8brain_torch.models.oracle import OracleResampler

    x = _x(N_CPU)
    n = int(np.floor(N_CPU * DSD64[1] / DSD64[0]))
    y = Chain(make_plan(*DSD64, 2.0, 180.15, 0), "cpu").run(
        oneshot_source(x)(0, 2), 0, n).numpy()
    for r in range(2):
        o = OracleResampler(*DSD64, 4096, 2.0, 180.15).oneshot(
            x[r].double().numpy())
        assert np.abs(y[r] - o).max() < 1e-13


def test_program_oneshot_within_the_class():
    """The program's float32 CPU path against the reference: each row
    within the -141 dB class."""
    from r8brain_torch import Resampler

    x = _x(N_CPU)
    y = Resampler(*DSD64, 2.0, 180.15, device="cpu").oneshot(x).double()
    ref = Chain(make_plan(*DSD64, 2.0, 180.15, 0), "cpu").run(
        oneshot_source(x)(0, 2), 0, y.shape[1])
    rms = (y - ref).square().mean(dim=1).sqrt().max().item()
    assert rms < 10 ** (-141 / 20)


def test_frozen_plan_is_the_programs():
    """The frozen plan's stages are the port's ``Resampler.plan``'s, stage
    for stage: three half-band decimators (their taps) and a decimating
    conv (its kernel, down and offset)."""
    from r8brain_torch import Resampler

    ref = make_plan(*DSD64, 2.0, 180.15, 0).stages
    got = Resampler(*DSD64, 2.0, 180.15, device="cpu").plan.stages
    assert [s.kind for s in ref] == [s.kind for s in got] == \
        ["hb_down"] * 3 + ["conv"]
    for a, b in zip(ref, got):
        if a.kind == "hb_down":
            assert a.hb.num_taps == b.hb.num_taps
            assert np.array_equal(np.asarray(a.hb.taps),
                                  np.asarray(b.hb.taps))
            assert a.out_latency == b.out_latency
        else:
            assert (a.up, a.down, a.offset) == (b.up, b.down, b.offset)
            assert np.array_equal(np.asarray(a.filt.kernel),
                                  np.asarray(b.filt.kernel))
    assert [s.hb.num_taps for s in ref[:3]] == [5, 6, 11]
    assert (ref[3].up, ref[3].down, ref[3].filt.kernel_len) == (1, 2, 1417)


@pytest.mark.parametrize("seed", faults.SEEDS)
def test_control_fails(seed):
    """The control on 2 rows of 4 conv blocks: a limit missed by 3x or
    more."""
    bench = Bench(ROOT)
    cfg, loop = bench.config(CONFIG), bench.loop("oneshot")
    pool = make_pool(seed, (2, 8, N_CPU), torch.device("cpu"))
    got = control_readings(cfg, loop, pool, [], "cpu")
    limits = cfg["limits"][loop.LIMITS]
    assert any(got[k] > 3 * limits[k] for k in NUMBERS), got


@pytest.mark.parametrize("fault", ["half_batch_left_out", "answer_altered",
                                   "stale_answer"])
def test_fault_is_not_correct(fault, monkeypatch):
    faults.test_fault_is_not_correct(CELL, fault, monkeypatch)


@pytest.mark.parametrize("trace", [False, True])
def test_result_schema(trace):
    result.test_result_schema(CELL, trace)


@pytest.mark.cuda
def test_cell_is_correct(card):
    card_tests.test_cell_is_correct(CELL, card)


@pytest.mark.cuda
def test_control_fails_at_cell_size(card):
    card_tests.test_control_fails_at_cell_size(CELL, card)


def test_stage_outputs_and_macs_by_hand():
    """work_counts at 88,200 final outputs; every half-band output costs
    2 x nt multiply-adds (nt 5, 6, 11), the conv 1417 a output."""
    st = frozen_plan(_config()).stages
    assert work_counts(st, 88200) == OUTS
    hb = OUTS[0] * 10 + OUTS[1] * 12 + OUTS[2] * 22
    assert hb == 15231942
    assert halfband_macs(st, 88200, 1024) == 1024 * hb
    assert macs(st, OUTS, 1) == hb + OUTS[3] * 1417


def test_floor_is_the_bytes():
    """1024 rows: the cascade reads its input and writes its last output
    once, 6.506 GB, 1.9420 ms at 3.35 TB/s, above the 0.095 ms of its
    operations."""
    st = frozen_plan(_config()).stages
    nbytes = 4 * 1024 * (N_IN + OUTS[2])
    ops = 2 * 3 * 1024 * 15231942 / 989e12
    assert ops < nbytes / 3.35e12
    got = oneshot_floor(st, Peak.of(H100), 1024, N_IN, 88200, 4)
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert got * 1e3 == pytest.approx(1.9420, abs=1e-4)


@pytest.mark.parametrize("dst", [96000.0, 96001.0])
def test_zero_without_half_band_down_stages(dst):
    st = make_plan(44100.0, dst, 2.0, 180.15, 0).stages
    n = int(dst)
    assert halfband_macs(st, n, 1024) == 0
    assert oneshot_floor(st, Peak.of(H100), 1024, 44100, n, 4) == 0.0


def _events(program=True):
    """Two oneshots in a 0-100 ns window.  Each launches a framing copy
    inside an ``r8b.frame`` span inside ``r8b.exec.HBDownExec`` and its
    kernel after it in the same executor span, then the conv outside it;
    the device runs the copies 20-24 and 60-64, the kernels 24-40 and
    64-80, the convs 40-50 and 80-90.  ``program`` False drops the
    spans, as a tree without them runs."""
    evs = [Ev("bench.window", 0, 100, annotation=True)]
    for k, (h, d) in enumerate(((10, 20), (52, 60))):
        evs += [Ev("cudaLaunchKernel", h + 1, h + 2, corr=3 * k + 1),
                Ev("cudaLaunchKernel", h + 4, h + 5, corr=3 * k + 2),
                Ev("cudaLaunchKernel", h + 7, h + 8, corr=3 * k + 3),
                Ev("CatArrayBatchedCopy", d, d + 4, device=True,
                   corr=3 * k + 1),
                Ev("frac_split_kernel", d + 4, d + 20, device=True,
                   corr=3 * k + 2),
                Ev("frac_split_kernel", d + 20, d + 30, device=True,
                   corr=3 * k + 3)]
        if program:
            evs += [Ev(HB, h, h + 6, annotation=True),
                    Ev("r8b.frame", h, h + 3, annotation=True)]
    return evs


def _run(trace, card=H100, config=None):
    w = SimpleNamespace(items=2, channels=1024, item_len=N_IN)
    return SimpleNamespace(trace=trace, kind="oneshot", window=w,
                           config=config or _config(), card=card)


def test_readers_on_a_hand_made_trace():
    """The half-band spans launched 2 x (4 + 16) ns of device work, the
    framing spans 2 x 4; the conv, launched outside both, counts in
    neither."""
    b = Bench(ROOT)
    run = _run(Trace.of_events(_events()))
    floor = 2 * oneshot_floor(frozen_plan(_config()).stages, Peak.of(H100),
                              1024, N_IN, 88200, 4)
    assert b.reader("hb_down_ms.batch").read(run) == pytest.approx(20e-6)
    assert b.reader("frame_ms.batch").read(run) == pytest.approx(4e-6)
    assert b.reader("hb_down_roofline_pct.batch").read(run) == \
        pytest.approx(100 * floor / 40e-9)
    assert b.reader("hb_down_roofline_pct.batch").read(
        _run(run.trace, card="a card peaks.json does not hold")) is None


def test_roofline_none_for_a_plan_without_the_stages():
    """A configuration with no half-band down stage has no floor to read,
    whatever the trace holds."""
    cfg = Bench(ROOT).config("cd24_44k1_96k")
    run = _run(Trace.of_events(_events()), config=cfg)
    assert Bench(ROOT).reader("hb_down_roofline_pct.batch").read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_spans_or_trace(name):
    """No trace, or a trace of a program without the spans (the parent
    has no r8b.frame span): the reader gives None and the line leaves the
    metric out."""
    reader = Bench(ROOT).reader(name)
    assert reader.read(_run(None)) is None
    assert reader.read(_run(Trace.of_events(_events(False)))) is None


def test_traced_tiny_run_holds_the_spans(monkeypatch):
    """A traced tiny run on the CPU records three half-band executor spans
    and four framing spans a call on the main thread, where the readers
    look for them; a CPU trace holds no device operation, so the readers
    give None there."""
    seen = []

    class Kept(Trace):
        def __init__(self, prof):
            super().__init__(prof)
            seen.append(self)

    monkeypatch.setattr(tracing, "Trace", Kept)
    out = run_cpu(CELL, trace=True)
    tr, = seen
    calls = len(tr.spans("r8b.oneshot"))
    assert calls >= out["attempted"] > 0
    assert len(tr.spans(HB)) == 3 * calls
    assert len(tr.spans("r8b.frame")) == 4 * calls
    assert not tr.ops
    assert not set(READERS) & set(out["metrics"])
