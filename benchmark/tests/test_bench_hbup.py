"""The DSD64 encoding cell (``pcm_dsd64_batch``) on the CPU: the
configuration builds the conv stage and the half-band up cascade; the
frozen plan against the program's own; the plain reference (per-stage
half-band upsamplers in float64, no cascade) against the program's oracle,
and the program's CPU path against the reference; the control and the
faults come out as not correct, and the tiny run's last line keeps the
schema; the half-band up floor (``harness/work_hbup.py``) counted by hand
on a two-stage plan and at the cell's size, and 0 for a plan without
half-band up stages; the two new readers on hand-made and traced runs.
On the card (``cuda``): the cell's run is correct, and the control fails
at the cell's own size."""

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
from benchmark.harness.work import oneshot_floor as step_floor
from benchmark.harness.work_hbup import cascade_io, hbup_macs, oneshot_floor
from benchmark.reference import Chain, make_plan, work_counts
from benchmark.reference.plan import ConvStage, HBUpStage
from benchmark.tests import test_bench_card as card_tests
from benchmark.tests import test_bench_faults as faults
from benchmark.tests import test_bench_result as result
from benchmark.tests.support import ROOT, run_cpu
from benchmark.tests.test_bench_trace import Ev

CELL = "pcm_dsd64_batch"
CONFIG = "cd24_44k1_dsd64"
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("hb_up_ms.batch", "hb_up_roofline_pct.batch")
HB = "r8b.exec.HBUpCascadeExec"
#: A call's input and the stages' outputs at 0.5 s (22,050 samples): the
#: conv, then the half-band upsamplers nt 11, 6, 5, 4, 3.
N_IN = 22050
OUTS = [44116, 88210, 176408, 352806, 705603, 1411200]
DSD64 = (44100.0, 2822400.0)
#: Input samples a row of the CPU comparisons (262,144 outputs).
N_CPU = 4096


def _config():
    return Bench(ROOT).config(CONFIG)


def test_configuration_runs_the_cascade():
    """A toeplitz conv on frac_whole, then the five half-band upsamplers
    as one cascade at U = 32; the cut is the mix's 0.5 s."""
    from benchmark.harness.loop import build_system, input_len

    cfg = _config()
    tr = Bench(ROOT).traffic(Bench(ROOT).workload(CELL)["traffic"])
    assert cfg["reduced"] == ["input_seconds"]
    assert input_len(cfg, tr) == N_IN and tr["channels"] == 1024
    assert (tr["inflight"], tr["distinct"], tr["check_calls"]) == (4, 4, 3)
    rs = build_system(cfg, torch.device("cpu"))
    assert [(type(e).__name__, e.engine) for e in rs.execs] == [
        ("ConvExec", "toeplitz"), ("HBUpCascadeExec", "matmul")]
    casc = rs.execs[1]
    assert (casc.U, casc.P, casc.E) == (32, 21, 135)
    assert (casc.op.L_f, casc.op.Kcols) == (157, 4096)
    assert (rs.execs[0].op.L_f, rs.execs[0].op.Kcols) == (964, 512)


def test_limits_within_the_class():
    lim = _config()["limits"]["oneshot"]
    assert lim["worst_row_rms"] == pytest.approx(10 ** (-141 / 20),
                                                 rel=1e-15)
    assert 0 < lim["max_abs"] < 1e-4


def _x(n, seed=7):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, n), generator=g, dtype=torch.float32) * 2 - 1


def test_frozen_plan_is_the_programs():
    """The frozen plan's stages are the port's ``Resampler.plan``'s, stage
    for stage: the conv (its kernel, up, down and offset) and five
    half-band upsamplers (their taps and latencies)."""
    from r8brain_torch import Resampler

    ref = make_plan(*DSD64, 2.0, 180.15, 0).stages
    got = Resampler(*DSD64, 2.0, 180.15, device="cpu").plan.stages
    assert [s.kind for s in ref] == [s.kind for s in got] == \
        ["conv"] + ["hb_up"] * 5
    for a, b in zip(ref, got):
        if a.kind == "hb_up":
            assert a.hb.num_taps == b.hb.num_taps
            assert np.array_equal(np.asarray(a.hb.taps),
                                  np.asarray(b.hb.taps))
            assert a.out_latency == b.out_latency
        else:
            assert (a.up, a.down, a.offset) == (b.up, b.down, b.offset)
            assert np.array_equal(np.asarray(a.filt.kernel),
                                  np.asarray(b.filt.kernel))
    assert [s.hb.num_taps for s in ref[1:]] == [11, 6, 5, 4, 3]
    assert (ref[0].up, ref[0].down, ref[0].filt.kernel_len) == (2, 1, 1417)


def test_reference_runs_each_stage():
    """The reference composes nothing: one coefficient set a stage, the
    half-band ones the published taps of each upsampler."""
    plan = make_plan(*DSD64, 2.0, 180.15, 0)
    chain = Chain(plan, "cpu")
    assert len(chain.coef) == len(plan.stages) == 6
    assert isinstance(chain.stages[0], ConvStage)
    for st, c in zip(chain.stages[1:], chain.coef[1:]):
        assert isinstance(st, HBUpStage)
        assert np.array_equal(c.numpy(), np.asarray(st.hb.taps))


def test_reference_equals_the_oracle():
    """The float64 reference against the program's float64 oracle on 2
    rows of 4096 inputs (262,144 outputs a row)."""
    from r8brain_torch.models.oracle import OracleResampler

    x = _x(N_CPU)
    n = int(np.floor(N_CPU * DSD64[1] / DSD64[0]))
    y = Chain(make_plan(*DSD64, 2.0, 180.15, 0), "cpu").run(
        oneshot_source(x)(0, 2), 0, n).numpy()
    for r in range(2):
        o = OracleResampler(*DSD64, 4096, 2.0, 180.15).oneshot(
            x[r].double().numpy())
        assert o.shape == (n,)
        assert np.abs(y[r] - o).max() < 1e-13


def test_program_oneshot_within_the_class():
    """The program's float32 CPU path (the cascade and its edge) against
    the reference: each row within the -141 dB class, and no sample past
    the cell's max_abs."""
    from r8brain_torch import Resampler

    x = _x(N_CPU)
    y = Resampler(*DSD64, 2.0, 180.15, device="cpu").oneshot(x).double()
    ref = Chain(make_plan(*DSD64, 2.0, 180.15, 0), "cpu").run(
        oneshot_source(x)(0, 2), 0, y.shape[1])
    d = y - ref
    assert d.square().mean(dim=1).sqrt().max().item() < 10 ** (-141 / 20)
    assert d.abs().max().item() < _config()["limits"]["oneshot"]["max_abs"]


@pytest.mark.parametrize("seed", faults.SEEDS)
def test_control_fails(seed):
    """The control on 2 batches of 8 rows x 4096 inputs: a limit missed by
    3x or more."""
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


#: 44.1k -> 352.8k (DXD): a conv, then two half-band upsamplers (nt 11,
#: 6), 0.1 s of output.
DXD, DXD_OUT = (44100.0, 352800.0), 35280


def test_two_stage_plan_by_hand():
    """At 35,280 final outputs the last upsampler needs (35279 // 2) + 6
    + 1 = 17,646 inputs and the first (17645 // 2) + 11 + 1 = 8,834; the
    odd outputs cost 2 x nt: 8,823 x 22 + 17,640 x 12 = 405,786 a row.
    The cascade reads the conv's 8,834 outputs and writes 35,280."""
    st = make_plan(*DXD, 2.0, 180.15, 0).stages
    assert [s.kind for s in st] == ["conv", "hb_up", "hb_up"]
    assert [s.hb.num_taps for s in st[1:]] == [11, 6]
    assert [s.out_latency for s in st[1:]] == [0, 0]
    assert work_counts(st, DXD_OUT) == [8834, 17646, 35280]
    assert hbup_macs(st, DXD_OUT, 1) == 8823 * 22 + 17640 * 12 == 405786
    assert hbup_macs(st, DXD_OUT, 3) == 3 * 405786
    assert cascade_io(st, 4410, DXD_OUT) == (8834, 35280)
    peak = Peak(989e12, 3.35e12)
    got = oneshot_floor(st, peak, 1024, 4410, DXD_OUT, 4)
    nbytes = 4 * 1024 * (8834 + 35280)
    assert 2 * 3 * 1024 * 405786 / 989e12 < nbytes / 3.35e12
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    # a card whose operations bound the floor instead
    slow = Peak(1e9, 3.35e12)
    assert oneshot_floor(st, slow, 1024, 4410, DXD_OUT, 4) == \
        pytest.approx(2 * 3 * 1024 * 405786 / 1e9, rel=1e-12)


def test_cascade_first_reads_the_call_input():
    """A plan whose half-band upsamplers come first reads the call's
    input: the two-stage plan with its conv taken off."""
    st = make_plan(*DXD, 2.0, 180.15, 0).stages[1:]
    assert cascade_io(st, 8834, DXD_OUT) == (8834, 35280)


def test_cell_stage_outputs_and_macs():
    """work_counts at 1,411,200 final outputs; every odd half-band output
    costs 2 x nt (nt 11, 6, 5, 4, 3), the conv 709 a output (1417 taps,
    2 phases)."""
    st = frozen_plan(_config()).stages
    assert work_counts(st, 1411200) == OUTS
    hb = sum(n // 2 * 2 * nt for n, nt in zip(OUTS[1:], (11, 6, 5, 4, 3)))
    assert hb == 10848796
    assert hbup_macs(st, 1411200, 1024) == 1024 * hb
    assert macs(st, OUTS, 1) == hb + OUTS[0] * 709
    assert cascade_io(st, N_IN, 1411200) == (OUTS[0], OUTS[-1])


def test_cell_floors_are_the_bytes():
    """1024 rows: the cascade reads the conv's 44,116 outputs and writes
    1,411,200 a row, 5.962 GB, 1.7794 ms at 3.35 TB/s, above the 0.0674 ms
    of its operations; the whole call's floor (work.py) 1.7524 ms of
    bytes, above 0.2617 ms of operations."""
    st = frozen_plan(_config()).stages
    nbytes = 4 * 1024 * (OUTS[0] + OUTS[-1])
    ops = 2 * 3 * 1024 * 10848796 / 989e12
    assert ops < nbytes / 3.35e12
    got = oneshot_floor(st, Peak.of(H100), 1024, N_IN, 1411200, 4)
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert got * 1e3 == pytest.approx(1.7794, abs=1e-4)
    whole = step_floor(st, Peak.of(H100), 1024, N_IN, 1411200, 4)
    assert whole * 1e3 == pytest.approx(1.7524, abs=1e-4)
    assert 2 * 3 * macs(st, OUTS, 1024) / 989e12 * 1e3 == \
        pytest.approx(0.2617, abs=1e-4)


@pytest.mark.parametrize("rates", [(44100.0, 96000.0), (44100.0, 96001.0),
                                   (2822400.0, 176400.0)])
def test_zero_without_half_band_up_stages(rates):
    st = make_plan(*rates, 2.0, 180.15, 0).stages
    n = int(rates[1])
    assert hbup_macs(st, n, 1024) == 0
    assert cascade_io(st, int(rates[0]), n) == (0, 0)
    assert oneshot_floor(st, Peak.of(H100), 1024, int(rates[0]), n, 4) \
        == 0.0


def _events(program=True):
    """Two oneshots in a 0-100 ns window.  Each launches the conv's
    kernel outside ``r8b.exec.HBUpCascadeExec``, then inside it the
    cascade's kernel and its edge's GEMM (in ``r8b.hb.edge``); the device
    runs the convs 10-20 and 50-60, the cascade's kernels 20-40 and
    60-80, the edges 40-42 and 80-82.  ``program`` False drops the
    spans."""
    evs = [Ev("bench.window", 0, 100, annotation=True)]
    for k, (h, d) in enumerate(((5, 10), (45, 50))):
        evs += [Ev("cudaLaunchKernel", h + 1, h + 2, corr=3 * k + 1),
                Ev("cudaLaunchKernel", h + 4, h + 5, corr=3 * k + 2),
                Ev("cudaLaunchKernel", h + 7, h + 8, corr=3 * k + 3),
                Ev("frac_split_kernel", d, d + 10, device=True,
                   corr=3 * k + 1),
                Ev("frac_split_kernel", d + 10, d + 30, device=True,
                   corr=3 * k + 2),
                Ev("sm90_xmma_gemm_f64f64", d + 30, d + 32, device=True,
                   corr=3 * k + 3)]
        if program:
            evs += [Ev(HB, h + 3, h + 9, annotation=True),
                    Ev("r8b.hb.edge", h + 6, h + 9, annotation=True)]
    return evs


def _run(trace, card=H100, config=None):
    w = SimpleNamespace(items=2, channels=1024, item_len=N_IN)
    return SimpleNamespace(trace=trace, kind="oneshot", window=w,
                           config=config or _config(), card=card)


def test_readers_on_a_hand_made_trace():
    """The cascade's spans launched 2 x (20 + 2) ns of device work, its
    kernel and its edge; the conv, launched outside, counts in neither."""
    b = Bench(ROOT)
    run = _run(Trace.of_events(_events()))
    floor = 2 * oneshot_floor(frozen_plan(_config()).stages, Peak.of(H100),
                              1024, N_IN, 1411200, 4)
    assert b.reader("hb_up_ms.batch").read(run) == pytest.approx(22e-6)
    assert b.reader("hb_up_roofline_pct.batch").read(run) == \
        pytest.approx(100 * floor / 44e-9)
    assert b.reader("hb_up_roofline_pct.batch").read(
        _run(run.trace, card="a card peaks.json does not hold")) is None


def test_roofline_none_for_a_plan_without_the_stages():
    """A configuration with no half-band up stage has no floor to read,
    whatever the trace holds."""
    for name in ("cd24_44k1_96k", "cd24_dsd64_176k4"):
        cfg = Bench(ROOT).config(name)
        run = _run(Trace.of_events(_events()), config=cfg)
        assert Bench(ROOT).reader("hb_up_roofline_pct.batch").read(run) \
            is None


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_spans_or_trace(name):
    """No trace, or a trace of a program without the spans: the reader
    gives None and the line leaves the metric out."""
    reader = Bench(ROOT).reader(name)
    assert reader.read(_run(None)) is None
    assert reader.read(_run(Trace.of_events(_events(False)))) is None


def test_traced_tiny_run_holds_the_spans(monkeypatch):
    """A traced tiny run on the CPU records one cascade executor span and
    one edge span inside it a call, on the main thread where the readers
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
    assert len(tr.spans(HB)) == calls
    assert len(tr.spans("r8b.hb.edge")) == calls
    assert not tr.ops
    assert not set(READERS) & set(out["metrics"])
