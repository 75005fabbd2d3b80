"""The readers of the program's own spans on hand-made traces: launches
counted by correlation inside the root span, a block's self time beside
its executors', and idle gaps put down to an open ``r8b.*`` span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness.spec import Bench
from benchmark.harness.trace import Trace
from benchmark.tests.support import ROOT
from benchmark.tests.test_bench_trace import Ev

NEW = ("launches.batch", "launches.stream", "stream_host_ms.stream",
       "exec_host_ms.stream", "program_idle_pct.stream")


def _stream_events(program=True):
    """Two blocks of a stream in a window of 0-200 ns.  Block 1 (10-60)
    copies its window (12-18, a copy launched at 14) and runs its
    executor (20-50, the kernel's span 30-45, a kernel launched at 35);
    the loop launches one op of its own at 65; block 2 (100-140) runs its
    executor (105-125, a kernel launched at 110).  The device runs the
    copy 16-20 and the kernels 40-80, 80-90 and 115-130.  ``program``
    False drops the program's spans, as a tree without them runs."""
    evs = [
        Ev("bench.window", 0, 200, annotation=True),
        Ev("bench.entry", 8, 62, annotation=True),
        Ev("bench.entry", 98, 142, annotation=True),
        Ev("cudaMemcpyAsync", 14, 15, corr=2),
        Ev("cudaLaunchKernel", 35, 36, corr=1),
        Ev("cudaLaunchKernel", 65, 66, corr=3),
        Ev("cudaLaunchKernel", 110, 111, corr=4),
        Ev("Memcpy HtoD", 16, 20, device=True, corr=2),
        Ev("frac_split_kernel", 40, 80, device=True, corr=1),
        Ev("elementwise", 80, 90, device=True, corr=3),
        Ev("frac_split_kernel", 115, 130, device=True, corr=4),
    ]
    if program:
        evs += [
            Ev("r8b.stream.block", 10, 60, annotation=True),
            Ev("r8b.stream.window", 12, 18, annotation=True),
            Ev("r8b.exec.FusedUpExec", 20, 50, annotation=True),
            Ev("r8b.kernel.frac_whole", 30, 45, annotation=True),
            Ev("r8b.stream.block", 100, 140, annotation=True),
            Ev("r8b.exec.FusedUpExec", 105, 125, annotation=True),
            Ev("r8b.kernel.frac_whole", 108, 120, annotation=True),
            # the block's echo on the device's timeline is no host range
            Ev("r8b.stream.block", 16, 90, device=True, annotation=True),
        ]
    return evs


def _oneshot_events(program=True):
    """Two oneshots (10-40, 50-80), each launching a fill and a kernel
    inside its span; the loop's event record at 45 launches nothing."""
    evs = [
        Ev("bench.window", 0, 100, annotation=True),
        Ev("cudaMemsetAsync", 12, 13, corr=1),
        Ev("cudaLaunchKernel", 20, 21, corr=2),
        Ev("cudaEventRecord", 45, 46, corr=9),
        Ev("cudaMemsetAsync", 52, 53, corr=3),
        Ev("cudaLaunchKernel", 60, 61, corr=4),
        Ev("Memset", 14, 16, device=True, corr=1),
        Ev("frac_split_kernel", 22, 50, device=True, corr=2),
        Ev("Memset", 54, 56, device=True, corr=3),
        Ev("frac_split_kernel", 62, 95, device=True, corr=4),
    ]
    if program:
        evs += [Ev("r8b.oneshot", 10, 40, annotation=True),
                Ev("r8b.exec.FusedUpExec", 18, 38, annotation=True),
                Ev("r8b.oneshot", 50, 80, annotation=True)]
    return evs


def _read(name, kind, events):
    run = SimpleNamespace(trace=Trace.of_events(events), kind=kind)
    return Bench(ROOT).reader(name).read(run)


def test_launches_counted_by_correlation():
    """Ops belong to a call when their launch ran inside its root span:
    2 of 2 a oneshot; 3 of the stream's 4 (the loop's own launch at 65 is
    no block's)."""
    assert _read("launches.batch", "oneshot", _oneshot_events()) == 2.0
    assert _read("launches.stream", "stream", _stream_events()) == 1.5
    assert _read("launches.batch", "stream", _stream_events()) is None


def test_block_self_time_minus_executors():
    """Block 1: 50 ns, 30 under its executor (the kernel's span inside it
    counts once); block 2: 40 ns, 20 under its executor.  Self times 20
    and 20, executor times 30 and 20: medians 20 and 25 ns."""
    ev = _stream_events()
    assert _read("stream_host_ms.stream", "stream", ev) == \
        pytest.approx(20e-6)
    assert _read("exec_host_ms.stream", "stream", ev) == pytest.approx(25e-6)


def test_idle_put_down_to_open_program_span():
    """Busy 16-20, 40-90, 115-130.  Gaps begin at 0 (no span open), 20
    (the executor's span, just opened), 90 (between blocks) and 130
    (block 2): 20 + 70 of 200 ns, 45 %; ``idle_pct.stream`` reads 65.5
    %."""
    ev = _stream_events()
    assert _read("program_idle_pct.stream", "stream", ev) == \
        pytest.approx(45.0)
    assert _read("idle_pct.stream", "stream", ev) == pytest.approx(65.5)


def test_gap_begun_as_a_span_closes_is_not_the_programs():
    """A gap that begins at the very end of the only program span is the
    loop's: the span is closed by then."""
    ev = [Ev("bench.window", 0, 100, annotation=True),
          Ev("r8b.stream.block", 10, 40, annotation=True),
          Ev("cudaLaunchKernel", 12, 13, corr=1),
          Ev("k", 20, 40, device=True, corr=1)]
    assert _read("program_idle_pct.stream", "stream", ev) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_no_program_spans_reads_nothing(name):
    """A tree whose program opens no spans: every new reader gives None,
    so its line leaves the metric out."""
    kind = "oneshot" if name.endswith("batch") else "stream"
    events = _oneshot_events(False) if kind == "oneshot" \
        else _stream_events(False)
    assert _read(name, kind, events) is None
