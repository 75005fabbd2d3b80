"""The traced run's reduction on a hand-made trace: a device operation
belongs to the span whose host range launched it, never to a range's
echo on the device's timeline."""

from __future__ import annotations

import pytest

from benchmark.harness.trace import Trace

MAIN = 7


class Ev:
    def __init__(self, name, s, t, device=False, corr=0, annotation=False):
        self._n, self._s, self._t = name, s, t
        self._dev, self._corr, self._ann = device, corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def start_thread_id(self):
        return MAIN

    def correlation_id(self):
        return self._corr


def _events():
    """The polynomial stage launches a GEMM at 12, the next conv stage its
    kernel at 25; the device runs them at 22-35 and 35-60, so the poly
    span's echo on the device (22-35) covers the conv's launch."""
    return [
        Ev("bench.window", 22, 60, device=True, annotation=True),
        Ev("bench.exec.FracPolyExec", 22, 35, device=True, annotation=True),
        Ev("bench.window", 0, 100, annotation=True),
        Ev("bench.exec.FracPolyExec", 10, 20, annotation=True),
        Ev("cudaLaunchKernel", 12, 13, corr=1),
        Ev("bench.exec.ConvExec", 20, 30, annotation=True),
        Ev("cuLaunchKernel", 25, 26, corr=2),
        Ev("gemm", 22, 35, device=True, corr=1),
        Ev("frac_split_kernel", 35, 60, device=True, corr=2),
    ]


def test_span_echo_claims_no_launch():
    tr = Trace.of_events(_events())
    assert (tr.t0, tr.t1) == (0, 100)
    assert tr.device_s_under("bench.exec.FracPolyExec") == pytest.approx(
        13e-9)
    assert tr.device_s_under("bench.exec.ConvExec") == pytest.approx(25e-9)
    assert [n for _, _, n, _ in tr.ops] == ["gemm", "frac_split_kernel"]
    assert tr.busy_s == pytest.approx(38e-9)


def test_idle_gaps_by_host_range():
    """Idle 0-22 and 60-100, each begun with only the window's host range
    open (the echoes open none)."""
    gaps = Trace.of_events(_events()).idle_gaps()
    assert gaps == {"bench.window": pytest.approx(62e-9)}
