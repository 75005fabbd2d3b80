"""The plan-based work count and floor against hand counts."""

from __future__ import annotations

import pytest

from benchmark.harness.work import Peak, macs, oneshot_floor, stream_floor
from benchmark.reference import make_plan, stage_out_len, work_counts

H100 = "NVIDIA H100 80GB HBM3"


def _plan(dst):
    return make_plan(44100.0, dst, 2.0, 180.15, 0).stages


def test_flagship_counts():
    st = _plan(96000.0)
    # conv up 2, 1417 taps: 709 a phase; frac whole 147/160, 24 taps.  The
    # frac stage's 96000 outputs read conv outputs up to
    # (95999 * 147) // 160 - 11 + 24 = 88212.
    assert work_counts(st, 96000) == [88212, 96000]
    assert macs(st, [88212, 96000], 1) == 88212 * 709 + 96000 * 24
    assert abs(macs(st, [88212, 96000], 1) - 64.8e6) < 0.1e6


def test_96001_counts():
    st = _plan(96001.0)
    # conv2 (up 2, 611 taps: 306 a phase, offset 305) reads poly outputs
    # up to (96000 + 305) // 2 + 1 = 48153; those read conv1 outputs up
    # to floor(48152 * 176400 / 96001) - 11 + 24 = 88491.
    assert [s.filt.kernel_len for s in (st[0], st[2])] == [1417, 611]
    assert work_counts(st, 96001) == [88491, 48153, 96001]
    per_row = 88491 * 709 + 48153 * 24 + 96001 * 306
    per_call = 2 * 48153 * 24  # the polynomial's evaluation, once a call
    assert macs(st, [88491, 48153, 96001], 1024) == \
        1024 * per_row + per_call
    assert abs(per_row - 93.27e6) < 0.01e6


def test_floor_is_the_larger_bound():
    peak = Peak.of(H100)
    st = _plan(96000.0)
    ops = 2 * 3 * 1024 * (88212 * 709 + 96000 * 24) / 989e12
    nbytes = 4 * 1024 * (44100 + 96000) / 3.35e12
    assert ops > nbytes
    assert oneshot_floor(st, peak, 1024, 44100, 96000, 4) == \
        pytest.approx(ops, rel=1e-12)
    assert Peak.of("a card the table does not hold") is None


def test_stream_floor_sums_blocks():
    peak = Peak.of(H100)
    st = _plan(96001.0)
    L = 8192

    def emitted(n):
        out = []
        for s in st:
            n = stage_out_len(s, n)
            out.append(n)
        return out

    total = 0.0
    for j in (6, 7, 8):
        outs = [b - a for a, b in zip(emitted(j * L), emitted((j + 1) * L))]
        total += peak.floor_s(macs(st, outs, 1024),
                              4 * 1024 * (L + outs[-1]))
    assert stream_floor(st, peak, 1024, L, 6, 3, 4) == \
        pytest.approx(total, rel=1e-12)
    # a steady block of the flagship emits 8232 * 2 and 17920 samples
    fl = _plan(96000.0)
    a = [stage_out_len(fl[0], 6 * 8232)]
    b = [stage_out_len(fl[0], 7 * 8232)]
    assert b[0] - a[0] == 2 * 8232
    assert stage_out_len(fl[1], b[0]) - stage_out_len(fl[1], a[0]) == 17920
