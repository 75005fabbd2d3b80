"""The control and the faults come out as not correct.

The control is the reference computed with TF32 operands in the
program's place (``harness/check.py::control_readings``); the faults are
planted under the timed path of a whole run (the harness's look for a
chip skipped, the program on its CPU path at a tiny size): half of the
batch left out, an answer altered where it is produced, a stale answer,
and a stream step that leaves its state unchanged.  No cell spans chips,
so there is no exchange to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness.check import NUMBERS, control_readings
from benchmark.harness.loop import make_pool
from benchmark.harness.spec import Bench
from benchmark.tests.support import CELLS, ROOT, run_cpu

SEEDS = (5, 2147483659, 90000000001)


@pytest.mark.parametrize("config", ["cd24_44k1_96k", "cd24_44k1_96001"])
@pytest.mark.parametrize("kind", ["oneshot", "stream"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(config, kind, seed):
    bench = Bench(ROOT)
    cfg, loop = bench.config(config), bench.loop(kind)
    n = 4410 if kind == "oneshot" else 1024
    pool = make_pool(seed, (2, 8, n), torch.device("cpu"))
    got = control_readings(cfg, loop, pool, [0, 3, 4], "cpu")
    limits = cfg["limits"][loop.LIMITS]
    assert any(got[k] > 3 * limits[k] for k in NUMBERS), got


def _oneshot_fault(fault):
    from r8brain_torch.models.resampler import Resampler

    orig = Resampler.oneshot
    last = {}  # the latest answer to each input, oldest first

    def broken(self, x, *a, **kw):
        y = orig(self, x, *a, **kw)
        if fault == "half_batch_left_out":
            y = y.clone()
            y[y.shape[0] // 2 :] = 0
        elif fault == "answer_altered":
            y = y.clone()
            y[0, y.shape[1] // 2] += 1e-4
        elif fault == "stale_answer":  # the answer to another batch
            fresh, key = y, x.data_ptr()
            y = next((v for k, v in reversed(last.items()) if k != key),
                     fresh)
            last.pop(key, None)
            last[key] = fresh
        return y

    return Resampler, "oneshot", broken


def _stream_fault(fault):
    from r8brain_torch.models import stream

    if fault == "state_unchanged":
        orig = stream._PeriodStream.process_blocks

        def frozen(self, xk, k, xk_lo=None):
            if self.hist is None:
                return orig(self, xk, k, xk_lo)
            hist, n_in = self.hist, self.n_in
            out = orig(self, xk, k, xk_lo)
            self.hist, self.n_in = hist, n_in
            return out

        return stream._PeriodStream, "process_blocks", frozen
    orig = stream.StreamResampler.process_block_device

    def broken(self, x):
        y = orig(self, x).clone()
        if fault == "half_batch_left_out":
            y[y.shape[0] // 2 :] = 0
        elif y.shape[1]:  # the stream's first blocks may emit nothing
            y[0, y.shape[1] // 2] += 1e-4
        return y

    return stream.StreamResampler, "process_block_device", broken


FAULTS = [(c, f) for c in CELLS if c.endswith("batch")
          for f in ("half_batch_left_out", "answer_altered", "stale_answer")]
FAULTS += [(c, f) for c in CELLS if c.endswith("stream")
           for f in ("half_batch_left_out", "answer_altered",
                     "state_unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    make = _stream_fault if cell.endswith("stream") else _oneshot_fault
    cls, name, broken = make(fault)
    monkeypatch.setattr(cls, name, broken)
    out = run_cpu(cell)
    assert out["correct"] is False and out["failed"] > 0
    assert any(v["value"] > v["limit"] for v in out["check"].values())
