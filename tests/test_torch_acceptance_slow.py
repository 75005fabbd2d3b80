"""Slow acceptance tier of the port: the reference's full sweeps on the
port's executors, on the CPU.

The port's counterparts of tests/test_acceptance_slow.py and
tests/test_differential_slow.py, each kernel through its plain version:

  * the 400-trial differential fuzzer (tools/torch_fuzz.py: orc, f32, oz,
    stm, nat, and the card's executors high, fft and sym) at its bounds;
  * the 620-ratio zerotest on the oracle and on the float32 chain, and its
    random non-integer ratios on both;
  * the full SNR sweeps (oracle, f32);
  * masstest at 10x the tier-1 trials;
  * the fractional bank sweep.

Excluded from the default run (``-m "not slow"``); run with
``python -m pytest -m slow tests/test_torch_acceptance_slow.py``.
"""

import shutil

import numpy as np
import pytest
import torch

from .helpers import lcg_uniform

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_differential_fuzzer_400():
    from tools import torch_fuzz

    executors = [e for e in torch_fuzz.BASE + torch_fuzz.CARD
                 if e != "nat" or shutil.which("g++") is not None]
    summary, fails = torch_fuzz.sweep(400, 0, executors, "cpu",
                                      log=lambda s: None)
    assert not fails, fails[:5]
    assert summary["runs"]["orc"] == 400


def test_zerotest_full_620_oracle():
    from tools.torch_zerotest import main
    assert main(["--atten", "160", "--n", "12000", "--device", "cpu"]) == 0


def test_zerotest_f32_full_620():
    from tools.torch_zerotest import main
    assert main(["--impl", "f32", "--device", "cpu", "--atten", "160",
                 "--n", "12000"]) == 0


def test_zerotest_random_ratio_f32():
    from tools.torch_zerotest import main
    assert main(["--impl", "f32", "--device", "cpu", "--random", "150",
                 "--atten", "160", "--n", "9000"]) == 0


def test_zerotest_random_ratio_oracle():
    from tools.torch_zerotest import main
    assert main(["--random", "200", "--atten", "160", "--n", "9000",
                 "--device", "cpu"]) == 0


def test_snr_full_sweep_oracle():
    from tools.torch_snrtest import main
    assert main(["--step", "6", "--ratios", "8", "--n", "9000",
                 "--device", "cpu"]) == 0


def test_snr_f32_sweep():
    from tools.torch_snrtest import main
    assert main(["--impl", "f32", "--device", "cpu", "--step", "12",
                 "--ratios", "4", "--n", "9000"]) == 0


def test_mass_randomized_10x():
    """masstest at 10x the tier-1 trial count, oracle streaming."""
    from r8brain_torch.models.lengths import chain_out_len
    from r8brain_torch.models.oracle import OracleResampler

    rng = np.random.default_rng(1234)
    for trial in range(120):
        src = 44100.0
        dst = src * (1.0 + 44.0 * rng.random())
        if rng.random() < 0.5:
            src, dst = dst, src
        tb = 0.5 + 4.5 * rng.random()
        rs = OracleResampler(src, dst, 1024, tb, 140.0, 0)
        n = int(rng.integers(2000, 6000))
        x = lcg_uniform(trial, n)
        total = 0
        pos = 0
        while pos < n:
            c = int(rng.integers(1, 1200))
            y = rs.process(x[pos : pos + c])
            assert np.all(np.isfinite(y))
            total += y.shape[0]
            pos += c
        assert total == chain_out_len(rs.plan.stages, n), trial


def test_flt_bank_sweep():
    from tools.torch_flt_test import main
    assert main(["--device", "cpu"]) == 0
