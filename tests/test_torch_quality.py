"""Quality sweeps of tests/test_quality.py through the port.

Every case of the reference's file on the port's float64
``OracleResampler``: round-trip zeroing at 20 ratios k/20
(bench/zerotest.cpp, band-limited to 90 % of Nyquist), SNR against the
requested attenuation at 8 attens (bench/snrtest.cpp), the latency query
against one-sample streaming emission (zerotest.cpp:115-128) at 4
configurations, and masstest's random ratios and chunk sizes against the
closed-form emission count (``r8brain_torch.models.lengths``).  Then
``tools/torch_zerotest.py --impl f32 --device cpu --random 2`` as a smoke
test, and the zeroing round trip at 4 ratios through both packages'
float32 chains on the CPU: the port's band-limited dB no more than 1 dB
above the JAX chain's (the convention of tests/test_torch_stage_chain.py).
"""

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.models.lengths import chain_out_len
from r8brain_torch.models.oracle import OracleResampler

from .helpers import band_limited_rms_db, lcg_uniform

RATIOS = [21, 25, 30, 33, 40, 41, 47, 55, 60, 64, 80, 100, 120, 160, 200,
          240, 320, 400, 512, 640]  # k/20, spanning the reference's sweep
#: the ratios of the float32 comparison with the JAX chain: a fused pair,
#: a half-band cascade, a polynomial plan and a long rational chain
F32_RATIOS = [41, 80, 321, 640]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle_round_trip(k, atten, n, tb=2.0):
    src = 44100.0
    dst = src * k / 20.0
    up = OracleResampler(src, dst, 2048, tb, atten, 0)
    dn = OracleResampler(dst, src, 2048, tb, atten, 0)
    return up, dn, dst


@pytest.mark.parametrize("k", RATIOS)
def test_round_trip_zeroing(k):
    atten, n = 160.0, 12000
    x = lcg_uniform(k, n)
    up, dn, dst = _oracle_round_trip(k, atten, n)
    mid = up.oneshot(x, int(np.floor(n * dst / 44100.0)))
    y = dn.oneshot(mid, n)
    d = band_limited_rms_db(y, x)
    assert d < -(atten - 20.0), f"k={k}: {d:.1f} dB"


@pytest.mark.parametrize("atten", [49.0, 73.0, 97.0, 121.0, 145.0, 169.0,
                                   193.0, 218.0])
def test_snr_tracks_atten(atten):
    k, n = 37, 9000
    x = lcg_uniform(int(atten), n)
    up, dn, dst = _oracle_round_trip(k, atten, n)
    mid = up.oneshot(x, int(np.floor(n * dst / 44100.0)))
    y = dn.oneshot(mid, n)
    d = band_limited_rms_db(y, x)
    assert d < -(atten - 15.0), f"atten={atten}: {d:.1f} dB"


@pytest.mark.parametrize("cfg", [(44100, 96000), (96000, 44100),
                                 (44100, 48000), (44100, 96001)])
def test_latency_query_consistency(cfg):
    """get_input_required_for_output(n) is the exact minimal input count:
    one sample fewer yields < n outputs, that count >= n
    (CDSPResampler.h:443-464)."""
    src, dst = cfg
    rs = OracleResampler(src, dst, 64, 2.0, 140.0, 0)
    x = lcg_uniform(1, 20000)
    for n_out in (1, 7, 100, 1000):
        need = rs.get_input_required_for_output(n_out)
        rs.clear()
        got = 0
        for i in range(0, need, 64):
            got += rs.process(x[i : min(i + 64, need)]).shape[0]
        assert got >= n_out, (cfg, n_out, need, got)
        rs.clear()
        got = 0
        for i in range(0, need - 1, 64):
            got += rs.process(x[i : min(i + 64, need - 1)]).shape[0]
        assert got < n_out, (cfg, n_out, need, got)


def test_zerotest_random_mode_smoke():
    """tools/torch_zerotest.py --random through the port's float32 chain
    on the CPU: the mode's plumbing and threshold."""
    from tools.torch_zerotest import last, main

    assert main(["--impl", "f32", "--device", "cpu", "--random", "2",
                 "--atten", "160", "--n", "4000"]) == 0
    assert last["ratios"] == 2 and last["fails"] == 0
    assert last["worst"] < -135.0


def test_mass_randomized_ratios():
    """masstest.cpp's random non-integer ratios and chunk sizes through
    the oracle's stream: totals equal the closed-form emission count and
    the output is finite."""
    rng = np.random.default_rng(42)
    for trial in range(12):
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
        assert total == chain_out_len(rs.plan.stages, n)


@pytest.mark.parametrize("k", F32_RATIOS)
def test_f32_zeroing_vs_jax_chain(k):
    """The zeroing round trip through the port's float32 chain on the CPU
    and through the reference's, on the same input: the port's
    band-limited dB is within the reference's class (under -(atten - 25),
    zerotest.py's threshold) and no more than 1 dB above the JAX chain's."""
    import jax.numpy as jnp

    from r8brain_tpu.models.resampler import Resampler as RefResampler

    src, atten, n, tb = 44100.0, 160.0, 6000, 2.0
    dst = src * k / 20.0
    mid_len = int(np.floor(n * dst / src))
    x = lcg_uniform(k, n)
    x32 = x.astype(np.float32)[None]
    up = Resampler(src, dst, tb, atten, 0, device="cpu")
    dn = Resampler(dst, src, tb, atten, 0, device="cpu")
    y = dn.oneshot(up.oneshot(x32, mid_len), n)[0].double().numpy()
    rup = RefResampler(src, dst, tb, atten, 0, dtype=jnp.float32)
    rdn = RefResampler(dst, src, tb, atten, 0, dtype=jnp.float32)
    rmid = np.asarray(rup.oneshot(x32, mid_len), np.float32)
    yr = np.asarray(rdn.oneshot(rmid, n), np.float64)[0]
    d, dr = band_limited_rms_db(y, x), band_limited_rms_db(yr, x)
    assert d < -(atten - 25.0), f"k={k}: port {d:.2f} dB"
    assert d <= dr + 1.0, f"k={k}: port {d:.2f} dB, JAX chain {dr:.2f} dB"
