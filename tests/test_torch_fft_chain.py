"""The port's df32-FFT guarantee engines (``conv_engine`` "pallas_fft5",
"pallas_fft4", "pallas_fft" and "fft", r8brain_torch/ops/stages.py) for
every [conv, whole-frac] plan, against the reference package's ConvExec,
FracWholeExec and Resampler and the float64 oracle, on the CPU.

On the CPU the ``pallas_fft*`` engines run ``df_fft_conv_ref`` and the
``im2col`` interpolator runs ``frac_whole_ref``, the plain versions the
card's kernels are held to.  Bounds: the -141 dB class re full scale
against the oracle, and no more than 1 dB above the reference's own
``conv_engine="fft"`` chain on the same input; the port within -141 dB of
that chain; a conv stage within -135 dB (relative) of the reference's
float64 stage (tests/test_dfft5.py's bound).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.ops.stages import ConvExec as RefConvExec
from r8brain_tpu.ops.stages import FracWholeExec as RefFracWholeExec
from r8brain_torch import Resampler
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops.pallas_dfft import df_fft_conv
from r8brain_torch.ops.pallas_frac import frac_whole
from r8brain_torch.ops.stages import FFT_ENGINES, ConvExec, FracWholeExec

from .helpers import lcg_uniform, rms_db

RATES = [(44100, 96000), (96000, 44100), (44100, 48000), (48000, 44100),
         (32000, 44100), (44100, 32000)]
MATRIX = [(s, d, tb, a) for s, d in RATES for tb in (1.0, 2.0, 5.0)
          for a in (136.45, 180.15, 206.91)]
CHAINS = [(44100, 96000), (96000, 44100), (44100, 48000)]
HIGH = dict(precision="high", fused=False)
EDGE_S = 0.05


def _rel_db(y, ref):
    return rms_db(y - ref) - rms_db(ref)


def _cfg_id(cfg):
    return "{}-{}-tb{:g}-{}".format(*cfg)


@pytest.mark.parametrize("cfg", MATRIX, ids=_cfg_id)
def test_conv_exec_geometry_matches_reference(cfg):
    """Every FFT engine picks the reference's engine, nfft, hop, framed5,
    framed5_poly and transform size (a pallas_fft5 plan out of the
    four-step range is renamed pallas_fft4, as in the reference)."""
    src, dst, tb, atten = cfg
    conv = make_plan(src, dst, tb, atten, 0).stages[0]
    rconv = ref_make_plan(src, dst, tb, atten, 0).stages[0]
    for engine in FFT_ENGINES:
        ex = ConvExec(conv, torch.float32, "high", engine=engine)
        ref = RefConvExec(rconv, jnp.float32, precision="high", engine=engine)
        n = ex.dfft_plan.n
        assert (ex.engine, ex.nfft, ex.hop, ex.framed5, ex.framed5_poly, n) \
            == (ref.engine, ref.nfft, ref.hop, ref.framed5, ref.framed5_poly,
                ref.dfft_plan.n), engine


# (src, dst, trans_band, atten): one plan for each pallas_fft5 geometry --
# frames mode at 1024 and 2048, framed and polyphase at 4096, 8192 and
# 16384, and the renames to pallas_fft4 at 32768 and 65536
STAGES = [(96000, 44100, 10.0, 136.45), (96000, 44100, 5.0, 136.45),
          (44100, 96000, 2.0, 136.45), (96000, 44100, 5.0, 180.15),
          (44100, 96000, 1.0, 136.45), (96000, 44100, 2.0, 136.45),
          (44100, 96000, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
          (44100, 96000, 0.5, 136.45), (96000, 44100, 1.0, 136.45),
          (96000, 44100, 0.5, 136.45), (44100, 32000, 0.5, 206.91)]


@pytest.mark.parametrize("cfg", STAGES, ids=_cfg_id)
def test_conv_stage_vs_reference_f64(cfg):
    """The conv stage of each engine on a float32 signal against the
    reference's float64 ConvExec (its fft engine): every engine rounds the
    float64 convolution once, so it holds the float32 rounding of the
    output (-150 dB relative; the reference's own bound is -135 dB)."""
    src, dst, tb, atten = cfg
    conv = make_plan(src, dst, tb, atten, 0).stages[0]
    rconv = ref_make_plan(src, dst, tb, atten, 0).stages[0]
    x = np.random.default_rng(3).uniform(-1, 1, (2, 3000)).astype(np.float32)
    y64 = np.asarray(RefConvExec(rconv, jnp.float64).apply(
        jnp.asarray(x, jnp.float64)))
    engines = FFT_ENGINES if (src, dst, tb) in ((44100, 96000, 2.0),
                                                (96000, 44100, 2.0)) \
        else ("pallas_fft5",)
    for engine in engines:
        ex = ConvExec(conv, torch.float32, "high", engine=engine)
        y = ex.apply(torch.from_numpy(x)).double().numpy()
        assert y.shape == y64.shape
        assert _rel_db(y, y64) < -150.0, engine


@pytest.mark.parametrize("cfg", [(44100, 96000, 2.0, 180.15),
                                 (96000, 44100, 5.0, 136.45),
                                 (44100, 48000, 2.0, 206.91)], ids=_cfg_id)
def test_fft_engine_under_high_is_the_kernel(cfg, monkeypatch):
    """conv_engine="fft" under "high" runs df_fft_conv at nfft with head P:
    the reference's XLA df32 FFT computes the float64 convolution rounded
    to float32, so the stage equals pallas_fft's bit for bit and the
    reference's fft stage within 2^-23 of max |y|."""
    from r8brain_torch.ops import stages

    src, dst, tb, atten = cfg
    conv = make_plan(src, dst, tb, atten, 0).stages[0]
    rconv = ref_make_plan(src, dst, tb, atten, 0).stages[0]
    x = np.random.default_rng(8).uniform(-1, 1, (2, 3000)).astype(np.float32)
    calls = []
    real = stages.df_fft_conv
    monkeypatch.setattr(stages, "df_fft_conv",
                        lambda *a: calls.append(a[3]) or real(*a))
    ex = ConvExec(conv, torch.float32, "high", engine="fft")
    y = ex.apply(torch.from_numpy(x))
    assert calls == [ex.K - 1] and ex.hop == ex.nfft - (ex.K - 1)
    pf = ConvExec(conv, torch.float32, "high", engine="pallas_fft")
    assert torch.equal(y, pf.apply(torch.from_numpy(x)))
    ry = np.asarray(RefConvExec(rconv, jnp.float32, precision="high",
                                engine="fft").apply(jnp.asarray(x)),
                    np.float64)
    y = y.double().numpy()
    assert np.abs(y - ry).max() <= 2.0**-23 * np.abs(ry).max()


def test_conv_fast_and_f64_engines():
    """The fft engine without the df32 arithmetic: float32 rfft with the
    hi + lo spectrum, and float64 (the reference's CPU-parity engine,
    sample-exact)."""
    conv = make_plan(44100, 96000, 2.0, 180.15, 0).stages[0]
    rconv = ref_make_plan(44100, 96000, 2.0, 180.15, 0).stages[0]
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3000))
    y64 = np.asarray(RefConvExec(rconv, jnp.float64).apply(jnp.asarray(x)))
    ex = ConvExec(conv, torch.float64, "high", engine="auto")
    assert (ex.engine, ex.precision) == ("fft", "fast")
    assert rms_db(ex.apply(torch.from_numpy(x)).numpy() - y64) < -250.0
    x32 = x.astype(np.float32)
    fast = ConvExec(conv, torch.float32, "fast", engine="fft")
    y = fast.apply(torch.from_numpy(x32)).double().numpy()
    ry = np.asarray(RefConvExec(rconv, jnp.float32, engine="fft").apply(
        jnp.asarray(x32)), np.float64)
    assert _rel_db(y, ry) < -120.0 and _rel_db(y, y64) < -120.0
    with pytest.raises(ValueError, match="float32"):
        ConvExec(conv, torch.float64, engine="pallas_fft5")


def test_conv_apply_v_reads_the_valid_prefix():
    """apply_v on a raw buffer with surplus columns equals apply on the
    prefix, for the FFT engines as for the ozaki one."""
    conv = make_plan(44100, 48000, 2.0, 180.15, 0).stages[0]
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (2, 3000)).astype(np.float32))
    for engine in FFT_ENGINES:
        ex = ConvExec(conv, torch.float32, "high", engine=engine)
        y, m = ex.apply_v(x, 2900)
        assert m == ex.out_len(2900) and torch.equal(y[:, :m],
                                                     ex.apply(x[:, :2900]))


def test_frac_im2col_vs_reference():
    """The im2col interpolator (frac_whole with the float32 operator
    residual) against the reference's im2col engine and the float64
    stage: within the -141 dB class of both, and at least as close to the
    float64 stage as the reference (8-term two_sum folds)."""
    frac = make_plan(44100, 96000, 2.0, 180.15, 0).stages[1]
    rfrac = ref_make_plan(44100, 96000, 2.0, 180.15, 0).stages[1]
    ex = FracWholeExec(frac, torch.float32, "high", engine="auto")
    assert ex.engine == "im2col" and ex.skT_lo is not None
    x64 = np.random.default_rng(6).uniform(-1, 1, (2, 6000))
    x = x64.astype(np.float32)
    y = ex.apply(torch.from_numpy(x)).double().numpy()
    ry = np.asarray(RefFracWholeExec(rfrac, jnp.float32, precision="high",
                                     engine="im2col").apply(jnp.asarray(x)),
                    np.float64)
    e64 = FracWholeExec(frac, torch.float64, engine="auto")
    assert e64.engine == "conv" and e64.skT_lo is None
    y64 = e64.apply(torch.from_numpy(x.astype(np.float64))).numpy()
    assert rms_db(y - ry) < -141.0
    assert rms_db(y - y64) < min(-141.0, rms_db(ry - y64))


@functools.lru_cache(maxsize=None)
def _chain_case(src, dst):
    """Input (lcg_uniform(101 + c), 2 channels), the oracle, the
    reference's fft chain and the edge skip of one conversion."""
    n = 12000
    x = np.stack([lcg_uniform(101 + c, n) for c in range(2)]).astype(
        np.float32)
    out_len = int(np.floor(n * dst / src))
    orc = np.stack([OracleResampler(src, dst, 4096, 2.0, 180.15, 0).oneshot(
        x[c].astype(np.float64), out_len) for c in range(2)])
    ref = RefResampler(src, dst, 2.0, 180.15, 0, dtype="float32",
                       conv_engine="fft", **HIGH)
    y_ref = np.asarray(ref.oneshot(x, out_len), np.float64)
    return x, out_len, orc, y_ref, int(EDGE_S * dst)


@pytest.mark.parametrize("engine", FFT_ENGINES)
@pytest.mark.parametrize("rates", CHAINS, ids=[f"{s}-{d}" for s, d in CHAINS])
def test_chain_vs_oracle_and_reference(rates, engine):
    """The unfused guarantee chain [conv (engine), frac (im2col)] against
    the oracle (-141 dB re full scale, and within 1 dB of the reference's
    fft chain) and against that chain (-141 dB)."""
    x, out_len, orc, y_ref, skip = _chain_case(*rates)
    rs = Resampler(*rates, 2.0, 180.15, conv_engine=engine, device="cpu",
                   **HIGH)
    assert [(type(e), e.engine) for e in rs.execs][1] == (FracWholeExec,
                                                        "im2col")
    y = rs.oneshot(x, out_len)
    assert y.dtype == torch.float32 and y.shape == (2, out_len)
    y = y.double().numpy()
    s = slice(skip, -skip)
    db, ref_db = rms_db(y[:, s] - orc[:, s]), rms_db(y_ref[:, s] - orc[:, s])
    assert db < -141.0 and db < ref_db + 1.0, (db, ref_db)
    assert rms_db(y[:, s] - y_ref[:, s]) < -141.0


@pytest.mark.parametrize("rates", CHAINS, ids=[f"{s}-{d}" for s, d in CHAINS])
def test_f64_unfused_chain_is_sample_exact(rates):
    """fused=False in float64 (conv: the fft engine, frac: frac_whole in
    float64) against the oracle, as the fused float64 path is held."""
    x, out_len, orc, _y_ref, _skip = _chain_case(*rates)
    rs = Resampler(*rates, 2.0, 180.15, dtype=torch.float64, fused=False,
                   device="cpu")
    assert [e.engine for e in rs.execs] == ["fft", "conv"]
    y = rs.oneshot(x.astype(np.float64), out_len).numpy()
    assert rms_db(y - orc) < -250.0


def test_ozaki_conv_before_im2col_collapses_the_carry():
    """conv_engine="ozaki" with frac_engine="im2col": the carry's pair is
    collapsed at the seam (the reference's _df_collapse_input) and the
    chain matches the reference's same configuration."""
    x, out_len, orc, _y_ref, skip = _chain_case(44100, 96000)
    kw = dict(conv_engine="ozaki", frac_engine="im2col", **HIGH)
    rs = Resampler(44100, 96000, 2.0, 180.15, device="cpu", **kw)
    assert rs.df_carry
    y = rs.oneshot(x, out_len).double().numpy()
    ref = RefResampler(44100, 96000, 2.0, 180.15, 0, dtype="float32", **kw)
    y_ref = np.asarray(ref.oneshot(x, out_len), np.float64)
    s = slice(skip, -skip)
    assert rms_db(y[:, s] - y_ref[:, s]) < -141.0
    assert rms_db(y[:, s] - orc[:, s]) < -141.0


@pytest.mark.parametrize("engine", FFT_ENGINES)
def test_cpu_chain_launches_no_kernel(engine):
    rs = Resampler(44100, 96000, 2.0, 180.15, conv_engine=engine,
                   device="cpu", **HIGH)
    before = (df_fft_conv.launches, frac_whole.launches)
    rs.oneshot(lcg_uniform(3, 2000))
    assert (df_fft_conv.launches, frac_whole.launches) == before
