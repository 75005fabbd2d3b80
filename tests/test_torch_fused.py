"""The port's fused executor (r8brain_torch/ops/fused.py) against the
reference package's FusedUpExec and the float64 oracle.

The host-built operator must be bit-identical to the reference's; the
float64 path must be sample-exact against the oracle (stream-start
correction included); the float32 path -- on the CPU the kernel's plain
accuracy model -- must meet the -141 dB class on the flagship and agree
with the reference's own float32 engines.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.models.lengths import chain_in_for_out
from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.ops import pallas_frac as ref_pallas_frac
from r8brain_tpu.ops.fused import FusedUpExec as RefFusedUpExec
from r8brain_tpu.ops.stages import truncate_residual as ref_truncate_residual
from r8brain_torch.convert import plan_from_reference
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops.fused import FusedUpExec, can_fuse, fuse_stage_list
from r8brain_torch.ops.stages import truncate_residual

from .helpers import lcg_uniform, rms_db

# tests/test_fused.py CONFIGS
CONFIGS = [
    ("up_44k_96k", 44100, 96000, 180.15),
    ("up_44k_48k", 44100, 48000, 180.15),
    ("up_44k_64k", 44100, 64000, 160.0),
    ("preset_def", 44100, 96000, 206.91),
    ("small_step_4_3", 44100, 58800, 160.0),
    ("small_step_3_4", 44100, 117600, 160.0),
]
IDS = [c[0] for c in CONFIGS]
# float32 class against the oracle: the golden-equality class on the
# flagship, the reference's own CPU float32 class (tests/test_fused.py)
# elsewhere
F32_DB = {"up_44k_96k": -141.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def port_exec(label, dt):
    """The port's FusedUpExec of CONFIGS[label] (built once per module)."""
    _label, src, dst, atten = next(c for c in CONFIGS if c[0] == label)
    return FusedUpExec(make_plan(src, dst, 2.0, atten, 0), getattr(torch, dt))


@pytest.fixture(scope="module")
def oracles():
    return {c[0]: OracleResampler(c[1], c[2], 4096, 2.0, c[3], 0)
            for c in CONFIGS}


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_operator_bit_equal_to_reference(cfg, dt):
    label, src, dst, atten = cfg
    ref = RefFusedUpExec(ref_make_plan(src, dst, 2.0, atten, 0), jnp.dtype(dt))
    ex = port_exec(label, dt)
    assert (ex.p_in, ex.p_out, ex.D, ex.a0, ex.kx) == (
        ref.p_in, ref.p_out, ref.D, ref.a0, ref.kx)
    assert ex.skT.numpy().dtype == ref.skT.dtype
    assert np.array_equal(ex.skT.numpy(), ref.skT)
    assert ex.corr.numpy().dtype == ref.corr.dtype
    assert np.array_equal(ex.corr.numpy(), ref.corr)
    assert np.array_equal(ex.corr_js.numpy(), ref.corr_js)


def test_high_precision_operator_and_truncation_match_reference():
    plan = make_plan(44100, 96000, 2.0, 180.15, 0)
    ref = RefFusedUpExec(ref_make_plan(44100, 96000, 2.0, 180.15, 0), jnp.float32,
                         precision="high")
    ex = FusedUpExec(plan, torch.float32, precision="high")
    assert np.array_equal(ex.skT_lo.numpy(), ref.skT_lo)
    scale = float(np.abs(ref.skT).max())
    r0, rows = truncate_residual(ex.skT_lo.numpy(), scale)
    ref_r0, ref_rows = ref_truncate_residual(ref.skT_lo, scale)
    assert r0 == ref_r0 == ref.lo_r0
    assert np.array_equal(rows, ref_rows) and np.array_equal(rows,
                                                             ref.skT_lo_t)
    # float64 has no residual dot (precision falls back to "fast")
    assert FusedUpExec(plan, torch.float64, precision="high").skT_lo is None


def _padded_input(orc, x, dst, src):
    n = x.shape[-1]
    out_len = int(np.floor(n * dst / src))
    T = max(n, chain_in_for_out(orc.plan.stages, out_len))
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, T - n)]), out_len


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_exact_vs_oracle(cfg, oracles):
    label, src, dst, atten = cfg
    orc = oracles[label]
    n = 16000
    x = lcg_uniform(33, n)
    xp, out_len = _padded_input(orc, x, dst, src)
    ref = orc.oneshot(x, out_len)
    assert can_fuse(make_plan(src, dst, 2.0, atten, 0))
    for dt, tol in (("float64", -250.0),
                    ("float32", F32_DB.get(label, -125.0))):
        y = port_exec(label, dt)(torch.from_numpy(xp[None]))
        assert y.dtype == getattr(torch, dt)
        d = rms_db(y[0, :out_len].double().numpy() - ref)
        assert d < tol, f"{label} {dt}: {d:.1f} dB"


def test_high_precision_vs_oracle(oracles):
    orc = oracles["up_44k_96k"]
    n = 16000
    x = lcg_uniform(7, n)
    xp, out_len = _padded_input(orc, x, 96000, 44100)
    ref = orc.oneshot(x, out_len)
    ex = FusedUpExec(make_plan(44100, 96000, 2.0, 180.15, 0), torch.float32,
                     precision="high")
    y = ex(torch.tensor(xp[None], dtype=torch.float32))[0, :out_len]
    assert rms_db(y.double().numpy() - ref) < -141.0


def _batch(orc, seed):
    n = 16000
    x = np.stack([lcg_uniform(seed + i, n) for i in range(8)])
    return _padded_input(orc, x, orc.plan.dst_rate, orc.plan.src_rate)


def test_f32_vs_reference_matmul_engine(oracles):
    orc = oracles["up_44k_96k"]
    xp, out_len = _batch(orc, 40)
    x32 = xp.astype(np.float32)
    ref = np.asarray(RefFusedUpExec(orc.plan, jnp.float32).apply(
        jnp.asarray(x32)), np.float64)[:, :out_len]
    ex = FusedUpExec(plan_from_reference(orc.plan), torch.float32)
    y = ex(torch.from_numpy(x32))[:, :out_len].double().numpy()
    assert y.shape == ref.shape == (8, out_len)
    assert rms_db(y - ref) < -125.0


@pytest.fixture()
def _interpret_pallas(monkeypatch):
    """The reference's Pallas kernel in interpreter mode (the fixture of
    tests/test_pallas.py)."""
    orig = ref_pallas_frac.frac_whole_pallas

    def patched(xp, skT, Q, I, D, O, CT=128, interpret=False, skT_lo=None):
        return orig(xp, skT, Q, I, D, O, CT=CT, interpret=True,
                    skT_lo=skT_lo)

    monkeypatch.setattr(ref_pallas_frac, "frac_whole_pallas", patched)


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_f32_vs_reference_pallas_engine(oracles, _interpret_pallas,
                                        precision):
    orc = oracles["up_44k_96k"]
    xp, out_len = _batch(orc, 50)
    x32 = xp.astype(np.float32)
    ref = np.asarray(RefFusedUpExec(orc.plan, jnp.float32,
                                    precision=precision,
                                    engine="pallas").apply(
        jnp.asarray(x32)), np.float64)[:, :out_len]
    ex = FusedUpExec(plan_from_reference(orc.plan), torch.float32,
                     precision=precision)
    y = ex(torch.from_numpy(x32))[:, :out_len].double().numpy()
    assert rms_db(y - ref) < -120.0


def test_short_input_and_empty_output():
    ex = FusedUpExec(make_plan(44100, 96000, 2.0, 180.15, 0), torch.float64)
    assert ex(torch.zeros(2, 0)).shape == (2, 0)
    # shorter than the stream-start correction window and than one window
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 40)))
    y = ex(x)
    assert y.shape == (2, ex.out_len(40)) and torch.isfinite(y).all()


def test_fuse_stage_list_rejects_unported_stages():
    """Every stage kind has an executor now: the list of the reference's
    fuse_stage_list (the [conv, whole-frac] pair fused, a run of half-band
    upsamplers one cascade, the rest per stage), or None when nothing
    fuses."""
    fused = fuse_stage_list(make_plan(44100, 96000, 2.0, 180.15, 0),
                            torch.float32, "fast")
    assert len(fused) == 1 and isinstance(fused[0], FusedUpExec)
    # a lone conv stage fuses with nothing: the caller builds the stages
    assert fuse_stage_list(make_plan(44100, 22050, 2.0, 180.15, 0),
                           torch.float32, "fast") is None
    # [conv, frac, conv, hb_up]: the pair fuses, the rest per stage
    names = [type(e).__name__ for e in fuse_stage_list(
        make_plan(44100, 192000, 2.0, 180.15, 0), torch.float32, "fast")]
    assert names == ["FusedUpExec", "ConvExec", "HBUpExec"]
    # [conv, poly, conv]: nothing fuses
    assert fuse_stage_list(make_plan(44100, 96001, 2.0, 180.15, 0),
                           torch.float32, "fast") is None
    with pytest.raises(ValueError):
        FusedUpExec(make_plan(44100, 22050, 2.0, 180.15, 0))


# fused=True: (label, Resampler keywords, bound of the port against the
# reference package's fused=True chain in dB re full scale, bound against
# the port's float64 path).  The reference's float32 chains on XLA:CPU sit
# at about -135 dB from the oracle (ROADMAP.md section 3), so the port is
# held to them at -125 and to its own float64 path at the class
FUSED_TRUE = [("fast", {}, -125.0, -141.0),
              ("high", dict(precision="high"), -125.0, -141.0),
              ("float64", dict(dtype="float64"), -250.0, -250.0),
              ("pallas", dict(conv_engine="pallas"), -125.0, -141.0),
              ("ozaki_carry", dict(precision="high", conv_engine="ozaki",
                                   frac_engine="ozaki"), -125.0, -141.0),
              ("ozaki_no_carry", dict(precision="high", conv_engine="ozaki",
                                      frac_engine="ozaki"), -125.0, -141.0)]


@pytest.mark.parametrize("dst", [96000, 192000])
@pytest.mark.parametrize("case", FUSED_TRUE, ids=[c[0] for c in FUSED_TRUE])
def test_fused_true_vs_reference(case, dst, monkeypatch):
    """Resampler(fused=True) fuses the [conv, whole-frac] pair whatever
    the engines and builds the other stages with them (44.1k -> 192k:
    [FusedUpExec, ConvExec, HBUpExec], the reference's list; the cascade
    gated on a matmul engine), the df32 carry collapsing before the fused
    executor; its output against the reference's fused=True chain and
    the port's float64 path."""
    from r8brain_tpu.models.resampler import Resampler as RefResampler
    from r8brain_torch import Resampler

    label, kw, ref_db, f64_db = case
    monkeypatch.setenv("R8BT_DF_CARRY", "0" if label == "ozaki_no_carry"
                       else "1")
    kw = dict(kw)
    dt = kw.pop("dtype", "float32")
    rs = Resampler(44100, dst, 2.0, 180.15, fused=True,
                   dtype=getattr(torch, dt), device="cpu", **kw)
    ref = RefResampler(44100, dst, 2.0, 180.15, fused=True,
                       dtype=getattr(jnp, dt), **kw)
    names = [type(e).__name__ for e in rs.execs]
    assert names == [type(e).__name__ for e in ref.execs]
    assert names[0] == "FusedUpExec"
    assert rs.df_carry == (label == "ozaki_carry")
    for e in rs.execs[1:]:
        assert e.engine == {"pallas": "pallas", "ozaki_carry": "ozaki",
                            "ozaki_no_carry": "ozaki"}.get(
            label, "toeplitz" if dt == "float32" else "fft"
        ) if type(e).__name__ == "ConvExec" else True
    x = np.stack([lcg_uniform(31 + c, 6000) for c in range(2)])
    y = rs.oneshot(x.astype(np.float32 if dt == "float32" else np.float64))
    y = y.double().numpy()
    y_ref = np.asarray(ref.oneshot(x.astype(np.float32 if dt == "float32"
                                            else np.float64)), np.float64)
    y64 = Resampler(44100, dst, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x).numpy()
    assert rms_db(y - y_ref) < ref_db, label
    assert rms_db(y - y64) < f64_db, label


def test_fused_true_streams():
    """A StreamResampler over a fused=True guarantee chain (44.1k ->
    192k: the fused pair collapses the carry, the ozaki stages after it
    carry it) streams the oneshot's conversion."""
    from r8brain_torch import Resampler, StreamResampler

    rs = Resampler(44100, 192000, 2.0, 180.15, fused=True,
                   precision="high", conv_engine="ozaki",
                   frac_engine="ozaki", device="cpu")
    assert rs.df_carry
    n = 9000
    x = np.stack([lcg_uniform(41 + c, n) for c in range(2)]).astype(
        np.float32)
    out_len = rs.default_out_len(n)
    st = StreamResampler(rs, 2048)
    y = torch.cat([st.process(x[:, i : i + 1500]) for i in range(0, n, 1500)]
                  + [st.flush(out_len)], dim=1).double().numpy()
    y1 = rs.oneshot(x, out_len).double().numpy()
    assert y.shape == y1.shape
    assert rms_db(y - y1) - rms_db(y1) < -140.0
