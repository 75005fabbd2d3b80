"""The port's Resampler front-end (r8brain_torch/models/resampler.py)
against the reference package's Resampler, the float64 oracle and the
C++ goldens, on the CPU (``device="cpu"``: the plain PyTorch path, with
the float32 contraction in the kernel's accuracy model)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import r8brain_torch
from r8brain_tpu.models import lengths as ref_lengths
from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.models.resampler import (Resampler16 as RefResampler16,
                                          Resampler16IR as RefResampler16IR,
                                          Resampler24 as RefResampler24)
from r8brain_torch import (Resampler, Resampler16, Resampler16IR, Resampler24,
                           plan_from_reference)
from r8brain_torch.models import lengths
from r8brain_torch.models.plan import make_plan

from .helpers import lcg_uniform, load_golden, load_manifest, rms_db

FLAG = (44100, 96000, 2.0, 180.15)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def flagship():
    return Resampler(*FLAG, **CPU)


@pytest.fixture(scope="module")
def flagship_ref():
    return RefResampler(*FLAG, dtype=jnp.float32)


def test_flagship_vs_reference_and_oracle(flagship, flagship_ref):
    n = 16000
    x = np.stack([lcg_uniform(10 + i, n) for i in range(4)])
    y = flagship.oneshot(x.astype(np.float32))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert y.device.type == "cpu"
    out_len = flagship.default_out_len(n)
    assert y.shape == (4, out_len)
    y = y.double().numpy()
    ref = np.asarray(flagship_ref.oneshot(x.astype(np.float32)), np.float64)
    assert rms_db(y - ref) < -125.0
    orc = OracleResampler(44100, 96000, 4096, 2.0, 180.15, 0)
    for c in range(2):
        assert rms_db(y[c] - orc.oneshot(x[c], out_len)) < -141.0


GOLDENS = load_manifest()
# the oracle's class per golden (tests/test_goldens.py): float64 must sit in
# it; float32 must hold the -141 dB golden-equality class
F64_DB = {"exact": -250.0, "minphase": -145.0, "pow2down": -190.0,
          "poly": -220.0}


@pytest.mark.parametrize("cfg", GOLDENS, ids=[c["label"] for c in GOLDENS])
def test_goldens(cfg):
    """Every C++ golden: the default float64 resampler in the oracle's
    class, float32 within -141 dB and no more than 1 dB above the
    reference package's float32 chain on the same input."""
    x = lcg_uniform(cfg["seed"], cfg["inlen"])
    lf_ref, _q, ref = load_golden(cfg["file"])
    args = (cfg["src"], cfg["dst"], cfg["tb"], cfg["atten"], cfg["phase"])
    rs64 = Resampler(*args, dtype=torch.float64, **CPU)
    y64 = rs64.oneshot(x, cfg["outlen"]).numpy()
    assert rms_db(y64 - ref) < F64_DB[cfg["tol_class"]], cfg["label"]
    y32 = Resampler(*args, **CPU).oneshot(x, cfg["outlen"]).double().numpy()
    db = rms_db(y32 - ref)
    assert db < -141.0, cfg["label"]
    y_jax = np.asarray(RefResampler(*args, dtype=jnp.float32).oneshot(
        x.astype(np.float32), cfg["outlen"]), np.float64)
    assert db < rms_db(y_jax - ref) + 1.0, cfg["label"]
    lf_tol = 1e-6 if cfg["tol_class"] == "minphase" else 1e-12
    assert abs(rs64.latency_frac - lf_ref) < lf_tol


PRESETS = [(Resampler16, RefResampler16, 136.45),
           (Resampler16IR, RefResampler16IR, 109.56),
           (Resampler24, RefResampler24, 180.15)]


@pytest.mark.parametrize("cls,ref_cls,atten", PRESETS,
                         ids=["r16", "r16ir", "r24"])
def test_presets(cls, ref_cls, atten):
    rs = cls(44100, 48000, **CPU)
    ref = ref_cls(44100, 48000)
    assert rs.plan.atten == ref.plan.atten == atten
    assert rs.plan.describe() == ref.plan.describe()
    x = lcg_uniform(21, 6000)[None].astype(np.float32)
    y = rs.oneshot(x).double().numpy()
    y_ref = np.asarray(ref.oneshot(x), np.float64)
    assert y.shape == y_ref.shape
    assert rms_db(y - y_ref) < -125.0


QUERY_NS = list(range(0, 60)) + [257, 1000, 4097, 44100]


@pytest.mark.parametrize("rates", [(44100, 96000), (96000, 44100),
                                   (44100, 48000)],
                         ids=["up", "down", "cd_dat"])
def test_length_queries_match_reference(rates):
    src, dst = rates
    rs = Resampler(src, dst, 2.0, 180.15, **CPU)
    ref = RefResampler(src, dst, 2.0, 180.15, dtype=jnp.float32)
    assert rs.latency == ref.latency == 0
    assert rs.latency_frac == ref.latency_frac
    for n in QUERY_NS:
        assert rs.out_len_for_in(n) == ref.out_len_for_in(n), n
        assert rs.default_out_len(n) == ref.default_out_len(n), n
        assert rs.max_out_len(n) == ref.max_out_len(n), n
        assert (rs.get_input_required_for_output(n)
                == ref.get_input_required_for_output(n)), n
        assert (rs.get_in_len_before_out_pos(n)
                == ref.get_in_len_before_out_pos(n)), n
        if n > 0:
            assert rs.in_len_for_out(n) == ref.in_len_for_out(n), n


@pytest.mark.parametrize("rates", [(44100, 96001), (96000, 44100.5),
                                   (44100, 352800), (384000, 44100)],
                         ids=["poly", "irrational", "hb_up", "hb_down"])
def test_length_algebra_matches_reference(rates):
    """The length algebra of plans whose executors are later slices."""
    src, dst = rates
    stages = make_plan(src, dst, 2.0, 180.15, 0).stages
    ref_stages = ref_make_plan(src, dst, 2.0, 180.15, 0).stages
    for n in QUERY_NS:
        assert (lengths.chain_out_len(stages, n)
                == ref_lengths.chain_out_len(ref_stages, n)), n
        assert (lengths.chain_max_out_len(stages, n)
                == ref_lengths.chain_max_out_len(ref_stages, n)), n
        if n > 0:
            assert (lengths.chain_in_for_out(stages, n)
                    == ref_lengths.chain_in_for_out(ref_stages, n)), n


def test_plan_from_reference_gives_identical_output(flagship, flagship_ref):
    converted = plan_from_reference(flagship_ref.plan)
    assert isinstance(converted, r8brain_torch.Plan)
    assert converted.describe() == flagship.plan.describe()
    # a copy, not a view of the reference's arrays
    k_ref = flagship_ref.plan.stages[0].filt.kernel
    k = converted.stages[0].filt.kernel
    assert np.array_equal(k, k_ref) and not np.shares_memory(k, k_ref)
    rs = Resampler(*FLAG, plan=converted, **CPU)
    x = lcg_uniform(5, 9000)[None]
    for dt in (torch.float32, torch.float64):
        a = Resampler(*FLAG, dtype=dt, plan=converted, **CPU).oneshot(x)
        b = Resampler(*FLAG, dtype=dt, **CPU).oneshot(x)
        assert torch.equal(a, b)
    assert torch.equal(rs.oneshot(x), flagship.oneshot(x))
    # every stage kind converts, including half-band and poly stages
    for src, dst in ((44100, 176400), (44100, 96001), (176400, 44100)):
        ref_plan = ref_make_plan(src, dst, 2.0, 180.15, 0)
        assert (plan_from_reference(ref_plan).describe()
                == make_plan(src, dst, 2.0, 180.15, 0).describe())
    with pytest.raises(TypeError, match="plan_from_reference"):
        Resampler(*FLAG, plan=flagship_ref.plan, **CPU)


# plans with a half-band or polynomial stage, and what the default
# resampler builds for them (the reference's executors, fused alike)
STAGE_KINDS = [
    (44100, 192000, ["FusedUpExec", "ConvExec", "HBUpExec"]),
    (192000, 44100, ["HBDownExec", "FusedUpExec"]),
    (44100, 176400, ["ConvExec", "HBUpExec"]),
    (44100, 96001, ["ConvExec", "FracPolyExec", "ConvExec"]),
    (44100, 2822400, ["ConvExec", "HBUpCascadeExec"])]


@pytest.mark.parametrize("src,dst,want", STAGE_KINDS,
                         ids=[f"{a}-{b}" for a, b, _w in STAGE_KINDS])
def test_unfusable_plan_raises(src, dst, want):
    """Plans with a half-band or polynomial stage (44.1k -> 192k is
    [conv, frac, conv, hb_up], 192k -> 44.1k [hb_down, conv, frac]) build
    the reference's executors: each [conv, whole-frac] pair fused, each
    run of half-band upsamplers one cascade, the other stages their own
    (float64: stage by stage, no cascade)."""
    rs = Resampler(src, dst, 2.0, 180.15, **CPU)
    assert [type(e).__name__ for e in rs.execs] == want
    ref = RefResampler(src, dst, 2.0, 180.15, dtype=jnp.float32)
    assert want == [type(e).__name__ for e in ref.execs]
    rs64 = Resampler(src, dst, 2.0, 180.15, dtype=torch.float64, **CPU)
    assert not any(type(e).__name__ == "HBUpCascadeExec"
                   for e in rs64.execs)


LONE_CONV = [(48000, 96000), (96000, 48000), (16000, 48000), (44100, 88200),
             (44100, 22050)]


@pytest.mark.parametrize("src,dst", LONE_CONV,
                         ids=[f"{a}-{b}" for a, b in LONE_CONV])
def test_lone_conv_plan_runs_by_default(src, dst):
    """A plan that is one conv stage runs under the default fused="auto"
    (the reference's rule: a stage that does not fuse gets its own
    executor), bit-equal to fused=False; float32 within -141 dB of the
    oracle and no more than 1 dB above the reference package's chain
    (which sits near -136 dB on the CPU, ROADMAP.md section 3)."""
    rs = Resampler(src, dst, 2.0, 180.15, **CPU)
    assert [type(e).__name__ for e in rs.execs] == ["ConvExec"]
    assert rs.execs[0].engine == "toeplitz"
    n = src // 4  # 0.25 s: the 50 ms edge skip leaves 60 % of the output
    x = np.stack([lcg_uniform(31 + c, n) for c in range(2)]).astype(
        np.float32)
    out_len = int(np.floor(n * dst / src))
    y = rs.oneshot(x, out_len)
    y_unfused = Resampler(src, dst, 2.0, 180.15, fused=False,
                          **CPU).oneshot(x, out_len)
    assert torch.equal(y, y_unfused)
    y = y.double().numpy()
    orc = np.stack([OracleResampler(src, dst, 4096, 2.0, 180.15, 0).oneshot(
        x[c].astype(np.float64), out_len) for c in range(2)])
    y_ref = np.asarray(RefResampler(src, dst, 2.0, 180.15,
                                    dtype=jnp.float32).oneshot(x, out_len),
                       np.float64)
    s = slice(int(0.05 * dst), -int(0.05 * dst))
    db, ref_db = rms_db(y[:, s] - orc[:, s]), rms_db(y_ref[:, s] - orc[:, s])
    assert db < -141.0, db
    assert db < ref_db + 1.0, (db, ref_db)


def test_unported_options_raise(flagship):
    """fused="poly" is still unported; the stage engines, the half-band
    and polynomial plans and the chunked oneshot are not (fused=False and
    any engine build the stage chain; oneshot(max_chunk=...) over many
    chunks runs the stream)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Resampler(*FLAG, fused="poly", **CPU)
    for dst, kinds in ((176400, ["ConvExec", "HBUpExec"]),
                       (96001, ["ConvExec", "FracPolyExec", "ConvExec"])):
        rs = Resampler(44100, dst, 2.0, 180.15, fused=False, **CPU)
        assert [type(e).__name__ for e in rs.execs] == kinds
    for kw in (dict(fused=False), dict(conv_engine="toeplitz"),
               dict(frac_engine="pallas")):
        rs = Resampler(*FLAG, **kw, **CPU)
        assert [type(e).__name__ for e in rs.execs] == ["ConvExec",
                                                        "FracWholeExec"]
    x = lcg_uniform(5, 3000).astype(np.float32)[None]
    y = flagship.oneshot(x, max_chunk=1000)
    assert y.shape == (1, flagship.default_out_len(3000))
    assert rms_db(y.double().numpy()
                  - flagship.oneshot(x).double().numpy()) < -135.0
    with pytest.raises(ValueError):
        flagship.oneshot(x, max_chunk=0)
    # one chunk is the whole-array program
    assert torch.equal(flagship.oneshot(x, max_chunk=3000),
                       flagship.oneshot(x))


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Resampler(*FLAG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Resampler24(44100, 96000)


def test_oneshot_shapes_and_passthrough(flagship):
    x = lcg_uniform(8, 3000)
    y1 = flagship.oneshot(x)  # 1-D numpy in, 1-D tensor out
    assert y1.dim() == 1 and y1.shape[0] == flagship.default_out_len(3000)
    y2 = flagship.oneshot(torch.from_numpy(x)[None], out_len=100)
    assert y2.shape == (1, 100)
    assert torch.equal(y2[0], y1[:100])
    assert flagship.oneshot(x[:0]).shape == (0,)
    same = Resampler(48000, 48000, **CPU)
    assert len(same.execs) == 0
    y = same.oneshot(x[None], out_len=3005)
    assert y.shape == (1, 3005) and torch.equal(y[0, 3000:], torch.zeros(5))
    assert np.array_equal(y[0, :3000].numpy(), x.astype(np.float32))
    flagship.clear()
