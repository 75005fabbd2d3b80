"""The port's FusedPolyExec (r8brain_torch/ops/poly_fused.py, the
composite [conv, poly-frac] operator) against the two-stage chain, the
reference package's FusedPolyExec and the float64 oracle: the tests of
tests/test_poly_fused.py on the port, plus the reference's executor on
the same input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.ops.poly_fused import FusedPolyExec as RefFusedPolyExec
from r8brain_torch import Resampler
from r8brain_torch.convert import plan_from_reference
from r8brain_torch.models.plan import ConvStage, FracStage
from r8brain_torch.ops.poly_fused import FusedPolyExec
from r8brain_torch.ops.stages import build_exec

from .helpers import lcg_uniform, rms_db

RATIOS = [
    ("poly_96001", 44100, 96001),
    ("poly_sqrt2", 44100, 44100 * np.sqrt(2.0)),
    ("poly_slight", 44100, 44100 * 1.0001),
    ("poly_192k1", 44100, 192001),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _first_pair(plan):
    s = plan.stages
    for i in range(len(s) - 1):
        if (isinstance(s[i], ConvStage) and s[i].down == 1
                and isinstance(s[i + 1], FracStage)
                and not s[i + 1].is_whole):
            return i
    return None


def _pairs(src, dst, atten):
    """(the port's pair, the reference's pair) of one plan, the port's
    carried across from the reference's."""
    rplan = ref_make_plan(src, dst, 2.0, atten, 0)
    i = _first_pair(plan_from_reference(rplan))
    if i is None:
        return None
    plan = plan_from_reference(rplan)
    return plan.stages[i : i + 2], rplan.stages[i : i + 2]


@pytest.mark.parametrize("label,src,dst", RATIOS, ids=[r[0] for r in RATIOS])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, -230.0),
                                       (torch.float32, -110.0)],
                         ids=["f64", "f32"])
def test_fused_poly_matches_two_stage(label, src, dst, dtype, tol):
    pairs = _pairs(src, dst, 170.0)
    assert pairs is not None, label
    (conv, frac), _ = pairs
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 9000))).to(dtype)
    y2 = build_exec(frac, dtype)(build_exec(conv, dtype)(x)).double()
    yf = FusedPolyExec(conv, frac, dtype)(x).double()
    assert yf.shape == y2.shape
    d = rms_db((yf - y2).numpy())
    assert d < tol, f"{label}: {d:.1f} dB"


@pytest.mark.parametrize("label,src,dst", RATIOS, ids=[r[0] for r in RATIOS])
@pytest.mark.parametrize("precision", ["fast", "high"])
def test_fused_poly_vs_reference_executor(label, src, dst, precision):
    """The port's executor and the reference's, from one plan, on the same
    input: the same geometry (S, G, W, E, the correction rows) and
    outputs within the reference's float32 class of each other (float64:
    -230 dB)."""
    (conv, frac), (rconv, rfrac) = _pairs(src, dst, 170.0)
    ex = FusedPolyExec(conv, frac, torch.float32, precision)
    ref = RefFusedPolyExec(rconv, rfrac, jnp.float32, precision)
    assert (ex.S, ex.G, ex.W, ex.E, ex.ngrp_max) == (ref.S, ref.G, ref.W,
                                                     ref.E, ref.ngrp_max)
    if ref.corr_js is None:
        assert ex.corr_js is None
    else:
        assert ex.corr_js.tolist() == ref.corr_js.tolist()
        np.testing.assert_allclose(ex.corr.numpy(), ref.corr, rtol=1e-6,
                                   atol=1e-12)
    x = np.random.default_rng(13).standard_normal((2, 5000))
    y = ex(torch.from_numpy(x).float()).double().numpy()
    y_ref = np.asarray(ref.apply(jnp.asarray(x, jnp.float32)), np.float64)
    assert y.shape == y_ref.shape
    assert rms_db(y - y_ref) < -110.0
    ex64 = FusedPolyExec(conv, frac, torch.float64)
    ref64 = RefFusedPolyExec(rconv, rfrac, jnp.float64)
    y64 = ex64(torch.from_numpy(x)).numpy()
    assert rms_db(y64 - np.asarray(ref64.apply(jnp.asarray(x)))) < -230.0


def test_fused_poly_high_residual():
    """precision="high" never hurts the composite's float32 operator error
    (the float64 executor as the yardstick)."""
    (conv, frac), _ = _pairs(44100, 96001, 180.15)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 9000)))
    y64 = FusedPolyExec(conv, frac, torch.float64)(x).numpy()
    d = {p: rms_db(FusedPolyExec(conv, frac, torch.float32, p)(
        x.float()).double().numpy() - y64) for p in ("fast", "high")}
    assert d["high"] < -120.0
    assert d["high"] <= d["fast"] + 1.0


def test_fused_poly_opt_in_wiring():
    """fused="poly" opts the float32 chain into FusedPolyExec; the default,
    float64 and a non-matmul engine keep the two-stage chain."""
    def names(**kw):
        return [type(e).__name__ for e in Resampler(
            44100, 96001, 2.0, 180.15, 0, device="cpu", **kw).execs]

    assert names(fused="poly") == ["FusedPolyExec", "ConvExec"]
    assert "FusedPolyExec" not in names()
    assert "FusedPolyExec" not in names(fused="poly", dtype=torch.float64)
    assert "FusedPolyExec" not in names(fused="poly", precision="high",
                                        conv_engine="ozaki",
                                        frac_engine="ozaki")


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_fused_poly_chain_vs_oracle(precision):
    """The fused float32 polynomial chain against the float64 oracle
    (oneshot semantics, flush included): in the golden-equality class
    (the reference's own form is held at -120 dB)."""
    src, dst = 44100, 96001
    orc = OracleResampler(src, dst, 4096, 2.0, 180.15, 0)
    n = 14000
    x = lcg_uniform(77, n) * 0.9
    out_len = int(np.floor(n * dst / src))
    ref = orc.oneshot(x, out_len)
    rs = Resampler(src, dst, 2.0, 180.15, 0, precision=precision,
                   fused="poly", device="cpu")
    assert isinstance(rs.execs[0], FusedPolyExec)
    y = rs.oneshot(x.astype(np.float32), out_len).double().numpy()
    d = rms_db(y - ref)
    assert d < -141.0, f"{precision}: {d:.1f} dB"


def test_fused_poly_state_cache():
    """The operators are built once per input length and kept for the last
    POLY_CACHE lengths; a cached call is bit-equal to a fresh one."""
    (conv, frac), _ = _pairs(44100, 96001, 180.15)
    ex = FusedPolyExec(conv, frac)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5000))).float()
    y1 = ex(x)
    assert len(ex._state) == 1
    assert torch.equal(ex(x), y1)
    for n in (4000, 4100, 4200, 4300):
        ex(x[:, :n])
    assert len(ex._state) == 4
    assert torch.equal(ex(x), y1)
