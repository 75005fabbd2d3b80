"""The port's float64 host oracle (r8brain_torch.models.oracle) against the
compiled C++ reference's goldens and against the reference package's
oracle.

The port carries its own copy of the oracle, over its own plans, so it is
held to what the reference package's is held to (tests/test_goldens.py:
the same per-class bounds TOL_DB and latency tolerances), and to the
reference package's oracle itself: np.array_equal on six configurations
(the same plan, the same float64 operations in the same order), also
through a plan carried across by convert.plan_from_reference.
"""

import numpy as np
import pytest

from r8brain_tpu.models.oracle import OracleResampler as RefOracle
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_torch import OracleResampler, plan_from_reference

from .helpers import lcg_uniform, load_golden, load_manifest, rms_db
from .test_goldens import TOL_DB

MANIFEST = load_manifest()
BY_LABEL = {c["label"]: c for c in MANIFEST}
EQUAL_CFGS = ("up_44k_96k", "down_96k_44k", "poly_96001", "x4_up_hb",
              "x2_down", "minph_up")
EXACT = [c for c in MANIFEST if c["tol_class"] == "exact"][:6]


def _args(cfg):
    return (float(cfg["src"]), float(cfg["dst"]), cfg["maxinlen"],
            cfg["tb"], cfg["atten"], cfg["phase"])


@pytest.mark.parametrize("cfg", MANIFEST, ids=[c["label"] for c in MANIFEST])
def test_oracle_matches_reference_goldens(cfg):
    """Every golden within its class's bound (exact -250 dB, pow2down
    -190, poly -220, minphase -145 re full scale); latency_frac within
    1e-12 (1e-6 for the min-phase transform)."""
    x = lcg_uniform(cfg["seed"], cfg["inlen"])
    rs = OracleResampler(*_args(cfg))
    lf_ref, _q, ref = load_golden(cfg["file"])
    y = rs.oneshot(x, cfg["outlen"])
    assert rms_db(y - ref) < TOL_DB[cfg["tol_class"]], cfg["label"]
    lf_tol = 1e-6 if cfg["tol_class"] == "minphase" else 1e-12
    assert abs(rs.latency_frac - lf_ref) < lf_tol


@pytest.mark.parametrize("label", EQUAL_CFGS)
def test_oracle_equals_reference_oracle(label):
    """Bit-equal to the reference package's oracle: oneshot, a chunked
    process stream, and the latency queries."""
    cfg = BY_LABEL[label]
    x = lcg_uniform(cfg["seed"], cfg["inlen"])
    port, ref = OracleResampler(*_args(cfg)), RefOracle(*_args(cfg))
    assert np.array_equal(port.oneshot(x, cfg["outlen"]),
                          ref.oneshot(x, cfg["outlen"]))
    for a, b in ((0, 333), (333, 2000), (2000, cfg["inlen"])):
        assert np.array_equal(port.process(x[a:b]), ref.process(x[a:b]))
    for m in (1, 100, 1000):
        assert (port.get_input_required_for_output(m)
                == ref.get_input_required_for_output(m))
        assert (port.get_in_len_before_out_pos(m)
                == ref.get_in_len_before_out_pos(m))
    assert port.max_out_len(4096) == ref.max_out_len(4096)
    assert port.latency_frac == ref.latency_frac


@pytest.mark.parametrize("label", ("up_44k_96k", "poly_96001"))
def test_oracle_on_converted_plan(label):
    """A reference plan carried across (plan_from_reference) runs the
    port's oracle bit-equal to the reference oracle on the original."""
    cfg = BY_LABEL[label]
    ref_plan = ref_make_plan(cfg["src"], cfg["dst"], cfg["tb"],
                             cfg["atten"], cfg["phase"])
    x = lcg_uniform(cfg["seed"], 3000)
    y = OracleResampler(*_args(cfg),
                        plan=plan_from_reference(ref_plan)).oneshot(x)
    assert np.array_equal(y, RefOracle(*_args(cfg), plan=ref_plan).oneshot(x))


@pytest.mark.parametrize("cfg", EXACT, ids=[c["label"] for c in EXACT])
def test_oracle_chunking_invariance(cfg):
    """Output content does not depend on process() chunk segmentation:
    max-in 4000 against 173, within 1e-12 absolute."""
    x = lcg_uniform(cfg["seed"], 4000)
    outlen = int(3000 * cfg["dst"] / cfg["src"])
    src, dst, _m, tb, atten, phase = _args(cfg)
    y_big = OracleResampler(src, dst, 4000, tb, atten, phase).oneshot(
        x, outlen)
    y_small = OracleResampler(src, dst, 173, tb, atten, phase).oneshot(
        x, outlen)
    np.testing.assert_allclose(y_small, y_big, rtol=0, atol=1e-12)
