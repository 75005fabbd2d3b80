"""The port's binding of the shared C++ engine (r8brain_torch.native).

build_plan_blob over the port's plans writes byte for byte what the
reference package's binding writes for the same plan (every golden
configuration, the polynomial, DSD64 and SACD -> PCM plans, and a plan
carried across by plan_from_reference); NativeResampler executes the
port's plan sample-exactly against the port's own float64 oracle (-280 dB
re full scale) with the same latency queries; the engine's own designer's
blob round-trips through NativeResampler(blob=), and a blob of other rates
is refused.  Skipped when no C++ toolchain is available."""

import shutil

import numpy as np
import pytest

from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.native import build_plan_blob as ref_build_plan_blob
from r8brain_torch import plan_from_reference
from r8brain_torch.models.oracle import OracleResampler
from r8brain_torch.models.plan import make_plan

from .helpers import lcg_uniform, load_manifest, rms_db
from .test_native import CONFIGS

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

MANIFEST = load_manifest()
#: the half-band cascade and polynomial plans: DSD64, SACD -> PCM, 96001
STAGE_PLANS = [("pcm_to_dsd64", 44100, 2822400, 2.0, 180.15, 0),
               ("sacd_to_pcm", 2822400, 96000, 2.0, 180.15, 0),
               ("poly_96001", 44100, 96001, 2.0, 180.15, 0),
               ("poly_352800_3", 44100, 352800.3, 2.0, 180.15, 0),
               ("minph_192k", 44100, 192000, 2.0, 136.45, 1)]


@pytest.fixture(scope="module")
def native():
    from r8brain_torch import native

    native.build_library()
    return native


@pytest.mark.parametrize("cfg", MANIFEST, ids=[c["label"] for c in MANIFEST])
def test_plan_blob_equals_reference_goldens(native, cfg):
    args = (cfg["src"], cfg["dst"], cfg["tb"], cfg["atten"], cfg["phase"])
    assert native.build_plan_blob(make_plan(*args)) == \
        ref_build_plan_blob(ref_make_plan(*args))


@pytest.mark.parametrize("cfg", STAGE_PLANS, ids=[c[0] for c in STAGE_PLANS])
def test_plan_blob_equals_reference_stage_plans(native, cfg):
    """The port's plan and a reference plan carried across serialise to
    the reference's bytes."""
    ref_plan = ref_make_plan(*cfg[1:])
    want = ref_build_plan_blob(ref_plan)
    assert native.build_plan_blob(make_plan(*cfg[1:])) == want
    assert native.build_plan_blob(plan_from_reference(ref_plan)) == want


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_native_matches_port_oracle(native, cfg):
    """-280 dB re full scale against the port's oracle on the same plan;
    get_input_required_for_output equal, latency_frac within 1e-12."""
    label, src, dst, atten = cfg
    nr = native.NativeResampler(src, dst, 2.0, atten, 0)
    orc = OracleResampler(src, dst, 4096, 2.0, atten, 0, plan=nr.plan)
    n = 8000
    x = lcg_uniform(3, n)
    out_len = int(np.floor(n * dst / src))
    y, ref = nr.oneshot(x, out_len), orc.oneshot(x, out_len)
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -280.0, label
    for m in (1, 100, 1000):
        assert (nr.get_input_required_for_output(m)
                == orc.get_input_required_for_output(m))
    assert abs(nr.latency_frac - orc.latency_frac) < 1e-12


def test_native_on_converted_plan(native):
    """NativeResampler(plan=) takes a plan carried across from the
    reference package: bit-equal output to the port's own plan."""
    ref_plan = ref_make_plan(44100, 96001, 2.0, 160.0, 0)
    x = lcg_uniform(5, 6000)
    a = native.NativeResampler(44100, 96001,
                               plan=plan_from_reference(ref_plan))
    b = native.NativeResampler(44100, 96001, 2.0, 160.0, 0)
    assert np.array_equal(a.oneshot(x), b.oneshot(x))


def test_native_design_blob_roundtrip(native):
    """The C++ designer's blob drives NativeResampler(blob=) to the same
    output as design="native"; its header carries the rates."""
    blob = native.native_design_blob(44100, 48000, 2.0, 180.15, 0)
    assert blob[:4] == b"R8BT"
    x = lcg_uniform(7, 5000)
    a = native.NativeResampler(44100, 48000, blob=blob)
    b = native.NativeResampler(44100, 48000, 2.0, 180.15, 0,
                               design="native")
    assert a.plan is None and b.plan is None
    ya = a.oneshot(x)
    assert ya.shape == (int(np.floor(5000 * 48000 / 44100)),)
    assert np.array_equal(ya, b.oneshot(x))


def test_native_blob_refusals(native):
    blob = native.native_design_blob(44100, 48000, 2.0, 180.15, 0)
    with pytest.raises(ValueError, match="design"):
        native.NativeResampler(44100, 96000, blob=blob)
    with pytest.raises(ValueError, match="design"):
        native.NativeResampler(48000, 48000, blob=blob)
    with pytest.raises(ValueError):
        native.NativeResampler(44100, 48000, blob=b"NOPE" + blob[4:])
    with pytest.raises(ValueError):
        native.NativeResampler(44100, 48000, blob=blob,
                               plan=make_plan(44100, 48000))
    with pytest.raises(ValueError):
        native.NativeResampler(44100, 48000, design="other")


def test_library_resolution(native, monkeypatch, tmp_path):
    """R8BT_LIB first (empty counts as unset), then the package's own
    build of the in-tree sources, kept apart from native/libr8bt.so."""
    built = native.build_library()
    assert built.parent.parent == native._BUILD_DIR
    assert built.resolve() != (native._NATIVE_DIR / "libr8bt.so").resolve()
    monkeypatch.setenv("R8BT_LIB", str(tmp_path / "elsewhere.so"))
    assert native._locate_library(False) == str(tmp_path / "elsewhere.so")
    monkeypatch.setenv("R8BT_LIB", "")
    assert native._locate_library(False) == str(built)
