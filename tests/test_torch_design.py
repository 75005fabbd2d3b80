"""The port's host design layer (r8brain_torch design/ and models/plan.py)
against the reference package's.

The port keeps its own copy of the planner and the filter designers (it
may import nothing of the reference package), so the two must agree
exactly: every stage kind and integer equal, every float equal, every tap
array bit-equal.  Configurations: every golden of tests/goldens/
manifest.json plus a rate x attenuation x phase matrix (the pattern of
tests/test_native_design.py).
"""

import dataclasses

import numpy as np
import pytest

from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_torch.models.plan import make_plan

from .helpers import load_manifest

MANIFEST = load_manifest()

MATRIX = [(src, dst, atten, phase)
          for src, dst in ((44100, 96000), (96000, 44100), (44100, 48000),
                           (44100, 96001))
          for atten in (136.45, 180.15, 206.91)
          for phase in (0, 1)]


def assert_same(ref, port, path="plan"):
    """Recursive exact equality of a reference-package object and the
    port's counterpart (dataclasses field by field, arrays bit-equal)."""
    if dataclasses.is_dataclass(port):
        assert type(ref).__name__ == type(port).__name__, path
        for f in dataclasses.fields(port):
            assert_same(getattr(ref, f.name), getattr(port, f.name),
                        f"{path}.{f.name}")
    elif isinstance(port, np.ndarray):
        assert isinstance(ref, np.ndarray), path
        assert ref.dtype == port.dtype and ref.shape == port.shape, path
        assert np.array_equal(ref, port), path
    elif isinstance(port, (tuple, list)):
        assert len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            assert_same(r, p, f"{path}[{i}]")
    else:
        assert ref == port, (path, ref, port)


@pytest.mark.parametrize("cfg", MANIFEST, ids=[c["label"] for c in MANIFEST])
def test_plan_matches_reference_goldens(cfg):
    args = (cfg["src"], cfg["dst"], cfg["tb"], cfg["atten"], cfg["phase"])
    ref, port = ref_make_plan(*args), make_plan(*args)
    assert ref.describe() == port.describe()
    assert_same(ref, port)


@pytest.mark.parametrize("cfg", MATRIX,
                         ids=[f"{s}-{d}-{a}-ph{p}" for s, d, a, p in MATRIX])
def test_plan_matches_reference_matrix(cfg):
    src, dst, atten, phase = cfg
    ref = ref_make_plan(src, dst, 2.0, atten, phase)
    port = make_plan(src, dst, 2.0, atten, phase)
    assert_same(ref, port)


def test_port_imports_no_jax():
    """The port package (its functional transform, fused polynomial
    executor, CLI, WAV I/O, native binding, oracle and response scanners
    too), the smoke script and the port's two bench scripts import
    neither JAX nor the reference package (checked in a fresh
    interpreter)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys, r8brain_torch, r8brain_torch.convert, chip_smoke, "
            "r8brain_torch.ops.pallas_dfft, r8brain_torch.ops.scout, "
            "r8brain_torch.functional, r8brain_torch.ops.poly_fused, "
            "r8brain_torch.cli, r8brain_torch.io, r8brain_torch.native, "
            "r8brain_torch.models.oracle, r8brain_torch.utils.scan; "
            "sys.path.insert(0, 'tools'); "
            "import torch_bench, torch_bench_stream; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'r8brain_tpu'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


EXAMPLES = ("torch_basic", "torch_sacd", "torch_serving",
            "torch_native_deploy", "torch_differentiable")


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_examples_import_no_jax(name):
    """Every import statement of the port's examples (at any depth, the
    ones inside functions too) names neither JAX nor the reference
    package."""
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "r8brain_torch" in {n.split(".")[0] for n in names}
    bad = [n for n in names if n.split(".")[0] in ("jax", "r8brain_tpu")]
    assert not bad, bad


# Filters of tests/test_design.py: the low-pass designs of
# test_lp_filter_meets_spec, the 180 dB half-band and the minimum-phase
# band kernel of test_min_phase_transform_properties.
SCAN_LP = [(0.7, 60.0), (2.0, 100.0), (2.0, 180.15), (5.0, 140.0),
           (12.0, 90.0), (30.0, 200.0), (45.0, 49.0), (0.5, 218.0)]
SCAN_FILTERS = [f"lp-{tb}-{a}" for tb, a in SCAN_LP] + ["hb-180.15", "minph"]
SCAN_FUNCS = ("response_mag", "convert_response_to_log", "find_response_max",
              "find_response_min", "find_level_rtol")
SCAN_RTOL = 1e-12


def _scan_filter(name):
    """(kernel, pass-band edge, -3 dB level) of one SCAN_FILTERS entry,
    designed by the port's own designers."""
    from r8brain_torch.design.halfband import get_hb_filter
    from r8brain_torch.design.lpfilter import build_lp_filter
    from r8brain_torch.design.minphase import min_phase_transform
    from r8brain_torch.design.sinc import generate_band_kernel

    lvl = 10 ** (-3.0 / 20.0)
    if name.startswith("lp-"):
        tb, atten = (float(v) for v in name[3:].split("-"))
        return build_lp_filter(0.5, tb, atten, req_gain=1.0).kernel, 0.5, lvl
    if name.startswith("hb-"):
        return get_hb_filter(180.15, 0, False).dense_kernel(), 0.5, 2.0 * lvl
    k, _ = generate_band_kernel(60.0, 0.0, 0.4 * np.pi, params=(10.0, 1.8),
                                use_power=True)
    return min_phase_transform(k, len_mult=16)[0], 0.4, lvl


@pytest.mark.parametrize("func", SCAN_FUNCS)
@pytest.mark.parametrize("name", SCAN_FILTERS)
def test_scan_matches_reference(name, func):
    """The port's response scanners (utils/scan.py) against the reference
    package's on the same filter, to SCAN_RTOL relative: the magnitude
    and its dB on a dense grid, the extrema in the pass band and the stop
    band, and the right-to-left -3 dB crossing."""
    from r8brain_tpu.utils import scan as ref
    from r8brain_torch.utils import scan as port

    k, nf, lvl = _scan_filter(name)
    th = np.linspace(0.0, np.pi, 2049)
    if func == "response_mag":
        calls = [(th,)]
    elif func == "convert_response_to_log":
        calls = [(ref.response_mag(k, th),)]
    elif func in ("find_response_max", "find_response_min"):
        calls = [(0.0, 0.9 * nf * np.pi), (1.1 * nf * np.pi, np.pi)]
    else:
        calls = [(lvl, np.pi)]
    for args in calls:
        if func != "convert_response_to_log":
            args = (k,) + args
        want = getattr(ref, func)(*args)
        got = getattr(port, func)(*args)
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64),
                                   rtol=SCAN_RTOL, atol=0, err_msg=str(args[1:]))
