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
    """The port package and the smoke script import neither JAX nor the
    reference package (checked in a fresh interpreter)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys, r8brain_torch, r8brain_torch.convert, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'r8brain_tpu'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
