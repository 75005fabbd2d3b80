"""The port's examples (examples/torch_*.py) run end to end on the CPU, at
the sizes tests/test_examples.py runs the reference package's, and import
neither JAX nor the reference package while they run."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

#: runs an example as __main__ and then fails if JAX or the reference
#: package was imported
RUNNER = ("import runpy, sys\n"
          "sys.argv = sys.argv[1:]\n"
          "try:\n"
          "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
          "except SystemExit as e:\n"
          "    if e.code:\n"
          "        raise\n"
          "bad = [m for m in sys.modules if m == 'jax' or "
          "m.startswith(('jax.', 'r8brain_tpu'))]\n"
          "assert not bad, bad\n")


@pytest.mark.parametrize("args", [
    ("examples/torch_basic.py", "--device", "cpu"),
    ("examples/torch_sacd.py", "--device", "cpu", "--seconds", "0.06"),
    ("examples/torch_serving.py", "--device", "cpu", "--channels", "8",
     "--blocks", "2"),
    ("examples/torch_native_deploy.py",),
    ("examples/torch_differentiable.py", "--device", "cpu", "--iters",
     "200"),
], ids=["basic", "sacd", "serving", "native_deploy", "differentiable"])
def test_torch_example_runs(args):
    # one torch thread: the suite runs several workers at once
    r = subprocess.run([sys.executable, "-c", RUNNER, *args],
                       capture_output=True, text=True, cwd=str(ROOT),
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       timeout=560)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip()
