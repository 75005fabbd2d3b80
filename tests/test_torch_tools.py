"""CPU smoke tests of the port's acceptance tools (tools/torch_*.py).

Each tool's command line on the plain path (``--device cpu``):
``torch_rmscompare`` on WAV files the port writes (identical, and at a
known offset), ``torch_snrtest --impl f32 --ratios 1 --step 84``,
``torch_flt_test`` (its SNR rows against the reference tool's),
``torch_chip_accuracy`` on two configurations, ``torch_latency_curve`` at
two channels and two requested block lengths (tests/test_latency_curve_
smoke.py's JSON contract: finite times, block lengths deduplicated,
valid JSON; no speed asserted).  Every tool defaults to ``--device cuda``
and raises without CUDA, and no port tool imports JAX or the reference
package.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from r8brain_torch.io import write_wav

ROOT = Path(__file__).resolve().parent.parent
PORT_TOOLS = sorted(p.name for p in (ROOT / "tools").glob("torch_*.py"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", PORT_TOOLS)
def test_port_tool_imports_no_jax(name):
    """Every import statement of a port tool (at any depth) names neither
    JAX nor the reference package."""
    tree = ast.parse((ROOT / "tools" / name).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    bad = [m for m in names if m == "jax" or m.startswith(
        ("jax.", "r8brain_tpu", "tools.zerotest", "tools.snrtest"))]
    assert not bad, bad


def test_acceptance_tools_import_no_jax():
    """The seven acceptance tools imported in a fresh interpreter load
    neither JAX nor the reference package."""
    mods = ("torch_rmscompare, torch_zerotest, torch_snrtest, "
            "torch_flt_test, torch_fuzz, torch_chip_accuracy, "
            "torch_latency_curve")
    code = (f"import sys; sys.path.insert(0, 'tools'); import {mods}; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'r8brain_tpu'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _cuda_default_calls(tmp_path):
    a = str(tmp_path / "a.wav")
    return {
        "torch_rmscompare": [a, a],
        "torch_zerotest": ["--impl", "f32", "--quick"],
        "torch_snrtest": ["--impl", "f32"],
        "torch_flt_test": [],
        "torch_chip_accuracy": [],
        "torch_latency_curve": [],
        "torch_fuzz": ["--trials", "1"],
    }


@pytest.mark.parametrize("name", ["torch_rmscompare", "torch_zerotest",
                                  "torch_snrtest", "torch_flt_test",
                                  "torch_chip_accuracy",
                                  "torch_latency_curve", "torch_fuzz"])
def test_tool_defaults_to_cuda(name, tmp_path, monkeypatch):
    """Without --device a tool runs on cuda, and without CUDA it raises
    instead of carrying on on the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(_cuda_default_calls(tmp_path)[name])


def test_rmscompare_equal_and_offset(tmp_path, capsys):
    from tools.torch_rmscompare import main

    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, (2, 9600))
    a, b, c = (str(tmp_path / f"{k}.wav") for k in "abc")
    write_wav(a, 48000, x, 64, float_fmt=True)
    write_wav(b, 48000, x, 64, float_fmt=True)
    write_wav(c, 48000, x + 1e-6, 64, float_fmt=True)
    assert main([a, b, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "EQUAL" in out and "-3000.00 dB" in out
    assert main([a, c, "--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "channel 0: RMS diff -120.00 dB"
    assert out[1] == "channel 1: RMS diff -120.00 dB"
    assert out[2].startswith("DIFFERENT (worst -120.00 dB")
    assert main([a, c, "--device", "cpu", "--thresh", "-119"]) == 0
    write_wav(c, 44100, x, 64, float_fmt=True)
    assert main([a, c, "--device", "cpu"]) == 2


def test_snrtest_f32_smoke():
    from tools.torch_snrtest import last, main

    assert main(["--impl", "f32", "--device", "cpu", "--ratios", "1",
                 "--step", "84"]) == 0
    assert [row[0] for row in last] == [49.0, 133.0, 217.0]
    assert all(mn >= floor for _a, _avg, mn, floor in last)


def test_flt_test_matches_reference_tool(capsys):
    """The port's bank SNR at each atten equals the reference tool's
    printed row (both float64)."""
    from tools import flt_test
    from tools.torch_flt_test import last, main

    assert main(["--device", "cpu"]) == 0
    capsys.readouterr()
    assert flt_test.main([]) == 0
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()[1:5]]
    assert len(last) == len(rows) == 4
    for (a, taps, fracs, snr), ref in zip(last, rows):
        assert (a, taps, fracs) == (float(ref[0]), int(ref[1]), int(ref[2]))
        assert abs(snr - float(ref[3])) < 0.06, (a, snr, ref)
        assert snr > a - 10.0


def test_chip_accuracy_cpu_smoke(capsys):
    from tools.torch_chip_accuracy import main

    assert main(["--device", "cpu", "--configs", "fast,ozaki",
                 "--channels", "1", "--seconds", "0.05"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "chip_accuracy_db" and rec["device"] == "cpu"
    assert set(rec["results"]) == {"fast", "ozaki"}
    assert all(v < -141.0 for v in rec["results"].values()), rec


@pytest.mark.parametrize("dst", ["96000", "96001"])
def test_latency_curve_cpu_smoke(dst):
    env = os.environ.copy()
    env.update({"R8B_LBENCH_CHANNELS": "2", "R8B_LBENCH_BLOCKS": "256,1024",
                "R8B_LBENCH_ITERS": "2", "R8B_LBENCH_DST": dst,
                "OMP_NUM_THREADS": "1"})
    r = subprocess.run([sys.executable, "tools/torch_latency_curve.py",
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "stream_latency_curve"
    assert rec["channels"] == 2 and rec["device"] == "cpu"
    assert rec["mode"] == ("period" if dst == "96000" else "poly")
    assert rec["points"], rec
    lens = [p["block_len"] for p in rec["points"]]
    assert len(set(lens)) == len(lens), f"duplicate block_len: {lens}"
    for p in rec["points"]:
        assert np.isfinite(p["ms_per_block"]) and p["ms_per_block"] > 0
        assert p["block_ms"] > 0 and isinstance(p["realtime"], bool)
