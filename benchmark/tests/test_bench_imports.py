"""The run's import check, and that nothing under benchmark/ imports JAX,
the JAX package, bench.py or tools/."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from benchmark.run import forbidden_modules
from benchmark.tests.support import ROOT

REFUSED = {"jax", "jaxlib", "flax", "r8brain_tpu", "bench", "tools"}


def test_top_level_names_compared_whole():
    assert forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert forbidden_modules(["r8brain_tpu.models.plan"]) == ["r8brain_tpu"]
    assert forbidden_modules(["r8brain_torch", "r8brain_torch.ops",
                              "jaxtyping", "flaxen"]) == []


def test_fails_on_a_planted_import_jax(monkeypatch):
    assert "jax" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax"]


def test_no_source_imports_them():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in REFUSED, (path, n)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").rglob("*.py"):
        assert "r8brain_torch" not in path.read_text().replace(
            "``r8brain_torch``", "").replace(
            "r8brain_torch/models/oracle.py", ""), path


def test_needs_the_card_and_its_package(tmp_path):
    """Without CUDA, or in a directory that holds only BENCHMARK.json and
    benchmark/, the run exits non-zero and prints no result."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "cd24_96k_batch", "--seed", "2147483659",
                            "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout
