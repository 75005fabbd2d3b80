"""The port's benchmark matrix (tools/torch_bench_matrix.py) on the CPU.

Its row tables against the reference's (tools/bench_matrix.py, which
imports only the standard library), every accuracy row's arguments
against tools/torch_chip_accuracy.py's parser and configurations,
``--quick`` end to end on the plain path at a tiny size, the output
names, a garbled line and a timeout as error records in a sweep that
goes on, and the committed
matrix (BENCHMATRIX_torch_r1.json, written on the card): every row, in
the reference's order, rc 0, and every accuracy cell inside its class.
No assertion rests on a CPU time."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tools import bench_matrix as ref
from tools import torch_bench_matrix as tbm
from tools import torch_chip_accuracy as tca

ROOT = Path(__file__).resolve().parent.parent
TINY = {"R8B_BENCH_CHANNELS": "2", "R8B_BENCH_SECONDS": "0.05",
        "R8B_BENCH_ITERS": "2", "R8B_BENCH_REPEATS": "1"}


def test_tables_equal_the_reference():
    assert tbm.BENCH_RUNS == ref.BENCH_RUNS
    assert tbm.ACCURACY_RUNS == ref.ACCURACY_RUNS
    labels = [r[0] for r in tbm.rows()]
    assert labels == ([r[0] for r in ref.BENCH_RUNS]
                      + [r[0] for r in ref.ACCURACY_RUNS]
                      + [r[0] for r in tbm.SERVE_RUNS])
    # the serving rows: the reference's run_one calls, in its order, with
    # its env overrides and timeouts
    src = Path(ref.__file__).read_text()
    at = [src.index(f'run_one("{label}"') for label, *_ in tbm.SERVE_RUNS]
    assert at == sorted(at)
    assert tbm.SERVE_RUNS == [
        ("stream_throughput", tbm.STREAM_TOOL, {}, 2400),
        ("stream_latency_curve", tbm.CURVE_TOOL, {}, 3600),
        ("stream_throughput_poly", tbm.STREAM_TOOL,
         {"R8B_SBENCH_DST": "96001"}, 3600),
        ("stream_latency_curve_poly", tbm.CURVE_TOOL,
         {"R8B_LBENCH_DST": "96001"}, 3600)]
    assert 'env_poly["R8B_SBENCH_DST"] = "96001"' in src
    assert 'env_lpoly["R8B_LBENCH_DST"] = "96001"' in src


@pytest.mark.parametrize("label,args,_to", ref.ACCURACY_RUNS,
                         ids=[r[0] for r in ref.ACCURACY_RUNS])
def test_accuracy_row_parses(label, args, _to):
    """The row's arguments parse in torch_chip_accuracy's parser, and
    every configuration it names is known there and has a class."""
    a = tca.parser().parse_args(args + ["--device", "cpu"])
    for cfg in a.configs.split(","):
        assert cfg in tca.CONFIGS and cfg in tca.CLASS_DB, (label, cfg)


def test_output_names(tmp_path):
    """The default names are the port's own; a reference round file is
    refused, whatever the directory."""
    for n in (1, 5, 12):
        assert not tbm.PRE_PORT.fullmatch(f"BENCHMATRIX_torch_r{n}.json")
        assert tbm.PRE_PORT.fullmatch(f"BENCHMATRIX_r{n}.json")
    assert not tbm.PRE_PORT.fullmatch("BENCHMATRIX_torch_quick.json")
    for n in (3, 5):
        with pytest.raises(SystemExit):
            tbm.main(["--device", "cpu", "--out",
                      str(tmp_path / f"BENCHMATRIX_r{n}.json")])
        assert not (tmp_path / f"BENCHMATRIX_r{n}.json").exists()


def test_quick_on_cpu(tmp_path):
    """--quick runs the first two throughput rows through
    tools/torch_bench.py: the _meta line, then two records with rc 0 and
    the reference's metric names."""
    out = tmp_path / "BENCHMATRIX_torch_quick.json"
    r = subprocess.run(
        [sys.executable, "tools/torch_bench_matrix.py", "--quick",
         "--device", "cpu", "--out", str(out)], capture_output=True,
        text=True, cwd=str(ROOT), timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", **TINY))
    assert r.returncode == 0, r.stderr[-2000:]
    meta, *recs = tbm.read_matrix(out)
    assert meta["label"] == "_meta" and meta["device"] == "cpu"
    assert meta["code_sha256"] == tbm.code_sha256()
    assert [x["label"] for x in recs] == ["flagship_fast", "flagship_high"]
    assert [x["metric"] for x in recs] == [
        "resample_44k_to_96k_24bit_throughput",
        "resample_44k_to_96k_24bit_hp_throughput"]
    for x in recs:
        assert x["rc"] == 0 and "error" not in x and x["card"] == "cpu"
        assert x["env"]["R8B_BENCH_CHANNELS"] == "2"
        assert isinstance(x["value"], float) and x["wall_s"] >= 0
    assert recs[1]["env"]["R8B_BENCH_PRECISION"] == "high"


def _fake_rows(quick=False):
    """A garbled line, a timeout and a good record, as rows of
    ``python -c``."""
    return [("garbled", "-c", ["print('{\"metric\": 1')"], {}, 60),
            ("slow", "-c", ["import time; time.sleep(30)"], {}, 1),
            ("good", "-c", ["print('{\"metric\": \"m\", \"value\": 1.5}')"],
             {"R8B_BENCH_SRC": "48000"}, 60)]


def test_errors_become_records(tmp_path, monkeypatch):
    """A garbled tool line and a timeout each become an error record,
    and the sweep goes on to the next row."""
    monkeypatch.setattr(tbm, "rows", _fake_rows)
    out = tmp_path / "m.json"
    assert tbm.main(["--device", "cpu", "--out", str(out)]) == 0
    meta, garbled, slow, good = tbm.read_matrix(out)
    assert meta["label"] == "_meta"
    assert garbled["label"] == "garbled" and garbled["rc"] == 0
    assert garbled["error"].startswith("bad json")
    assert slow["label"] == "slow" and slow["rc"] == -1
    assert slow["error"] == "timeout after 1s"
    assert good == {**good, "label": "good", "rc": 0, "metric": "m",
                    "value": 1.5, "card": "cpu"}
    assert good["env"]["R8B_BENCH_SRC"] == "48000"


def test_refuses_without_cuda(tmp_path, monkeypatch):
    """Its default device is the card: without CUDA it raises and writes
    nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "m.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbm.main(["--out", str(out)])
    assert not out.exists()


def test_committed_matrix():
    """BENCHMATRIX_torch_r1.json, written on the card from one code
    state: every row of the reference's matrix in its order, each with rc
    0, no error and the card's name; every accuracy cell a number inside
    its class (torch_chip_accuracy.CLASS_DB)."""
    meta, *recs = tbm.read_matrix(ROOT / "BENCHMATRIX_torch_r1.json")
    assert meta["label"] == "_meta" and meta["device"] == "cuda"
    assert "H100" in meta["card"] and meta["code_sha256"]
    assert [r["label"] for r in recs] == [r[0] for r in tbm.rows()]
    acc = {r[0] for r in tbm.ACCURACY_RUNS}
    for r in recs:
        assert r["rc"] == 0 and "error" not in r, r
        assert r["card"] == meta["card"], r["label"]
        if r["label"] in acc:
            for cfg, db in r["results"].items():
                assert isinstance(db, float) and db <= tca.CLASS_DB[cfg], (
                    r["label"], cfg, db)
