"""Smoke tests of the port's bench scripts (tools/torch_bench.py,
tools/torch_bench_stream.py): each runs on the CPU at a tiny size and
prints its reference script's JSON record.  Only the record's keys and
types are checked: a CPU timing says nothing of the card, and no
assertion rests on a difference of two wall times."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(script, env):
    """The script's record; its torch on one thread, as the port's test
    modules run theirs."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / script),
                        "--device", "cpu"], capture_output=True, text=True,
                       env=dict(os.environ, OMP_NUM_THREADS="1", **env),
                       cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _check_types(rec, keys):
    for k, t in keys.items():
        assert isinstance(rec[k], t), (k, rec[k])


@pytest.mark.parametrize("env,metric", [
    ({}, "resample_44k_to_96k_24bit_throughput"),
    ({"R8B_BENCH_DST": "192000", "R8B_BENCH_FUSED": "1",
      "R8B_BENCH_PRECISION": "high"},
     "resample_44100_to_192000_24bit_hp_throughput")],
    ids=["headline", "off_headline_fused"])
def test_torch_bench_record(env, metric):
    rec = _run("torch_bench.py", dict(
        R8B_BENCH_CHANNELS="2", R8B_BENCH_SECONDS="0.05",
        R8B_BENCH_ITERS="2", R8B_BENCH_REPEATS="0", **env))
    assert rec["metric"] == metric and rec["unit"] == "Mrops"
    keys = {"value": float, "vs_baseline": float, "exec_value": float,
            "exec_vs_baseline": float, "device": str}
    if "R8B_BENCH_DST" in env:
        keys.update(ratio=float, exec_out_msamples_s=float)
    else:
        assert "ratio" not in rec
    _check_types(rec, keys)


@pytest.mark.parametrize("dst,poly", [("96000", False), ("96001", True)],
                         ids=["rational", "poly"])
def test_torch_bench_stream_record(dst, poly):
    rec = _run("torch_bench_stream.py", dict(
        R8B_SBENCH_CHANNELS="2", R8B_SBENCH_BLOCKS="2",
        R8B_SBENCH_BLOCK="1024", R8B_SBENCH_KBATCH="2", R8B_SBENCH_DST=dst))
    assert rec["unit"] == "Mrops"
    keys = {"value": float, "vs_baseline": float, "block_len": int,
            "realtime_streams_per_chip": int, "device": str}
    if poly:
        assert rec["metric"] == "stream_44100_to_96001_steady_throughput"
        assert rec["mode"] == "poly_device_resident" and rec["k_batch"] == 2
        keys.update(realtime=bool)
    else:
        assert rec["metric"] == "stream_44k_to_96k_steady_throughput"
    _check_types(rec, keys)


def test_bench_scripts_refuse_without_cuda():
    """Their default device is the card: without CUDA they raise, and
    print no record."""
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: "
            "False; sys.argv = ['x']; runpy.run_path(r'%s', "
            "run_name='__main__')")
    for script in ("torch_bench.py", "torch_bench_stream.py"):
        r = subprocess.run([sys.executable, "-c",
                            code % (ROOT / "tools" / script)],
                           capture_output=True, text=True, cwd=str(ROOT),
                           timeout=600)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
        assert not r.stdout.strip()


def test_torch_bench_profile(tmp_path):
    """R8B_BENCH_PROFILE names a directory: the script writes a Chrome
    trace of two more calls there, named after the record's metric, and
    still prints its record."""
    prof = tmp_path / "prof"
    rec = _run("torch_bench.py", dict(
        R8B_BENCH_CHANNELS="2", R8B_BENCH_SECONDS="0.05",
        R8B_BENCH_ITERS="2", R8B_BENCH_REPEATS="1",
        R8B_BENCH_METRIC="profiled", R8B_BENCH_PROFILE=str(prof)))
    assert rec["metric"] == "profiled"
    trace = json.loads((prof / "profiled.pt.trace.json").read_text())
    assert trace["traceEvents"]
