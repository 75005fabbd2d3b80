"""BENCHMARK.json against the contract's rules, and the files found by
name: a planted configuration, mix, kind of traffic and metric run
without any existing file changing; a workload that names a missing file
is refused."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness.spec import Bench, SpecError
from benchmark.tests.support import ROOT, run_cpu

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["command"] == ["python3", "benchmark/run.py"]
    assert doc["paths"] == ["benchmark"]
    assert 1 <= doc["run_seconds"] <= 51
    assert len(json.dumps(doc)) < 64 * 1024


def test_names_units_and_lines(doc):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in doc[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k], (e["name"], k)
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m) <= {"name", "unit", "better", "source", "bound",
                          "layer", "moves", "workloads"}


def test_configs_cells_and_metrics(doc):
    configs = {c["name"]: c for c in doc["configs"]}
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") \
            and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())[
            "reduced"]
    assert len({c["file"] for c in doc["configs"]}) == len(configs)
    assert len({c["source"] for c in doc["configs"]}) == len(configs)
    pairs = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in doc["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in doc["workloads"]}
    bench = Bench(ROOT)
    for cell in cells:
        reported = [m["name"] for m in bench.metrics(cell, True)]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics(cell, False)
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)


def test_found_by_name():
    b = Bench(ROOT)
    assert b.config("cd24_44k1_96k")["args"]["dst_rate"] == 96000.0
    assert b.traffic("stream_closed")["kind"] == "stream"
    assert callable(b.reader("idle_pct.batch").read)
    assert b.loop("stream").LIMITS == "stream"
    for find in (b.config, b.traffic, b.reader, b.workload, b.loop):
        with pytest.raises(SpecError):
            find("nope")


def _planted_root(tmp_path, config: str = "planted_48k",
                  metric: str = "planted_calls"):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "planted_batch", "config": config,
                             "traffic": "oneshot_batch", "chips": 1,
                             "why": "a planted cell"})
    doc["per_layer"].append({"name": metric, "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "front end", "moves": "batch_mrops",
                             "workloads": ["planted_batch"]})
    for m in doc["end_to_end"]:
        if m["name"] == "batch_mrops":
            m["workloads"].append("planted_batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path


def test_planted_config_and_metric_run(tmp_path):
    root = _planted_root(tmp_path)
    cfg = json.loads((ROOT / "benchmark/configs/cd24_44k1_96k.json")
                     .read_text())
    cfg["args"]["dst_rate"] = 48000.0
    (root / "benchmark/configs/planted_48k.json").write_text(json.dumps(cfg))
    (root / "benchmark/metrics/planted_calls.py").write_text(
        "def read(run):\n    return float(run.window.items)\n")
    before = _files()
    out = run_cpu("planted_batch", trace=False, root=root)
    assert out["correct"] and "batch_mrops" in out["metrics"]
    out = run_cpu("planted_batch", trace=True, root=root)
    assert out["correct"]
    assert out["metrics"]["planted_calls"]["value"] == out["attempted"]
    assert _files() == before


def _files():
    return {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


PLANTED_LOOP = '''"""A planted kind: oneshots, each synchronised before the next."""
import time
from pathlib import Path

from benchmark.harness.loop import (Device, Reservoir, Window, input_len,
                                    make_pool)
from benchmark.harness.spec import Bench

_base = Bench(Path(__file__).resolve().parents[2]).loop("oneshot")
LIMITS, kept = _base.LIMITS, _base.kept
control_items, floor_s = _base.control_items, _base.floor_s


def run(rs, tr, config, seed, seconds, device, span, window_ctx):
    C, distinct, N = tr["channels"], tr["distinct"], input_len(config, tr)
    dev = Device(device)
    pool = make_pool(seed, (distinct, C, N), device)
    rs.oneshot(pool[0])
    dev.sync()
    t = time.perf_counter()
    w = Window("oneshot_sync", 0.0, 0, C, N, 0.0, pool=pool,
               distinct=distinct, marks={"pool": t, "warm": t})
    res = Reservoir(tr["check_calls"], seed)
    with window_ctx(), span("bench.window"):
        t0 = w.first_call_at = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            h0 = time.perf_counter()
            y = rs.oneshot(pool[w.items % distinct])
            dev.sync()
            w.latency_s.append(time.perf_counter() - h0)
            res.offer((w.items, y))
            w.items += 1
        w.seconds = time.perf_counter() - t0
    w.kept = res.items
    return w
'''


def test_planted_kind_of_traffic_runs(tmp_path):
    """A new kind of traffic (its loop), a mix of it, a new end-to-end
    metric and a per-layer one, each a new file: the cell runs and
    reports them, and no existing file changes."""
    root = tmp_path
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "planted_sync", "config":
                             "cd24_44k1_96k", "traffic": "oneshot_sync",
                             "chips": 1, "why": "a planted kind"})
    doc["end_to_end"].append({"name": "call_p95_ms", "unit": "ms",
                              "better": "lower", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["planted_sync"]})
    doc["per_layer"].append({"name": "planted_calls", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "front end", "moves": "call_p95_ms",
                             "workloads": ["planted_sync"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    bd = root / "benchmark"
    (bd / "loops/oneshot_sync.py").write_text(PLANTED_LOOP)
    (bd / "traffic/oneshot_sync.json").write_text(json.dumps(
        {"kind": "oneshot_sync", "channels": 2, "input_seconds": 0.05,
         "distinct": 2, "check_calls": 2}))
    (bd / "metrics/call_p95_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.percentile(run.window.latency_s, 95)) * 1e3\n")
    (bd / "metrics/planted_calls.py").write_text(
        "def read(run):\n    return float(run.window.items)\n")
    before = _files()
    out = run_cpu("planted_sync", root=root)
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "call_p95_ms"}
    assert out["metrics"]["call_p95_ms"]["value"] > 0
    out = run_cpu("planted_sync", trace=True, root=root)
    assert out["correct"]
    assert out["metrics"]["planted_calls"]["value"] == out["attempted"]
    assert _files() == before


def test_workload_naming_a_missing_file_is_refused(tmp_path):
    root = _planted_root(tmp_path, config="no_such_config")
    (root / "benchmark/metrics/planted_calls.py").write_text(
        "def read(run):\n    return 1.0\n")
    with pytest.raises(SpecError, match="no_such_config"):
        run_cpu("planted_batch", root=root)
    root2 = _planted_root(tmp_path / "m", config="cd24_44k1_96k",
                          metric="no_such_metric")
    with pytest.raises(SpecError, match="no_such_metric"):
        run_cpu("planted_batch", trace=True, root=root2)
