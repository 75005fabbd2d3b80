"""The last line's schema, from a tiny CPU run of each cell."""

from __future__ import annotations

import json

import pytest

from benchmark.harness.spec import Bench
from benchmark.tests.support import CELLS, ROOT, run_cpu


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_schema(cell, trace):
    out = run_cpu(cell, trace=trace)
    out.pop("_info")
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "check"
    assert ("breakdown" in keys) == trace
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"]: m["unit"] for m in Bench(ROOT).metrics(cell, not trace)}
    got = out["metrics"]
    assert set(got) <= set(want)
    for name, m in got.items():
        assert set(m) == {"value", "unit"} and m["unit"] == want[name]
        assert isinstance(m["value"], float)
    if not trace:
        assert set(got) == set(want)
        assert got["setup_s"]["value"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        for lst in out["breakdown"].values():
            assert len(lst) <= 10
    for v in out["check"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.loads(json.dumps(out))
