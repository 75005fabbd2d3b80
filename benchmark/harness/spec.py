"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and the metrics; every one of them is a file of its own
under ``benchmark/``, found here by that name, so a cell, a configuration,
a mix, a kind of traffic or a metric is added as a new file and no
existing file changes:

* ``configs/<config>.json``: the system's arguments and the limits of
  the comparison that decides ``correct``;
* ``traffic/<mix>.json``: data, the parameters of a mix; its ``kind``
  names the loop that reads them;
* ``loops/<kind>.py``: the loop that drives the system with a mix of
  that kind (``harness/loop.py`` says what it holds);
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``
  (``harness/cell.py``'s ``Run``), end-to-end and per-layer metrics
  alike; None leaves a per-layer metric out.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["Bench", "SpecError"]

BENCH_DIR = "benchmark"


class SpecError(Exception):
    """A cell, configuration, mix or metric that the files do not hold."""


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise SpecError(f"no {path}")
        self.doc = json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def _file(self, sub: str, name: str, suffix: str) -> Path:
        path = self.dir / sub / f"{name}{suffix}"
        if not path.is_file():
            raise SpecError(f"{sub[:-1]} {name!r}: no file {path}")
        return path

    def config(self, name: str) -> dict:
        return json.loads(self._file("configs", name, ".json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._file("traffic", name, ".json").read_text())

    def _module(self, sub: str, name: str, needs):
        path = self._file(sub, name, ".py")
        tag = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{sub}_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for attr in needs:
            if not hasattr(mod, attr):
                raise SpecError(f"{sub[:-1]} {name!r}: {path} has no {attr}")
        return mod

    def reader(self, name: str):
        """The module of metric ``name``: its ``read(run)``."""
        return self._module("metrics", name, ("read",))

    def loop(self, kind: str):
        """The loop module of traffic kind ``kind``."""
        return self._module("loops", kind, ("LIMITS", "run", "kept",
                                            "control_items", "floor_s"))

    def metrics(self, cell: str, end_to_end: bool) -> list:
        """The metric entries that cell ``cell`` reports: its end-to-end
        ones, or its per-layer ones (those that list it, or that list no
        cells and move an end-to-end metric it reports)."""
        e2e = [m for m in self.doc["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if end_to_end:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
