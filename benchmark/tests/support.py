"""Helpers of the benchmark's tests: tiny CPU runs of a cell."""

from __future__ import annotations

import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Tiny sizes for the CPU: the harness's whole run, the program's plain
#: PyTorch path underneath.
TINY = {"oneshot": {"channels": 3, "input_seconds": 0.05},
        "stream": {"channels": 3, "block_len": 1024}}
CELLS = ("cd24_96k_batch", "cd24_96001_batch", "cd24_96k_stream")


def tiny(cell: str) -> dict:
    return TINY["stream" if cell.endswith("stream") else "oneshot"]


def run_cpu(cell: str, trace: bool = False, seed: int = 4100000003,
            root=ROOT, seconds: float = 0.3, **override) -> dict:
    from benchmark.harness.cell import execute

    return execute(root, cell, seed, seconds, trace, "cpu",
                   time.perf_counter(), dict(tiny(cell), **override))
