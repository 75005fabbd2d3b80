"""What every loop shares: the system, the inputs, the window's record.

A mix is a data file (``traffic/<mix>.json``) of parameters.  Its
``kind`` names the loop that drives the system with them,
``loops/<kind>.py``, found by that name (``spec.Bench.loop``), so a new
kind of traffic is a new file and no existing one changes.  A loop
module holds:

* ``LIMITS``: the key of the configuration's ``limits`` that its kept
  outputs are held to;
* ``run(rs, traffic, config, seed, seconds, device, span, window_ctx)
  -> Window``: warm-up (set-up), then the measured window, keeping a
  sample of its outputs drawn from the seed.  ``span(name)`` opens a host
  range (the traced run's ``record_function``); ``window_ctx()`` is
  entered right before the window opens (the traced run's profiler);
* ``kept(window, config)``: each kept output as (rows, y, a, b), where
  ``rows(r0, r1)`` gives the reference's input source of rows [r0, r1)
  and y is to equal the reference's outputs [a, b) (``harness/check.py``);
* ``control_items(config, pool, picks)``: the same (rows, a, b) for the
  control's reading on ``pool``, at items ``picks``;
* ``floor_s(window, config, peak)``: the floor seconds of the window's
  work on the card (``harness/work.py``).

End-to-end and per-layer metrics read the ``Window`` (and, traced, the
``Trace``) through their own files, ``metrics/<name>.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

__all__ = ["DTYPES", "Device", "Reservoir", "Window", "build_system",
           "input_len", "make_pool"]

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_system(config: dict, device):
    """The system under test: ``r8brain_torch.Resampler`` on the
    configuration's arguments."""
    from r8brain_torch import Resampler

    args = dict(config["args"])
    args["dtype"] = DTYPES[args["dtype"]]
    return Resampler(device=device, **args)


def input_len(config: dict, traffic: dict) -> int:
    """Samples a row of ``input_seconds`` at the source rate."""
    return int(round(config["args"]["src_rate"] * traffic["input_seconds"]))


def make_pool(seed: int, shape, device) -> torch.Tensor:
    """Full-scale uniform noise in [-1, 1), float32, made on the device
    from the seed in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    x = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return x.mul_(2).sub_(1)


class Reservoir:
    """A uniform sample of ``size`` items of a sequence of unknown length
    (Algorithm R), drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, np.random.default_rng(seed % 2**64)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.size:
                self.items[r] = item
        self.seen += 1


class Device:
    """Synchronise and mark on a CUDA device; nothing to do on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event()
        e.record()
        return e


@dataclass
class Window:
    """What one measured window did, on the host's clock."""

    kind: str
    seconds: float           # window start to the end of its last sync
    items: int               # calls or blocks completed in the window
    channels: int
    item_len: int            # input samples a call or a block, a channel
    first_call_at: float     # perf_counter() at the first timed call
    entry_s: List[float] = field(default_factory=list)    # call to return
    latency_s: List[float] = field(default_factory=list)  # call to sync
    kept: list = field(default_factory=list)
    pool: torch.Tensor = None
    distinct: int = 0
    items_before: int = 0    # items run before the window (warm-up)
    marks: dict = field(default_factory=dict)  # set-up steps' perf_counter
