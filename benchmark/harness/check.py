"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, every kept
output (a sample of the window's calls or blocks, drawn from the seed;
the loop's ``kept``, ``loops/<kind>.py``) is held against the plain
reference (``reference/chain.py``, float64) on the same inputs, in
blocks of rows: a oneshot against the reference's conversion of its
batch, zero-flushed; a stream block against the reference's outputs at
the block's absolute positions in the conversion of the concatenated
blocks, so every seam between blocks is checked too.  Two numbers, each
with its limit from the configuration's ``limits`` (under the loop's
``LIMITS``):

* ``worst_row_rms``: the largest RMS over one row's samples of the
  difference, full scale 1.0 (a row left out, altered or misplaced shows
  here);
* ``max_abs``: the largest absolute difference of any sample.

A shape that is not the reference's, or a value that is not finite,
reads infinity.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from ..reference.chain import Chain
from ..reference.plan import make_plan

__all__ = ["NUMBERS", "check_window", "control_readings", "frozen_plan",
           "oneshot_source", "out_len", "stream_source"]

NUMBERS = ("worst_row_rms", "max_abs")
ROW_BLOCK = 128


def frozen_plan(config: dict):
    a = config["args"]
    return make_plan(a["src_rate"], a["dst_rate"], a["trans_band"],
                     a["atten"], a["phase"])


def out_len(config: dict, n_in: int) -> int:
    a = config["args"]
    return int(math.floor(n_in * a["dst_rate"] / a["src_rate"]))


def oneshot_source(x: torch.Tensor) -> Callable:
    """source(r0, r1) -> (c, d) -> x's rows, zero past its end."""
    N = x.shape[1]

    def rows(r0, r1):
        def src(c, d):
            s = x[r0:r1, min(c, N):min(d, N)]
            return F.pad(s, (0, (d - c) - s.shape[1]))
        return src
    return rows


def stream_source(pool: torch.Tensor) -> Callable:
    """source(r0, r1) -> (c, d) -> the concatenated stream of blocks
    ``pool[j % len(pool)]``, block j at samples [j*L, (j+1)*L)."""
    P, _, L = pool.shape

    def rows(r0, r1):
        def src(c, d):
            if d <= c:
                return pool[0, r0:r1, :0]
            parts = []
            for j in range(c // L, (d - 1) // L + 1):
                lo, hi = max(c, j * L) - j * L, min(d, (j + 1) * L) - j * L
                parts.append(pool[j % P, r0:r1, lo:hi])
            return torch.cat(parts, dim=1)
        return src
    return rows


def _fold(worst: Dict[str, float], d: torch.Tensor) -> None:
    """Fold the differences d [rows, n] into the worst readings."""
    if not bool(torch.isfinite(d).all()):
        worst.update(dict.fromkeys(NUMBERS, math.inf))
    elif d.shape[1]:
        worst["worst_row_rms"] = max(worst["worst_row_rms"], float(
            d.square().mean(dim=1).sqrt().max()))
        worst["max_abs"] = max(worst["max_abs"], float(d.abs().max()))


def _numbers(chain: Chain, rows: Callable, y: torch.Tensor, C: int, a: int,
             b: int) -> Dict[str, float]:
    """The two numbers of output y [C, b - a] against outputs [a, b)."""
    if tuple(y.shape) != (C, b - a):
        return dict.fromkeys(NUMBERS, math.inf)
    worst = dict.fromkeys(NUMBERS, 0.0)
    for r0 in range(0, C, ROW_BLOCK):
        r1 = min(C, r0 + ROW_BLOCK)
        _fold(worst, y[r0:r1].to(torch.float64)
              - chain.run(rows(r0, r1), a, b))
    return worst


def check_window(w, config: dict, loop, device) -> dict:
    """{"numbers": {name: worst reading}, "limits": ..., "failed": items
    over a limit, "compared": items} of the window's kept outputs
    (``loop``: the loop module that ran the window)."""
    limits = config["limits"][loop.LIMITS]
    chain = Chain(frozen_plan(config), device)
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = compared = 0
    with torch.no_grad():
        for rows, y, a, b in loop.kept(w, config):
            got = _numbers(chain, rows, y, w.channels, a, b)
            compared += 1
            failed += any(not got[k] <= limits[k] for k in NUMBERS)
            for k in NUMBERS:
                worst[k] = max(worst[k], got[k])
    return {"numbers": worst, "limits": {k: limits[k] for k in NUMBERS},
            "failed": failed, "compared": compared}


def control_readings(config: dict, loop, pool: torch.Tensor,
                     picks: Sequence[int], device) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference, on the items of ``pool`` that the loop
    module ``loop`` names (``control_items``: a oneshot's batches, a
    stream's blocks ``picks``)."""
    plan = frozen_plan(config)
    ref, ctl = Chain(plan, device), Chain(plan, device, "tf32")
    C = pool.shape[1]
    worst = dict.fromkeys(NUMBERS, 0.0)
    with torch.no_grad():
        for rows, a, b in loop.control_items(config, pool, picks):
            for r0 in range(0, C, ROW_BLOCK):
                src = rows(r0, min(C, r0 + ROW_BLOCK))
                _fold(worst, ctl.run(src, a, b) - ref.run(src, a, b))
    return worst
