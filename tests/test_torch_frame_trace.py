"""The framing copy's span and counters (r8brain_torch/utils/trace.py):
``r8b.frame`` around the ``shifted`` call of each ``FramedOperator.apply``
(ops/operators.py) that still frames a copy (on the CPU, and where the
input needs a cast) and ``frame.bytes``, the bytes that call writes,
counted from host integers (``ops/framing.py::shifted_bytes``): the padded
copy's, 0 where ``shifted`` returns a view; ``frame.direct``, one for
each call whose ``frac_whole`` reads the input in place (on the card).
They record exactly while a ``torch.profiler`` session records, nest
inside their executor's span before the kernel's, and leave every output
as it was.

CPU tests run ``frac_whole``'s plain version; the in-place calls are the
card's rule (``operators._reads_in_place``) taken whatever the device,
and the plain version frames them inside.  The file imports nothing of
JAX.
"""

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.ops import operators
from r8brain_torch.ops.framing import shifted, shifted_bytes
from r8brain_torch.ops.operators import FramedOperator
from r8brain_torch.utils import trace

ACTS = [torch.profiler.ProfilerActivity.CPU]
KERNEL = "r8b.kernel.frac_whole"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sacd():
    """DSD64 -> 176.4k: three half-band decimators and a decimating conv,
    each a FramedOperator on frac_whole."""
    return Resampler(2822400, 176400, 2.0, 180.15, device="cpu")


def _x(C, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((C, n), generator=g, dtype=torch.float32) * 2 - 1


def _ranges(prof):
    """The host ranges ``r8b.*`` of a profile, as (name, start, end), in
    order of their start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("r8b.")
                   and str(e.device_type()).endswith("CPU")),
                  key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _children(ranges, outer, name):
    return [r for r in ranges if r[0] == name and _inside(r, outer)]


def _copied(monkeypatch):
    """Record, for each ``shifted`` call of operators.py, the bytes its
    result's storage holds when it is not x's (a copy), else 0."""
    seen = []

    def rec(x, start, need, dtype):
        xp = shifted(x, start, need, dtype)
        own = xp.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
        seen.append(xp.untyped_storage().nbytes() if own else 0)
        return xp

    monkeypatch.setattr(operators, "shifted", rec)
    return seen


def _traced(f):
    with torch.profiler.profile(activities=ACTS) as prof:
        trace.reset_counters()
        out = f()
        counts = trace.counters()
    trace.reset_counters()
    return out, _ranges(prof), counts


def test_no_profiler_no_record(sacd):
    """With no profiler the span is the shared no-op object and the
    counter does not move over a oneshot."""
    assert trace.span("r8b.frame") is trace.span("r8b.x")
    trace.reset_counters()
    sacd.oneshot(_x(2, 16384))
    assert trace.counters() == {}


def test_one_span_an_apply_inside_its_executor(sacd, monkeypatch):
    """Each executor of the chain holds one r8b.frame span, which ends
    before its frac_whole span starts: one span for each
    FramedOperator.apply."""
    calls = []
    orig = FramedOperator.apply

    def counted(self, *a, **kw):
        calls.append(type(self).__name__)
        return orig(self, *a, **kw)

    monkeypatch.setattr(FramedOperator, "apply", counted)
    _, r, _ = _traced(lambda: sacd.oneshot(_x(2, 16384)))
    frames = [e for e in r if e[0] == "r8b.frame"]
    assert len(frames) == len(calls) == 4
    root, = [e for e in r if e[0] == "r8b.oneshot"]
    execs = [e for e in r if e[0].startswith("r8b.exec.")]
    assert [e[0] for e in execs] == ["r8b.exec.HBDownExec"] * 3 + [
        "r8b.exec.ConvExec"]
    for ex in execs:
        assert _inside(ex, root)
        frame, = _children(r, ex, "r8b.frame")
        kern, = _children(r, ex, KERNEL)
        assert frame[2] <= kern[1]


def test_bytes_are_the_copies(sacd, monkeypatch):
    """Over a oneshot the counter is the sum of what each framing call
    copied, read off its result's storage: every half-band stage starts
    left of its input (1 - 2*nt), so each pads."""
    seen = _copied(monkeypatch)
    _, _, c = _traced(lambda: sacd.oneshot(_x(3, 16384)))
    assert len(seen) == 4 and all(n > 0 for n in seen[:3])
    assert c["frame.bytes"] == sum(seen)


def test_view_counts_zero(monkeypatch):
    """A call whose input already covers [start, start + need) frames a
    view: one span, and the counter reads 0."""
    seen = _copied(monkeypatch)
    g = np.random.default_rng(5)
    op = FramedOperator(g.standard_normal((40, 16)), torch.float32)
    x = _x(2, 200)
    y, r, c = _traced(lambda: op.apply(x, 8, 4 * 32 + 40, 32, 5))
    assert seen == [0]
    assert c["frame.bytes"] == 0
    assert [n for n, _, _ in r].count("r8b.frame") == 1
    assert y.shape == (2, 5 * 16)


@pytest.mark.parametrize("start,need,dtype", [
    (8, 100, torch.float32),     # a view
    (-5, 100, torch.float32),    # padded left
    (50, 200, torch.float32),    # padded right
    (-5, 300, torch.float32),    # both sides
    (8, 100, torch.float64),     # a cast, no pad
    (-5, 300, torch.float64),    # a cast, then padded
])
def test_shifted_bytes_from_host_integers(start, need, dtype):
    """shifted_bytes is what shifted writes: the cast's C*N elements where
    the dtype changes, and the padded copy's storage where it pads."""
    x = _x(3, 200)
    xp = shifted(x, start, need, dtype)
    own = xp.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    cast = x.numel() * dtype.itemsize if dtype != x.dtype else 0
    padded = start < 0 or start + need > x.shape[1]
    want = cast + (xp.untyped_storage().nbytes() if padded else 0)
    assert own == (padded or cast > 0)
    assert shifted_bytes(x, start, need, dtype) == want


def test_outputs_bit_equal_traced(sacd):
    """The chain gives the same bits with the profiler on and off."""
    x = _x(2, 16384, seed=9)
    off = sacd.oneshot(x)
    on, _, _ = _traced(lambda: sacd.oneshot(x))
    assert on.dtype == off.dtype and torch.equal(on, off)


def _as_on_the_card(monkeypatch):
    """FramedOperator's in-place rule as on the card, on any device."""
    monkeypatch.setattr(operators, "_reads_in_place",
                        lambda x, dtype: x.dtype == dtype
                        and x.stride(1) == 1)


def test_direct_counts_one_an_in_place_call(sacd, monkeypatch):
    """Read in place, each of the chain's four FramedOperator calls counts
    one frame.direct, opens no r8b.frame span, copies nothing (no
    frame.bytes) and hands frac_whole the stage's input itself with its
    window origin; the chain's output is the framed chain's bit for bit
    (the plain version frames inside)."""
    x = _x(2, 16384, seed=4)
    framed = sacd.oneshot(x)
    _as_on_the_card(monkeypatch)
    seen, copied = [], _copied(monkeypatch)
    real = operators.frac_whole

    def rec(xin, *a, **kw):
        seen.append((xin.data_ptr(), kw.get("start", 0)))
        return real(xin, *a, **kw)

    monkeypatch.setattr(operators, "frac_whole", rec)
    y, r, c = _traced(lambda: sacd.oneshot(x))
    assert torch.equal(y, framed)
    assert c["frame.direct"] == len(seen) == 4 and "frame.bytes" not in c
    assert copied == [] and [n for n, _, _ in r].count("r8b.frame") == 0
    assert [s for _, s in seen[:3]] == [-9, -11, -21]


def test_a_cast_still_frames(monkeypatch):
    """Where the input is not in the operator's dtype the call frames a
    cast copy, as before, whatever the device: one r8b.frame span, its
    bytes counted, no frame.direct."""
    _as_on_the_card(monkeypatch)
    seen = _copied(monkeypatch)
    g = np.random.default_rng(6)
    op = FramedOperator(g.standard_normal((40, 16)), torch.float32)
    x = _x(2, 200).double()
    y, r, c = _traced(lambda: op.apply(x, -3, 4 * 32 + 40, 32, 5))
    assert len(seen) == 1 and seen[0] > 0
    assert c["frame.bytes"] == shifted_bytes(x, -3, 4 * 32 + 40,
                                             torch.float32)
    assert "frame.direct" not in c
    assert [n for n, _, _ in r].count("r8b.frame") == 1
    assert y.shape == (2, 5 * 16)
