"""The port's spans and counters (r8brain_torch/utils/trace.py): they
record exactly while a ``torch.profiler`` session records, nest by layer,
count the polynomial stage's cache and the uploads to a card, and leave
every output as it was.

CPU tests run the kernels' plain versions; the one test marked ``cuda``
needs a card.  The file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler, StreamResampler
from r8brain_torch.ops import stages
from r8brain_torch.utils import trace

CPU = dict(device="cpu")
ACTS = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rs96k():
    return Resampler(44100, 96000, 2.0, 180.15, **CPU)


@pytest.fixture(scope="module")
def rs96001():
    return Resampler(44100, 96001, 2.0, 180.15, **CPU)


def _x(C, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((C, n), generator=g, dtype=torch.float32) * 2 - 1


def _blocks(rs, n_blocks, C=2, block_len=2048):
    st = StreamResampler(rs, block_len)
    x = _x(C, n_blocks * st.block)
    return st, [x[:, i * st.block : (i + 1) * st.block]
                for i in range(n_blocks)]


def _run(case, rs96k, rs96001):
    """The outputs of ``case``: a oneshot, or every block of a stream."""
    if case == "oneshot_96k":
        return [rs96k.oneshot(_x(2, 4410))]
    rs = rs96k if case == "stream_96k" else rs96001
    st, blocks = _blocks(rs, 3)
    return [st.process_block_device(b) for b in blocks]


def _ranges(prof):
    """The host ranges ``r8b.*`` of a profile, as (name, start, end)."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("r8b.")
            and str(e.device_type()).endswith("CPU")]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name or (
        name.endswith(".") and r[0].startswith(name))]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _children(ranges, outer, name):
    return [r for r in _named(ranges, name) if _inside(r, outer)]


CASES = ["oneshot_96k", "stream_96k", "stream_96001"]


def test_no_profiler_no_record(rs96k, rs96001):
    """With no profiler, every span is the one shared no-op object and no
    counter moves over a oneshot, stream blocks and the polynomial
    stage's cache."""
    trace.reset_counters()
    assert trace.span("r8b.x") is trace.span("r8b.y")
    assert trace.exec_span(object()) is trace.span("r8b.x")
    assert not isinstance(trace.span("r8b.x"),
                          torch.profiler.record_function)
    for case in CASES:
        _run(case, rs96k, rs96001)
    rs96001.oneshot(_x(2, 4410))
    rs96001.oneshot(_x(2, 4410))
    assert trace.counters() == {}


def test_oneshot_spans_nest(rs96k):
    """A 44.1k -> 96k oneshot: r8b.oneshot holds the fused executor's span,
    which holds frac_whole's."""
    with torch.profiler.profile(activities=ACTS) as prof:
        rs96k.oneshot(_x(2, 4410))
    r = _ranges(prof)
    root, = _named(r, "r8b.oneshot")
    ex, = _children(r, root, "r8b.exec.")
    assert ex[0] == "r8b.exec.FusedUpExec"
    assert len(_children(r, ex, "r8b.kernel.frac_whole")) == 1


def test_period_stream_spans_nest(rs96k):
    """A 44.1k -> 96k stream block after the first: r8b.stream.block holds
    the window copies and the executor, and the executor its framing copy
    and the kernel."""
    st, blocks = _blocks(rs96k, 2)
    st.process_block_device(blocks[0])
    with torch.profiler.profile(activities=ACTS) as prof:
        st.process_block_device(blocks[1])
    r = _ranges(prof)
    root, = _named(r, "r8b.stream.block")
    assert len(_children(r, root, "r8b.stream.window")) == 1
    ex, = _children(r, root, "r8b.exec.")
    assert _children(r, ex, "r8b.kernel.frac_whole")
    assert len(_children(r, ex, "r8b.frame")) == 1
    assert not _children(r, ex, "r8b.stream.window")
    assert {n for n, _, _ in r} == {"r8b.stream.block", "r8b.stream.window",
                                    "r8b.exec.FusedUpExec", "r8b.frame",
                                    "r8b.kernel.frac_whole"}


def test_poly_stream_spans_nest(rs96001):
    """44.1k -> 96001 stream blocks: each block holds the polynomial
    stage's span, which holds its host positions and its operators, and
    the suffix ring's, which holds the suffix's executor; the prefix's
    executor lies outside both."""
    st, blocks = _blocks(rs96001, 4)
    st.process_block_device(blocks[0])
    with torch.profiler.profile(activities=ACTS) as prof:
        for b in blocks[1:]:
            st.process_block_device(b)
    r = _ranges(prof)
    roots = _named(r, "r8b.stream.block")
    assert len(roots) == 3
    for root in roots:
        poly, = _children(r, root, "r8b.stream.poly")
        assert _children(r, poly, "r8b.poly.positions")
        assert len(_children(r, poly, "r8b.poly.operators")) == 1
        assert not _children(r, poly, "r8b.exec.")
        pre = [e for e in _children(r, root, "r8b.exec.")
               if e[2] <= poly[1]]
        assert [e[0] for e in pre] == ["r8b.exec.ConvExec"]
    suffixes = [s for root in roots
                for s in _children(r, root, "r8b.stream.suffix")]
    assert len(suffixes) == 3
    assert any(_children(r, s, "r8b.exec.ConvExec") for s in suffixes)


def test_poly_cache_counts(rs96001):
    """Two 44.1k -> 96001 oneshots of one length: the polynomial stage
    builds its state on the first (a miss) and finds it on the second (a
    hit); nothing is uploaded on the CPU."""
    poly, = [e for e in rs96001.execs if hasattr(e, "_state")]
    poly._state.clear()
    x = _x(2, 4421)
    with torch.profiler.profile(activities=ACTS):
        trace.reset_counters()
        rs96001.oneshot(x)
        first = trace.counters()
        rs96001.oneshot(x)
        both = trace.counters()
    trace.reset_counters()

    def cache(c):
        return {k: v for k, v in c.items() if k.startswith("poly_cache.")}

    assert cache(first) == {"poly_cache.miss": 1}
    assert cache(both) == {"poly_cache.miss": 1, "poly_cache.hit": 1}


def test_fold_counters(rs96k):
    """While a profiler records, a 44.1k -> 96k oneshot counts the folds
    frac_whole walks (``frac_whole.folds``: each column tile's band) and
    those of all of D (``frac_whole.folds_full``) over the same row
    tiles, so their ratio is the fused operator's band share, 126 of 165
    folds a row tile at fold 32; with no profiler neither moves."""
    ex, = rs96k.execs
    trace.reset_counters()
    rs96k.oneshot(_x(2, 4410))
    assert not any(k.startswith("frac_whole.") for k in trace.counters())
    with torch.profiler.profile(activities=ACTS):
        trace.reset_counters()
        rs96k.oneshot(_x(2, 4410))
        c = trace.counters()
    trace.reset_counters()
    walked, full = c["frac_whole.folds"], c["frac_whole.folds_full"]
    assert (ex.op.kc, ex.op.band.folds[ex.op.kc]) == (32, 126)
    assert full == 5 * 33 * (walked // 126) and walked % 126 == 0
    assert walked / full == pytest.approx(126 / 165, abs=0)


@pytest.mark.parametrize("case", CASES)
def test_outputs_bit_equal_traced(case, rs96k, rs96001):
    """The same calls give the same bits with the profiler on and off."""
    off = _run(case, rs96k, rs96001)
    with torch.profiler.profile(activities=ACTS):
        on = _run(case, rs96k, rs96001)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_poly_stream_counts_upload(monkeypatch):
    """On a card, a 44.1k -> 96001 stream block's positions go up through
    ``_to_device`` and h2d_bytes counts their bytes; a block pushed as a
    host array adds its float32 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sent = []
    upload = stages._to_device

    def spy(a, device):
        sent.append(np.ascontiguousarray(a).nbytes)
        return upload(a, device)

    monkeypatch.setattr(stages, "_to_device", spy)
    rs = Resampler(44100, 96001, 2.0, 180.15, device="cuda")
    st = StreamResampler(rs, 8192)
    x = _x(4, 3 * st.block).numpy()
    L = st.block
    st.process_block_device(x[:, :L])
    with torch.profiler.profile(activities=ACTS):
        trace.reset_counters()
        sent.clear()
        st.process_block_device(torch.from_numpy(x[:, L : 2 * L]).cuda())
        block, block_sent = trace.counters(), sum(sent)
        trace.reset_counters()
        sent.clear()
        st.process_block_device(x[:, 2 * L :])
        host, host_sent = trace.counters(), sum(sent)
    trace.reset_counters()
    torch.cuda.synchronize()
    assert block_sent > 0 and block["h2d_bytes"] == block_sent
    assert host["h2d_bytes"] == host_sent + 4 * L * 4
