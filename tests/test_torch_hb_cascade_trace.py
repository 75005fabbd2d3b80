"""The half-band up cascade's span and counter (ops/hb_cascade.py,
through r8brain_torch/utils/trace.py): ``r8b.hb.edge`` around
``HBUpCascadeExec``'s float64 edge step in ``apply`` (the shifted float64
copy of the first P inputs, the product with the edge matrix, the cast
and the in-place add; the whole call where every output lies in the
edge), and ``hb_cascade.out_bytes``, the bytes the cascade's
``frac_whole`` call writes, n_blocks * 128 * U * rows * itemsize, from
host integers (the columns past M that ``apply`` trims included).  They
record exactly while a ``torch.profiler`` session records, nest inside
the executor's ``r8b.exec.HBUpCascadeExec`` span, and leave every output
as it was.

The plan is PCM -> DSD64 (44.1 kHz -> 2.8224 MHz): a conv stage, then
five half-band upsamplers (nt 11, 6, 5, 4, 3) as one cascade at U = 32,
edge P = 21, E = 135.  CPU tests run ``frac_whole``'s plain version.  The
file imports nothing of JAX.
"""

import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.models.resampler import run_chain
from r8brain_torch.ops import hb_cascade, operators
from r8brain_torch.ops.hb_cascade import HBUpCascadeExec
from r8brain_torch.ops.stages import HB_BLOCK
from r8brain_torch.utils import trace

ACTS = [torch.profiler.ProfilerActivity.CPU]
EDGE = "r8b.hb.edge"
EXEC = "r8b.exec.HBUpCascadeExec"
KERNEL = "r8b.kernel.frac_whole"
COUNTER = "hb_cascade.out_bytes"
#: Cascade inputs whose outputs all lie in the edge (M = 130 <= E = 135),
#: and just past it (M = 194 > E).
ALL_EDGE, PAST_EDGE = 20, 22


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dsd():
    """44.1k -> DSD64: ConvExec, then the five-stage cascade."""
    return Resampler(44100, 2822400, 2.0, 180.15, device="cpu")


def _casc(rs) -> HBUpCascadeExec:
    ex, = [e for e in rs.execs if isinstance(e, HBUpCascadeExec)]
    return ex


def _x(C, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((C, n), generator=g, dtype=torch.float32) * 2 - 1


def _events(prof, prefix=""):
    """The host ranges of a profile whose names start with ``prefix``, as
    (name, start, end), in order of their start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)
                   and str(e.device_type()).endswith("CPU")),
                  key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _traced(f):
    with torch.profiler.profile(activities=ACTS) as prof:
        trace.reset_counters()
        out = f()
        counts = trace.counters()
    trace.reset_counters()
    return out, prof, counts


def _out_bytes(ex, C, n_in, itemsize=4) -> int:
    """The host formula: every block's U * 128 columns of every row."""
    M = ex.out_len(n_in)
    n_blocks = -(-(-(-M // ex.U)) // HB_BLOCK)
    return n_blocks * HB_BLOCK * ex.U * C * itemsize


def test_geometry(dsd):
    """The plan the tests rely on: the conv stage, then one cascade of
    five half-band upsamplers at U = 32 with a 21 x 135 edge."""
    ex = _casc(dsd)
    assert [type(e).__name__ for e in dsd.execs] == ["ConvExec",
                                                     "HBUpCascadeExec"]
    assert [s.hb.num_taps for s in ex.specs] == [11, 6, 5, 4, 3]
    assert (ex.U, ex.P, ex.E) == (32, 21, 135)
    assert ex.out_len(ALL_EDGE) <= ex.E < ex.out_len(PAST_EDGE)


def test_no_profiler_no_record(dsd):
    """With no profiler the span is the shared no-op object and nothing
    is counted over a oneshot or an all-edge call."""
    assert trace.span(EDGE) is trace.span("r8b.x")
    trace.reset_counters()
    dsd.oneshot(_x(2, 4096))
    run_chain([_casc(dsd)], _x(2, ALL_EDGE))
    assert trace.counters() == {}


def test_one_edge_span_a_call_inside_the_executor(dsd):
    """A oneshot opens one r8b.hb.edge, inside the cascade's executor
    span and after its frac_whole call; the conv's executor holds none."""
    _, prof, _ = _traced(lambda: dsd.oneshot(_x(2, 4096)))
    r = _events(prof, "r8b.")
    edge, = [e for e in r if e[0] == EDGE]
    casc, = [e for e in r if e[0] == EXEC]
    conv, = [e for e in r if e[0] == "r8b.exec.ConvExec"]
    kern, = [e for e in r if e[0] == KERNEL and _inside(e, casc)]
    assert _inside(edge, casc) and not _inside(edge, conv)
    assert kern[2] <= edge[1]


@pytest.mark.parametrize("n", [ALL_EDGE, PAST_EDGE, 300])
def test_one_edge_span_at_every_length(dsd, n):
    """The cascade alone through run_chain: one edge span a call, inside
    its executor span, whether every output lies in the edge (M <= E,
    the dense response, no frac_whole call) or not."""
    ex = _casc(dsd)
    _, prof, c = _traced(lambda: run_chain([ex], _x(3, n)))
    r = _events(prof, "r8b.")
    edge, = [e for e in r if e[0] == EDGE]
    casc, = [e for e in r if e[0] == EXEC]
    assert _inside(edge, casc)
    kernels = [e for e in r if e[0] == KERNEL]
    if ex.out_len(n) <= ex.E:
        assert kernels == [] and COUNTER not in c
    else:
        assert len(kernels) == 1 and c[COUNTER] == _out_bytes(ex, 3, n)


def test_edge_span_holds_the_edge_work(dsd):
    """Inside the executor span and outside its framing and frac_whole
    (whose plain version multiplies on the CPU), the float64 cast, the
    product and the in-place add all run inside r8b.hb.edge."""
    ex = _casc(dsd)
    _, prof, _ = _traced(lambda: run_chain([ex], _x(2, 300)))
    r = _events(prof)
    edge, = [e for e in r if e[0] == EDGE]
    casc, = [e for e in r if e[0] == EXEC]
    other = [e for e in r if e[0] in (KERNEL, "r8b.frame")]
    ops = [e for e in r if e[0].startswith("aten::") and _inside(e, casc)
           and not any(_inside(e, o) for o in other)]
    for name in ("aten::matmul", "aten::add_", "aten::to"):
        hits = [e for e in ops if e[0] == name]
        assert hits and all(_inside(e, edge) for e in hits), name


@pytest.mark.parametrize("C,n", [(2, 4096), (3, 1000), (1, 44100)])
def test_out_bytes_is_the_host_formula(dsd, C, n, monkeypatch):
    """Over a oneshot the counter is n_blocks * 128 * U * rows * 4, what
    the cascade's frac_whole call returns, columns past M included."""
    ex = _casc(dsd)
    wrote, real = [], operators.frac_whole
    n_casc, fwd = [], HBUpCascadeExec.forward

    def rec(xin, *a, **kw):
        y = real(xin, *a, **kw)
        wrote.append(y.numel() * y.element_size())
        return y

    def casc(self, x):
        n_casc.append(x.shape[1])
        return fwd(self, x)

    monkeypatch.setattr(operators, "frac_whole", rec)
    monkeypatch.setattr(HBUpCascadeExec, "forward", casc)
    y, _, c = _traced(lambda: dsd.oneshot(_x(C, n)))
    assert len(wrote) == 2 and len(n_casc) == 1  # the conv's, the cascade's
    assert c[COUNTER] == wrote[1] == _out_bytes(ex, C, n_casc[0])
    assert wrote[1] > C * y.shape[1] * 4


def test_out_bytes_counts_each_call(dsd):
    """Two oneshots count twice one; the counter reads float64 bytes in a
    float64 cascade."""
    x = _x(2, 4096)
    _, _, one = _traced(lambda: dsd.oneshot(x))
    _, _, two = _traced(lambda: (dsd.oneshot(x), dsd.oneshot(x)))
    assert two[COUNTER] == 2 * one[COUNTER]
    ex64 = HBUpCascadeExec(_casc(dsd).specs, torch.float64)
    _, _, c = _traced(lambda: run_chain([ex64], _x(2, 300).double()))
    assert c[COUNTER] == _out_bytes(ex64, 2, 300, itemsize=8)


def test_counter_as_on_the_card(dsd, monkeypatch):
    """With frac_whole reading its input in place (the card's rule), the
    counter and the span are as they were, and so is the output."""
    x = _x(2, 4096, seed=8)
    framed, _, c0 = _traced(lambda: dsd.oneshot(x))
    monkeypatch.setattr(operators, "_reads_in_place",
                        lambda x, dtype: x.dtype == dtype
                        and x.stride(1) == 1)
    y, prof, c1 = _traced(lambda: dsd.oneshot(x))
    assert torch.equal(y, framed)
    assert c1[COUNTER] == c0[COUNTER] and c1["frame.direct"] == 2
    assert [e[0] for e in _events(prof, "r8b.")].count(EDGE) == 1


@pytest.mark.parametrize("n", [ALL_EDGE, PAST_EDGE, 4096])
def test_outputs_bit_equal_traced(dsd, n):
    """The cascade, alone and behind the conv, gives the same bits with
    the profiler on and off."""
    ex, x = _casc(dsd), _x(2, n, seed=9)
    off = run_chain([ex], x)
    on, _, _ = _traced(lambda: run_chain([ex], x))
    assert on.dtype == off.dtype and torch.equal(on, off)
    off = dsd.oneshot(x)
    on, _, _ = _traced(lambda: dsd.oneshot(x))
    assert torch.equal(on, off)


def test_edge_is_the_only_span_the_module_opens(monkeypatch):
    """hb_cascade opens r8b.hb.edge and counts hb_cascade.out_bytes
    through utils/trace.py and through nothing else."""
    names = []
    monkeypatch.setattr(hb_cascade, "span",
                        lambda name: names.append(name) or trace.span(name))
    rs = Resampler(44100, 2822400, 2.0, 180.15, device="cpu")
    rs.oneshot(_x(1, 2048))
    assert names == [EDGE]


@pytest.mark.cuda
def test_card_oneshot_traced(monkeypatch):
    """On a card, at the DSD encoding cell's row length (64 rows x 0.5 s
    of 44.1 kHz): the traced oneshot gives the untraced one's bits, opens
    one edge span inside the cascade's executor span, counts the host
    formula's bytes, and both frac_whole calls read in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rs = Resampler(44100, 2822400, 2.0, 180.15, device="cuda")
    n_casc, fwd = [], HBUpCascadeExec.forward

    def casc(self, x):
        n_casc.append(x.shape[1])
        return fwd(self, x)

    monkeypatch.setattr(HBUpCascadeExec, "forward", casc)
    x = _x(64, 22050).cuda()
    off = rs.oneshot(x)
    on, prof, c = _traced(lambda: rs.oneshot(x))
    torch.cuda.synchronize()
    assert torch.equal(on, off)
    r = _events(prof, "r8b.")
    edge, = [e for e in r if e[0] == EDGE]
    casc_span, = [e for e in r if e[0] == EXEC]
    assert _inside(edge, casc_span)
    assert c["frame.direct"] == 2 and "frame.bytes" not in c
    assert c[COUNTER] == _out_bytes(_casc(rs), 64, n_casc[-1])
