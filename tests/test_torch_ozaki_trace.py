"""The guarantee chain's spans and counter (r8brain_torch/utils/trace.py):
``r8b.ozaki.prep`` around each ozaki executor's framing copies and scales,
``r8b.ozaki.carry`` around the df32 carry's torch work (the seam
residual's framing before the kernel that takes it, and a pair's
collapse before a stage without a carry path), and the counter
``ozaki_framed.macs``.  They record exactly while a ``torch.profiler``
session records, nest inside their executor's span beside the kernel's,
and leave every output as it was.

CPU tests run ``ozaki_framed``'s plain version.  The file imports nothing
of JAX.
"""

import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.ops.pallas_ozaki import ozaki_framed
from r8brain_torch.ops.ozaki import channel_scale, split_operator_host
from r8brain_torch.utils import trace

ACTS = [torch.profiler.ProfilerActivity.CPU]
OZAKI = dict(precision="high", conv_engine="ozaki", frac_engine="ozaki",
             device="cpu")
KERNEL = "r8b.kernel.ozaki_framed"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def guarantee():
    """The guarantee chain at 44.1k -> 96k, the df32 carry on."""
    rs = Resampler(44100, 96000, 2.0, 180.15, **OZAKI)
    assert rs.df_carry
    return rs


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


def _traced(rs, x):
    with torch.profiler.profile(activities=ACTS) as prof:
        trace.reset_counters()
        y = rs.oneshot(x)
        counts = trace.counters()
    trace.reset_counters()
    return y, _ranges(prof), counts


def test_no_profiler_no_record(guarantee):
    """With no profiler the new spans are the shared no-op object and the
    counter does not move over a guarantee oneshot."""
    assert trace.span("r8b.ozaki.prep") is trace.span("r8b.ozaki.carry")
    trace.reset_counters()
    guarantee.oneshot(_x(2, 4410))
    assert trace.counters() == {}


def test_spans_nest_by_executor(guarantee):
    """r8b.oneshot holds the two ozaki executors.  Each holds one framing
    span and then one kernel span; the conv stage (which emits the pair)
    opens no carry span, the frac stage (the last, which takes it) opens
    one: the seam residual's framing, after its prep and before its
    kernel, which takes the residual; nothing of the carry follows the
    kernel."""
    _, r, _ = _traced(guarantee, _x(2, 4410))
    root, = [e for e in r if e[0] == "r8b.oneshot"]
    conv, = _children(r, root, "r8b.exec.ConvExec")
    frac, = _children(r, root, "r8b.exec.FracWholeExec")
    for ex in (conv, frac):
        prep, = _children(r, ex, "r8b.ozaki.prep")
        kern, = _children(r, ex, KERNEL)
        assert prep[2] <= kern[1]
    assert not _children(r, conv, "r8b.ozaki.carry")
    prep, = _children(r, frac, "r8b.ozaki.prep")
    kern, = _children(r, frac, KERNEL)
    carry, = _children(r, frac, "r8b.ozaki.carry")
    assert prep[2] <= carry[1] and carry[2] <= kern[1]
    assert {n for n, _, _ in r} == {
        "r8b.oneshot", "r8b.exec.ConvExec", "r8b.exec.FracWholeExec",
        "r8b.ozaki.prep", "r8b.ozaki.carry", KERNEL}


def test_carry_off_opens_no_carry_span(monkeypatch):
    """With the carry off (R8BT_DF_CARRY=0 when the Resampler is built)
    the chain frames and launches as before and opens no carry span."""
    monkeypatch.setenv("R8BT_DF_CARRY", "0")
    rs = Resampler(44100, 96000, 2.0, 180.15, **OZAKI)
    assert not rs.df_carry
    _, r, _ = _traced(rs, _x(2, 4410))
    names = [n for n, _, _ in r]
    assert names.count("r8b.ozaki.prep") == 2 and names.count(KERNEL) == 2
    assert "r8b.ozaki.carry" not in names


def test_collapse_before_a_stage_without_carry_path():
    """An ozaki conv stage before an im2col frac stage: the frac stage has
    no carry path, so the pair collapses in torch, inside a carry span
    of the frac executor."""
    rs = Resampler(44100, 96000, 2.0, 180.15, precision="high",
                   conv_engine="ozaki", frac_engine="im2col", device="cpu")
    assert rs.df_carry
    _, r, _ = _traced(rs, _x(2, 4410))
    frac, = [e for e in r if e[0] == "r8b.exec.FracWholeExec"]
    assert len(_children(r, frac, "r8b.ozaki.carry")) == 1
    assert not _children(r, frac, "r8b.ozaki.prep")


def test_half_band_frames_in_prep():
    """44.1k -> 176.4k's guarantee chain, a conv and a half-band stage:
    the half-band executor frames its signal inside its own prep span too,
    and the seam residual (it is the last stage) inside one carry span
    before its kernel."""
    rs = Resampler(44100, 176400, 2.0, 180.15, **OZAKI)
    _, r, c = _traced(rs, _x(2, 2205))
    hb, = [e for e in r if e[0] == "r8b.exec.HBUpExec"]
    prep, = _children(r, hb, "r8b.ozaki.prep")
    carry, = _children(r, hb, "r8b.ozaki.carry")
    kern, = _children(r, hb, KERNEL)
    assert prep[2] <= carry[1] and carry[2] <= kern[1]
    assert c["ozaki_framed.macs"] > 0


def test_macs_counted_from_geometry(guarantee):
    """``ozaki_framed.macs`` over a oneshot is the sum over its two
    launches of rows x n_blocks x L_f x Kcols, each executor's geometry
    at the logical counts it ran."""
    C, N = 3, 4410
    conv, frac = guarantee.execs
    # the oneshot's zero flush: the chain runs on T >= N samples
    T = max(N, guarantee.in_len_for_out(guarantee.default_out_len(N)))
    M1 = conv.out_len(T)
    M2 = frac.out_len(M1)
    want = 0
    for ex, M in ((conv, M1), (frac, M2)):
        L_f, _hop, Kcols, n_blocks = ex.geometry(M)
        want += C * n_blocks * L_f * Kcols
    _, _, c = _traced(guarantee, _x(C, N))
    assert c == {"ozaki_framed.macs": want}


@pytest.mark.parametrize("x_lo,pair", [(False, False), (True, True)])
def test_macs_of_one_call(x_lo, pair):
    """One call adds C x n_blocks x L_f x Kcols, whatever its variant."""
    g = torch.Generator().manual_seed(1)
    L_f, hop, Kcols, n_blocks, C = 40, 16, 24, 5, 3
    T = torch.randn((L_f, Kcols), generator=g, dtype=torch.float64)
    parts, _ = split_operator_host(T.numpy())
    xp = torch.rand((C, (n_blocks - 1) * hop + L_f), generator=g) - 0.5
    xl = (xp * 2**-9).to(torch.bfloat16) if x_lo else None
    with torch.profiler.profile(activities=ACTS):
        trace.reset_counters()
        ozaki_framed(xp, channel_scale(xp), parts, L_f, hop, Kcols,
                     n_blocks, x_lo=xl, emit_pair=pair)
        c = trace.counters()
    trace.reset_counters()
    assert c == {"ozaki_framed.macs": C * n_blocks * L_f * Kcols}


def test_outputs_bit_equal_traced(guarantee):
    """The guarantee chain gives the same bits with the profiler on and
    off."""
    x = _x(2, 4410, seed=9)
    off = guarantee.oneshot(x)
    on, _, _ = _traced(guarantee, x)
    assert on.dtype == off.dtype and torch.equal(on, off)
