"""The port's push-mode stream (r8brain_torch/models/stream.py) against its
own oneshot, the reference package's StreamResampler and the float64
oracle, on the CPU (``device="cpu"``: the kernels' plain versions).

Bounds: the block geometry equal to the reference's integer for integer,
and the count emitted by every call; float64 streams within -280 dB of the
port's oneshot (the reference's own test holds -300 dB for rational plans
and -280 for its device paths); float32 rational plans within -135 dB
of the oneshot and bit-equal between k-block and per-block calls;
polynomial plans within -125 dB relative of the oneshot (the reference's
bound for its stream; measured -140.5 "fast", -141.2 "high", 2 channels
of 44.1k -> 96001); the guarantee chain (ozaki engines, df32 carry)
within -150 dB relative of the oracle, the polynomial plans too (the
carry crosses the interpolator's seams); checkpoints resuming bit for
bit, and a reference checkpoint resuming within -280 dB in float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.models.stream import StreamResampler as RefStream
from r8brain_tpu.ops.ozaki import split_operator_host_batched as ref_split
from r8brain_torch import (Resampler, StreamResampler,
                           stream_state_from_reference)
from r8brain_torch.models import stream as stream_mod
from r8brain_torch.ops.stages import ConvExec, FracPolyExec

from .helpers import lcg_uniform, rms_db

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(n, C=2, seed=7, dtype=np.float64):
    return np.stack([lcg_uniform(seed + i, n) for i in range(C)]).astype(
        dtype)


def _np(y):
    return y.double().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y, np.float64)


def _rel_db(y, ref):
    return rms_db(_np(y) - ref) - rms_db(ref)


def _stream(st, x, sizes, out_len):
    """The stream's output for x fed in chunks of ``sizes``, then flushed
    to out_len, and the count each call emitted."""
    outs, pos = [], 0
    for s in sizes:
        outs.append(st.process(x[:, pos : pos + s]))
        pos += s
    assert pos == x.shape[1]
    outs.append(st.flush(out_len))
    return (np.concatenate([_np(o) for o in outs], axis=1),
            [o.shape[-1] for o in outs])


RAGGED = [1, 999, 7000, 3, 12000, 4997, 1000]
EVEN = [5000] * 5 + [1000]

# tests/test_stream.py's plans
CONFIGS = [
    ("up_44k_96k", 44100, 96000, 180.15),
    ("up_44k_48k", 44100, 48000, 180.15),
    ("down_96k_44k", 96000, 44100, 180.15),
    ("x4_up", 44100, 176400, 140.0),
    ("x4_down", 176400, 44100, 140.0),
    ("poly_mid_96001", 44100, 96001, 160.0),
    ("poly_down", 96001, 44100, 140.0),
    ("poly_up_80k", 44100, 80000, 160.0),
    ("poly_mid_hbup", 44100, 352800.3, 140.0),
]

# the plans whose geometry is held to the reference's
GEO = [("44.1k-96k", 44100, 96000), ("96k-44.1k", 96000, 44100),
       ("44.1k-192k", 44100, 192000), ("44.1k-96001", 44100, 96001),
       ("44.1k-352800.3", 44100, 352800.3)]


@pytest.mark.parametrize("cfg", GEO, ids=[g[0] for g in GEO])
def test_geometry_equals_reference(cfg):
    """block, each period stream's L, H, W0 and out_per_block, the
    interpolator's history, and the count every process / flush call
    emits are the reference's, integer for integer."""
    _label, src, dst = cfg
    rs = Resampler(src, dst, 2.0, 180.15, dtype=torch.float64, **CPU)
    ref_rs = RefResampler(src, dst, 2.0, 180.15, 0, dtype="float64")
    st, rst = StreamResampler(rs, 4096), RefStream(ref_rs, 4096)
    assert st.block == rst.block
    for a, b in ((st._core, rst._core),
                 (st._suf, getattr(rst, "_suf", None))):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.L, a.H, a.W0, a.out_per_block, a.p_in, a.p_out) == \
                (b.L, b.H, b.W0, b.out_per_block, b.p_in, b.p_out)
    assert (st._tail is None) == (getattr(rst, "_tail", None) is None)
    if st._tail is not None:
        assert st._tail.H == rst._tail.H
    n = 26000
    x = _x(n)
    out_len = rs.default_out_len(n)
    y, counts = _stream(st, x, RAGGED, out_len)
    ref_counts = []
    pos = 0
    for s in RAGGED:
        ref_counts.append(np.asarray(rst.process(x[:, pos : pos + s]))
                          .shape[-1])
        pos += s
    ref_counts.append(np.asarray(rst.flush(out_len)).shape[-1])
    assert counts == ref_counts


@pytest.mark.parametrize("chunks", ["even", "ragged"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_stream_equals_oneshot_f64(cfg, chunks):
    _label, src, dst, atten = cfg
    rs = Resampler(src, dst, 2.0, atten, dtype=torch.float64, **CPU)
    n = 26000
    x = _x(n)
    out_len = rs.default_out_len(n)
    ref = _np(rs.oneshot(x, out_len))
    y, _ = _stream(StreamResampler(rs, block_len=4096), x,
                   EVEN if chunks == "even" else RAGGED, out_len)
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -280.0


F32_RATIONAL = [("fused", 44100, 96000, {}),
                ("stage_chain", 44100, 96000, dict(fused=False)),
                ("high", 44100, 96000, dict(precision="high")),
                ("down", 96000, 44100, {}),
                ("hb_up", 44100, 192000, {})]


@pytest.mark.parametrize("cfg", F32_RATIONAL,
                         ids=[c[0] for c in F32_RATIONAL])
def test_stream_f32_rational_matches_oneshot(cfg):
    """float32 rational plans stream within -135 dB of the oneshot (the
    stream's blocks frame the same operators at period-aligned offsets)."""
    _label, src, dst, kw = cfg
    rs = Resampler(src, dst, 2.0, 180.15, **kw, **CPU)
    n = 20000
    x = _x(n, seed=9, dtype=np.float32)
    out_len = rs.default_out_len(n)
    ref = _np(rs.oneshot(x, out_len))
    y, _ = _stream(StreamResampler(rs, block_len=4096), x,
                   [3001] * 6 + [1994], out_len)
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -135.0


F32_POLY = [("96001", 44100, 96001, "fast"), ("96001_high", 44100, 96001,
                                              "high"),
            ("down", 96001, 44100, "fast"),
            ("hb_suffix", 44100, 352800.3, "fast")]


@pytest.mark.parametrize("cfg", F32_POLY, ids=[c[0] for c in F32_POLY])
def test_stream_f32_poly_matches_oneshot(cfg):
    """float32 polynomial plans: the stream's interpolator contracts the
    same float64 spline values rounded once as the oneshot's, in other
    windows (its own W and group bases), so the two agree to float32
    rounding: within the reference's -125 dB relative (measured -140.5
    fast, -141.2 high at 44.1k -> 96001); each as close to the float64
    path as the oneshot (within 0.5 dB)."""
    _label, src, dst, prec = cfg
    rs = Resampler(src, dst, 2.0, 180.15, precision=prec, **CPU)
    r64 = Resampler(src, dst, 2.0, 180.15, dtype=torch.float64, **CPU)
    n = 20000
    x = _x(n, seed=21, dtype=np.float32)
    out_len = rs.default_out_len(n)
    one = _np(rs.oneshot(x, out_len))
    y, _ = _stream(StreamResampler(rs, block_len=4096), x,
                   [3001] * 6 + [1994], out_len)
    assert y.shape == one.shape
    assert _rel_db(y, one) < -125.0
    ref = _np(r64.oneshot(x.astype(np.float64), out_len))
    assert rms_db(y - ref) <= rms_db(one - ref) + 0.5


K_BLOCK = [("fused", 44100, 96000, {}),
           ("high", 44100, 96000, dict(precision="high")),
           ("hb_up", 44100, 192000, {}),
           ("guarantee", 44100, 96000, dict(precision="high",
                                           conv_engine="ozaki",
                                           frac_engine="ozaki")),
           ("guarantee_down", 192000, 44100, dict(precision="high",
                                                  conv_engine="ozaki",
                                                  frac_engine="ozaki"))]


@pytest.mark.parametrize("cfg", K_BLOCK, ids=[c[0] for c in K_BLOCK])
def test_k_blocks_bit_equal_per_block(cfg):
    """process_blocks_device over k blocks (the chain once on their
    windows stacked as a [k*C, H+L] batch) gives k successive
    process_block_device calls' output bit for bit on rational plans, the
    stream head included."""
    _label, src, dst, kw = cfg
    rs = Resampler(src, dst, 2.0, 180.15, **kw, **CPU)
    st_a, st_b = StreamResampler(rs, 2048), StreamResampler(rs, 2048)
    L, k = st_a.block, 3
    x = _x(L * k * 2, seed=21, dtype=np.float32)
    ya = torch.cat([st_a.process_block_device(x[:, i : i + L])
                    for i in range(0, x.shape[1], L)], dim=1)
    yb = torch.cat([st_b.process_blocks_device(x[:, i : i + k * L])
                    for i in range(0, x.shape[1], k * L)], dim=1)
    assert torch.equal(ya, yb)
    assert torch.equal(st_a._core.hist, st_b._core.hist)


@pytest.mark.parametrize("kw", [{}, dict(precision="high"),
                                dict(precision="high", conv_engine="ozaki",
                                     frac_engine="ozaki")],
                         ids=["fast", "high", "guarantee"])
def test_span_path(kw):
    """A k-block call past TAIL_SPAN_MIN output groups runs the
    interpolator in spans of TAIL_SPAN_GROUPS groups, each with its own
    window base; its output holds the class against the per-block
    (single-base) stream and the oneshot, and the guarantee config its
    -150 dB against the oracle."""
    rs = Resampler(44100, 96001, 2.0, 180.15, **kw, **CPU)
    st_k, st_1 = StreamResampler(rs, 4096), StreamResampler(rs, 4096)
    L, k = st_k.block, 8
    n = L * k * 2
    x = _x(n, C=2, seed=31, dtype=np.float32)
    yk = torch.cat([st_k.process_blocks_device(x[:, i : i + k * L])
                    for i in range(0, n, k * L)], dim=1)
    y1 = torch.cat([st_1.process_block_device(x[:, i : i + L])
                    for i in range(0, n, L)], dim=1)
    assert st_k._tail.paths == {"spans": 2}, st_k._tail.paths
    assert st_1._tail.paths == {"single": 2 * k}, st_1._tail.paths
    assert yk.shape == y1.shape
    assert _rel_db(yk, _np(y1)) < -135.0
    out_len = rs.default_out_len(n)
    yk = np.concatenate([_np(yk), _np(st_k.flush(out_len))], axis=1)
    one = _np(rs.oneshot(x, out_len))
    assert _rel_db(yk, one) < -125.0
    if kw.get("conv_engine") == "ozaki":
        orc = OracleResampler(44100, 96001, 4096, 2.0, 180.15, 0)
        r = orc.oneshot(x[0].astype(np.float64), out_len)
        assert _rel_db(yk[0], r) < -150.0


GUARANTEE = [(44100, 96000, 180.15), (352800, 44100, 136.1),
             (44100, 96001, 180.15), (44100, 352800.3, 140.0)]


@pytest.mark.parametrize("cfg", GUARANTEE,
                         ids=[f"{s}-{d}" for s, d, _a in GUARANTEE])
def test_guarantee_stream_vs_oracle(cfg):
    """The guarantee chain streams in its class: the df32 carry runs
    within each block's chain and, on polynomial plans, across the
    interpolator's seams (the prefix hands its pair to the interpolator,
    the interpolator its pair to the suffix), so every plan holds -150 dB
    relative to the oracle (measured -151.9; the reference's stream,
    collapsing at those seams, is held to -146)."""
    src, dst, atten = cfg
    n = 16000
    x32 = lcg_uniform(11, n).astype(np.float32)
    rs = Resampler(src, dst, 2.0, atten, precision="high", fused=False,
                   conv_engine="ozaki", frac_engine="ozaki", **CPU)
    assert rs.df_carry
    out_len = rs.default_out_len(n)
    orc = OracleResampler(src, dst, 4096, 2.0, atten, 0).oneshot(
        x32.astype(np.float64), out_len)
    y, _ = _stream(StreamResampler(rs, block_len=4096), x32[None],
                   [3001] * 5 + [995], out_len)
    assert _rel_db(y[0], orc) < -150.0


def test_tail_keeps_precision_class_and_host_values():
    """The stream's interpolator is the parent's own executor (its
    precision class: the spline residual and float64 sum under "high",
    the split slices under the ozaki engine), whose operators it builds
    (``FracPolyExec.operators``); the float64 spline values, evaluated
    where the positions are shipped, are bit-equal to a numpy evaluation,
    and their split slices equal the reference's host split of them."""
    for kw, want in ((dict(), ("fast", False)),
                     (dict(precision="high"), ("high", False)),
                     (dict(precision="high", conv_engine="ozaki",
                           frac_engine="ozaki"), ("high", True))):
        rs = Resampler(44100, 96001, 2.0, 180.15, **kw, **CPU)
        st = StreamResampler(rs, 2048)
        ex = st._tail.exec
        assert ex is rs.execs[1]
        assert (ex.precision, ex.oz_products) == want
    s, f = _spec_positions(ex, 500)
    fr = f * ex.fracs
    fti = np.floor(fr)
    t = fr - fti
    tb = ex.tab.numpy()
    host = tb[fti.astype(np.int64), :, 0] + (
        tb[fti.astype(np.int64), :, 1]
        + tb[fti.astype(np.int64), :, 2] * t[:, None]) * t[:, None]
    dev = ex.values(torch.from_numpy(fti).long(), torch.from_numpy(t))
    assert torch.equal(dev, torch.from_numpy(host))
    from r8brain_torch.ops.ozaki import split_operator_batched
    assert np.array_equal(
        split_operator_batched(dev, axis=-1).float().numpy(),
        np.asarray(ref_split(host, axis=-1), np.float32))


def _spec_positions(ex, count):
    from r8brain_torch.models.lengths import frac_positions
    return frac_positions(ex.spec, 1000, count)


@pytest.mark.parametrize("cfg", [("rational", 44100, 96000, 140.0),
                                 ("poly", 44100, 96001, 140.0),
                                 ("poly_hbup", 44100, 352800.3, 140.0),
                                 ("guarantee_poly", 44100, 96001, 180.15)],
                         ids=lambda c: c[0])
def test_checkpoint_resume_bit_equal(cfg, tmp_path):
    """get_state mid-stream (host arrays, saved with torch.save) and
    set_state in a fresh stream continue bit for bit, through process,
    k-block device calls and flush; a checkpoint of another geometry is
    refused."""
    label, src, dst, atten = cfg
    kw = dict(precision="high", conv_engine="ozaki", frac_engine="ozaki") \
        if label.startswith("guarantee") else {}
    rs = Resampler(src, dst, 2.0, atten, **kw, **CPU)
    st = StreamResampler(rs, block_len=2048)
    L = st.block
    x = _x(L * 9 + 500, seed=13, dtype=np.float32)
    st.process(x[:, : 3 * L + 300])
    st.process(x[:, 3 * L + 300 : 4 * L])
    st.process_blocks_device(x[:, 4 * L : 6 * L])
    ckpt = st.get_state()
    assert all(isinstance(v, np.ndarray) for v in _arrays(ckpt))
    torch.save(ckpt, tmp_path / "st.pt")
    a = [st.process_blocks_device(x[:, 6 * L : 8 * L]),
         st.process(x[:, 8 * L :]), st.flush()]
    st2 = StreamResampler(rs, block_len=2048)
    st2.process(x[:, :1])  # some other state, then restore
    st2.set_state(torch.load(tmp_path / "st.pt", weights_only=False))
    b = [st2.process_blocks_device(x[:, 6 * L : 8 * L]),
         st2.process(x[:, 8 * L :]), st2.flush()]
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    other = StreamResampler(rs, block_len=4096)
    with pytest.raises(ValueError, match="geometry"):
        other.set_state(ckpt)


def _arrays(st):
    for v in st.values():
        if isinstance(v, dict):
            yield from _arrays(v)
        elif v is not None and not isinstance(v, (int, bool)):
            yield v


@pytest.mark.parametrize("cfg", [("rational", 44100, 96000, "host"),
                                 ("poly", 44100, 96001, "host"),
                                 ("poly_hbup", 44100, 352800.3, "device")],
                         ids=lambda c: c[0])
def test_reference_checkpoint_resumes(cfg):
    """A reference-package stream checkpoint (float64), carried across by
    stream_state_from_reference, resumes in the port's stream: the
    reference's first half and the port's second half together are the
    port's oneshot within -280 dB.  The "device" case fills the
    reference's device re-blocker, whose fill joins the suffix pending."""
    label, src, dst, path = cfg
    ref_rs = RefResampler(src, dst, 2.0, 160.0, 0, dtype="float64")
    rs = Resampler(src, dst, 2.0, 160.0, dtype=torch.float64, **CPU)
    rst, st = RefStream(ref_rs, 2048), StreamResampler(rs, 2048)
    L = st.block
    n = 8 * L + 777
    x = _x(n, seed=17)
    if path == "device":
        y1 = [np.asarray(rst.process_block_device(jnp.asarray(
            x[:, i : i + L])), np.float64) for i in range(0, 4 * L, L)]
        ref_state = rst.get_state()
        assert ref_state["suf"]["dev_buf"] is not None
        h = 4 * L
    else:
        h = 4 * L + 1234
        y1 = [np.asarray(rst.process(x[:, :h]))]
        ref_state = rst.get_state()
    st.set_state(stream_state_from_reference(ref_state, st, rst))
    out_len = rs.default_out_len(n)
    y = np.concatenate(y1 + [_np(st.process(x[:, h:])),
                             _np(st.flush(out_len))], axis=1)
    ref = _np(rs.oneshot(x, out_len))
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -280.0


def test_reference_checkpoint_of_other_geometry_refused():
    ref_rs = RefResampler(44100, 96001, 2.0, 140.0, 0, dtype="float64")
    rs = Resampler(44100, 96001, 2.0, 140.0, dtype=torch.float64, **CPU)
    rst = RefStream(ref_rs, 2048)
    rst.process(_x(7000))  # three of its blocks: not whole blocks here
    st = StreamResampler(rs, 4096)
    with pytest.raises(ValueError, match="geometry"):
        stream_state_from_reference(rst.get_state(), st, rst)
    with pytest.raises(ValueError, match="does not fit"):
        stream_state_from_reference(rst.get_state(), st)


def test_ring_grows_for_restored_pending_and_asserts_capacity():
    """The suffix ring checks its fill, a restored pending and the call's
    outputs against its capacity, and grows first (the reference checks
    the outputs alone); a push past the capacity asserts."""
    rs = Resampler(44100, 96001, 2.0, 140.0, dtype=torch.float64, **CPU)
    st = StreamResampler(rs, 2048)
    L = st.block
    x = _x(12 * L, seed=5)
    y_all = torch.cat([st.process_block_device(x[:, i : i + L])
                       for i in range(0, 12 * L, L)], dim=1)
    st2 = StreamResampler(rs, 2048)
    y2 = [st2.process_block_device(x[:, i : i + L])
          for i in range(0, 4 * L, L)]
    state = st2.get_state()
    pend = state["suf"]["pending"]
    assert pend is not None and pend.shape[1] > 0
    # the ring's content comes back as a pending the first push carries
    st3 = StreamResampler(rs, 2048)
    st3.set_state(state)
    y3 = [st3.process_block_device(x[:, 4 * L : 5 * L])]
    cap = st3._ring.cap
    y3.append(st3.process_blocks_device(x[:, 5 * L : 12 * L]))
    assert st3._ring.cap > cap  # grown before the 7-block push
    assert torch.equal(torch.cat(y2 + y3, dim=1), y_all)
    ring = st3._ring
    with pytest.raises(AssertionError, match="overflow"):
        ring.push(torch.zeros((2, ring.cap - ring.fill + 1),
                              dtype=torch.float64))


def test_span_base_assert_fires(monkeypatch):
    """Every span base is checked on the host before any slice: a base
    left of the padded window, or a span past its end, asserts (a negative
    PyTorch slice start would wrap around silently)."""
    with pytest.raises(AssertionError, match="left of"):
        stream_mod._check_span_bases(np.array([5, -1]), 100, 1000)
    with pytest.raises(AssertionError, match="past"):
        stream_mod._check_span_bases(np.array([0, 901]), 100, 1000)
    stream_mod._check_span_bases(np.array([0, 900]), 100, 1000)
    # a margin too small for the groups' bases: the stream refuses
    monkeypatch.setattr(stream_mod, "TAIL_MARGIN", -10**6)
    rs = Resampler(44100, 96001, 2.0, 140.0, **CPU)
    st = StreamResampler(rs, 2048)
    with pytest.raises(AssertionError, match="left of"):
        st.process_block_device(_x(st.block, dtype=np.float32))


def test_guards():
    """Channel count, whole blocks only, no device call with a partial
    process() chunk pending, no device call on a passthrough plan."""
    rs = Resampler(44100, 96000, 2.0, 140.0, **CPU)
    st = StreamResampler(rs, 2048)
    L = st.block
    xb = _x(3 * L, dtype=np.float32)
    outs = [st.process_block_device(xb[:, i : i + L])
            for i in range(0, 3 * L, L)]
    tail = st.flush(rs.default_out_len(3 * L))  # channels recorded
    y = torch.cat(outs + [tail], dim=1)
    ref = rs.oneshot(xb, rs.default_out_len(3 * L))
    assert y.shape == ref.shape
    with pytest.raises(ValueError, match="channels"):
        st.process(np.zeros((3, 10), np.float32))
    st2 = StreamResampler(rs, 2048)
    with pytest.raises(ValueError):
        st2.process_block_device(torch.zeros(L))
    with pytest.raises(ValueError):
        st2.process_blocks_device(torch.zeros((2, L + 1)))
    st2.process(xb[:, :100])  # partial chunk pending
    with pytest.raises(RuntimeError):
        st2.process_block_device(torch.zeros((2, L)))
    with pytest.raises(RuntimeError):
        st2.process_blocks_device(torch.zeros((2, 2 * L)))
    same = StreamResampler(Resampler(48000, 48000, **CPU), 1000)
    with pytest.raises(NotImplementedError):
        same.process_block_device(torch.zeros((1, same.block)))
    y = same.process(np.arange(2500.0, dtype=np.float32))
    assert torch.equal(y, torch.arange(2000.0))


def test_clear_and_tensor_io():
    """clear() is a full reset; numpy or tensor input, 1-D or 2-D, gives
    tensors on the stream's device in its dtype."""
    rs = Resampler(44100, 96000, 2.0, 140.0, dtype=torch.float64, **CPU)
    st = StreamResampler(rs, block_len=2048)
    x = lcg_uniform(3, 9000)
    out_len = rs.default_out_len(9000)
    y1 = torch.cat([st.process(x), st.flush(out_len)])
    assert y1.dim() == 1 and y1.dtype == torch.float64
    st.clear()
    y2 = torch.cat([st.process(torch.from_numpy(x)), st.flush(out_len)])
    assert torch.equal(y1, y2)
    assert rms_db(_np(y1) - _np(rs.oneshot(x, out_len))) < -280.0


def test_oneshot_max_chunk():
    """oneshot(max_chunk=...) over many chunks is the stream's output bit
    for bit and within -250 dB of the whole-array oneshot in float64,
    for a shorter and a longer out_len and a 1-D input too."""
    for src, dst in ((44100, 96000), (96000, 44100), (44100, 96001)):
        rs = Resampler(src, dst, 2.0, 150.0, dtype=torch.float64, **CPU)
        n = 30000
        x = _x(n, seed=11)
        out_len = rs.default_out_len(n)
        y_whole = rs.oneshot(x, out_len)
        y_chunk = rs.oneshot(x, out_len, max_chunk=4096)
        assert y_chunk.shape == y_whole.shape
        assert rms_db(_np(y_chunk) - _np(y_whole)) < -250.0
        y_st, _ = _stream(StreamResampler(rs, 4096), x,
                          [4096] * 7 + [1328], out_len)
        assert np.array_equal(_np(y_chunk), y_st)
        # a shorter and a longer out_len, and a 1-D input
        y_short = rs.oneshot(x, 1000, max_chunk=4096)
        assert torch.equal(y_short, y_chunk[:, :1000])
        y_long = rs.oneshot(x[0], out_len + 500, max_chunk=4096)
        assert y_long.shape == (out_len + 500,)
        assert torch.equal(y_long[:out_len], y_chunk[0])


def test_tiny_and_short_blocks():
    """A block_len below the chain's warmup grows (no shifted output);
    below its history span H the first block grows to carry the full
    real history (the reference's round-5 fuzzer find, -83 dB before)."""
    rs = Resampler(44100, 96000, 2.0, 180.15, dtype=torch.float64, **CPU)
    n = 20000
    x = _x(n, C=1, seed=13)
    out_len = rs.default_out_len(n)
    y, _ = _stream(StreamResampler(rs, block_len=256), x, [n], out_len)
    assert rms_db(y - _np(rs.oneshot(x, out_len))) < -280.0
    from r8brain_torch.models.plan import make_plan
    src, dst, tb, atten = 401310.0, 44100.0, 4.034, 193.96
    plan = make_plan(src, dst, tb, atten, 0)
    n = 5000
    x32 = lcg_uniform(7005, n).astype(np.float32)
    out_len = int(np.floor(n * dst / src))
    orc = OracleResampler(src, dst, 4096, tb, atten, 0).oneshot(
        x32.astype(np.float64), out_len)
    rs = Resampler(src, dst, tb, atten, plan=plan, **CPU)
    for block in (2048, 1024):
        st = StreamResampler(rs, block_len=block)
        assert st._core.L >= st._core.H
        y, _ = _stream(st, x32[None], [1777, 1777, 1446], out_len)
        assert _rel_db(y[0], orc) < -125.0, block


def test_engines_propagate_to_sub_chains():
    """A split chain's pieces take the parent's executors when it runs
    one a stage (a forced conv engine included), and a fused parent's
    whole plan streams through its fused executor."""
    rs = Resampler(44100, 96001, 2.0, 140.0, conv_engine="toeplitz_sym",
                   **CPU)
    st = StreamResampler(rs, 2048)
    convs = [e for e in st._core.execs + st._suf.execs
             if isinstance(e, ConvExec)]
    assert convs and all(c.engine == "toeplitz_sym" for c in convs)
    assert st._core.execs[0] is rs.execs[0]
    assert isinstance(st._tail.exec, FracPolyExec)
    rs = Resampler(44100, 96000, 2.0, 140.0, **CPU)
    assert StreamResampler(rs, 2048)._core.execs == list(rs.execs)


def test_stream_matches_reference_stream():
    """The port's float64 stream and the reference's emit the same
    samples (-280 dB), device block calls included."""
    ref_rs = RefResampler(44100, 96001, 2.0, 160.0, 0, dtype="float64")
    rs = Resampler(44100, 96001, 2.0, 160.0, dtype=torch.float64, **CPU)
    rst, st = RefStream(ref_rs, 2048), StreamResampler(rs, 2048)
    L = st.block
    x = _x(6 * L, seed=41)
    a = [np.asarray(rst.process_blocks_device(jnp.asarray(x[:, :3 * L]))),
         np.asarray(rst.process(x[:, 3 * L :]))]
    b = [_np(st.process_blocks_device(x[:, : 3 * L])),
         _np(st.process(x[:, 3 * L :]))]
    for u, v in zip(a, b):
        assert u.shape == v.shape
        assert rms_db(u - v) < -280.0


def test_random_poly_ratios():
    """Irrational-ish ratios with random chunking stream to the oneshot
    (float64): prefix periods, host-timed interpolator, suffix ring."""
    rng = np.random.default_rng(77)
    for trial in range(6):
        dst = float(int(44100 * (1.0 + 3.0 * rng.random())) * 7 + 1)
        rs = Resampler(44100.0, dst, 2.0, 140.0, dtype=torch.float64, **CPU)
        st = StreamResampler(rs, block_len=int(rng.integers(1024, 4096)))
        n = 16000
        x = lcg_uniform(trial, n)[None]
        out_len = rs.default_out_len(n)
        ref = _np(rs.oneshot(x, out_len))
        sizes = []
        while sum(sizes) < n:
            sizes.append(min(int(rng.integers(1, 5000)), n - sum(sizes)))
        y, _ = _stream(st, x, sizes, out_len)
        assert y.shape == ref.shape, (trial, dst)
        assert rms_db(y - ref) < -280.0, (trial, dst)
