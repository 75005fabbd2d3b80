"""The port's sharded push-mode stream (r8brain_torch/parallel/
stream_sharding.py) against its own oneshot and the reference package's
ShardedStreamResampler, on the CPU over in-process meshes.

Bounds, each the reference's own test's (tests/test_sharding_stream.py):
the geometry and the polynomial program's per-call positions, offsets and
counts equal to the reference's; float64 streams within -280 dB of the
oneshot; float32 fast / high, fused and unfused, within -125 dB; the
guarantee chain's polynomial stream within -141 dB relative of the port's
float64 path; checkpoints resuming bit for bit; a reference checkpoint
resuming in the port within -260 dB in float64 (the sharded oneshot's
bound against the reference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.parallel.stream_sharding import \
    ShardedStreamResampler as RefShardedStream
from r8brain_torch import (Mesh, Resampler, ShardedStreamResampler,
                           sharded_stream_state_from_reference)

from .helpers import rms_db

CPU = dict(device="cpu")
MESHES = {"ch2t4": ((2, 4), ("ch", "t")), "t8": ((8,), ("t",)),
          "ch8": ((8,), ("ch",))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RS = {}


def _rs(src, dst, atten=180.15, dtype=torch.float64, **kw):
    key = (src, dst, atten, dtype, tuple(sorted(kw.items())))
    if key not in _RS:
        _RS[key] = Resampler(src, dst, 2.0, atten, 0, dtype=dtype, **CPU,
                             **kw)
    return _RS[key]


def _mesh(name):
    return Mesh(*MESHES[name])


def _jax_mesh(name):
    shape, names = MESHES[name]
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return JaxMesh(devs, names)


def _np(y):
    return y.double().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y, np.float64)


def _stream_all(ss, x, out_len):
    n_blocks = x.shape[1] // ss.block
    outs = [_np(ss.process_block(x[:, i * ss.block : (i + 1) * ss.block]))
            for i in range(n_blocks)]
    outs.append(_np(ss.flush(out_len)))
    y = np.concatenate(outs, axis=1)
    assert y.shape[1] == out_len
    return y


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", [(44100, 96000), (96000, 44100)],
                         ids=["up_44k_96k", "down_hb_chain"])
def test_sharded_stream_f64_exact(cfg, mesh):
    rs = _rs(*cfg)
    ss = ShardedStreamResampler(rs, _mesh(mesh), seg_len=2048)
    x = np.random.default_rng(3).standard_normal((4, 3 * ss.block))
    out_len = rs.default_out_len(x.shape[1])
    y = _stream_all(ss, x, out_len)
    ref = _np(rs.oneshot(x, out_len))
    assert rms_db(y - ref) < -280.0


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("fused", [True, False])
def test_sharded_stream_f32(precision, fused):
    rs = _rs(44100, 96000, dtype=torch.float32, precision=precision,
             fused=fused)
    ss = ShardedStreamResampler(rs, _mesh("ch2t4"), seg_len=2048)
    x = np.random.default_rng(4).standard_normal(
        (4, 2 * ss.block)).astype(np.float32)
    out_len = rs.default_out_len(x.shape[1])
    y = _stream_all(ss, x, out_len)
    ref = _np(rs.oneshot(x, out_len))
    assert rms_db(y - ref) < -125.0


POLY = [("poly_up_suffix", 44100, 96001), ("poly_down", 96001, 44100),
        ("poly_near_1x", 44100, 48001),
        ("poly_hbup_suffix", 44100, 352800.3)]


@pytest.mark.parametrize("mesh", ["ch2t4", "t8"])
@pytest.mark.parametrize("cfg", POLY, ids=[c[0] for c in POLY])
def test_sharded_stream_poly_f64_exact(cfg, mesh):
    """Polynomial plans: per-call host output assignment with closed-form
    positions; float64 equal to the oneshot to rounding, the flush tail
    included."""
    _, src, dst = cfg
    rs = _rs(src, dst)
    ss = ShardedStreamResampler(rs, _mesh(mesh), seg_len=1024)
    x = np.random.default_rng(8).standard_normal((3, 3 * ss.block))
    out_len = rs.default_out_len(x.shape[1])
    y = _stream_all(ss, x, out_len)
    ref = _np(rs.oneshot(x, out_len))
    assert rms_db(y - ref) < -280.0


def test_sharded_stream_poly_f32_high():
    """The guarantee engine's polynomial stream (df32 gather-dot) against
    the port's float64 path, relative: -141 dB."""
    rs = _rs(44100, 96001, dtype=torch.float32, precision="high",
             conv_engine="fft", fused=False)
    ss = ShardedStreamResampler(rs, _mesh("t8"), seg_len=1024)
    x = np.random.default_rng(9).standard_normal(
        (2, 2 * ss.block)).astype(np.float32)
    out_len = rs.default_out_len(x.shape[1])
    y = _stream_all(ss, x, out_len)
    ref = _np(_rs(44100, 96001).oneshot(x.astype(np.float64), out_len))
    assert rms_db(y - ref) - rms_db(ref) < -141.0


@pytest.mark.parametrize("cfg", [(44100, 96000, "ch2t4", 2048),
                                 (96001, 44100, "t8", 1024)],
                         ids=["rational", "poly"])
def test_checkpoint_resume_bit_equal(cfg):
    src, dst, mesh, seg = cfg
    rs = _rs(src, dst, 160.0)
    ss = ShardedStreamResampler(rs, _mesh(mesh), seg_len=seg)
    x = np.random.default_rng(6).standard_normal((2, 3 * ss.block))
    ss.process_block(x[:, : ss.block])
    st = ss.get_state()
    y1 = ss.process_block(x[:, ss.block : 2 * ss.block])
    ss2 = ShardedStreamResampler(rs, _mesh(mesh), seg_len=seg)
    ss2.set_state(st)
    assert torch.equal(y1, ss2.process_block(x[:, ss.block : 2 * ss.block]))
    other = ShardedStreamResampler(rs, Mesh((4,), ("t",)), seg_len=seg)
    with pytest.raises(ValueError):
        other.set_state(st)


def test_channel_padding_and_ragged_chunks():
    """Channels not divisible by the ch axis are padded and cut back;
    process() re-blocks ragged chunks on the block grid."""
    rs = _rs(44100, 96000, 160.0)
    ss = ShardedStreamResampler(rs, _mesh("ch2t4"), seg_len=2048)
    x = np.random.default_rng(7).standard_normal((3, 2 * ss.block + 999))
    out_len = rs.default_out_len(x.shape[1])
    outs, pos = [], 0
    for s in (1, ss.block - 1, 5000, ss.block):
        outs.append(_np(ss.process(x[:, pos : pos + s])))
        pos += s
    outs.append(_np(ss.process(x[:, pos:])))
    outs.append(_np(ss.flush(out_len)))
    y = np.concatenate(outs, axis=1)
    ref = _np(rs.oneshot(x, out_len))
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -280.0


# -- against the reference's ShardedStreamResampler ----------------------------


@pytest.mark.parametrize("cfg", [(44100, 96000, "ch2t4", 2048),
                                 (44100, 96001, "t8", 1024)],
                         ids=["rational", "poly_suffix"])
def test_geometry_equals_reference(cfg):
    """Block geometry and, on the polynomial program, the first calls'
    positions, suffix offsets, counts and float64 spline values equal the
    reference's."""
    src, dst, mesh, seg = cfg
    ref = RefShardedStream(RefResampler(src, dst, 2.0, 180.15, 0,
                                        dtype=jnp.float64),
                           _jax_mesh(mesh), seg_len=seg)
    ss = ShardedStreamResampler(_rs(src, dst), _mesh(mesh), seg_len=seg)
    keys = ["H", "L", "block"] + (
        ["M", "R", "W0", "W", "lat_o"] if dst == 96000 else
        ["M_cap", "Fc_cap", "valid_hi0", "padl", "midlen", "Wf_out"])
    assert {k: getattr(ss, k) for k in keys} == \
        {k: getattr(ref, k) for k in keys}
    if dst == 96000:
        return
    for call in range(4):
        rp, flt, w, counts = ss._positions(call)
        rrp, rfv, rw, rcounts = ref._positions(call)
        np.testing.assert_array_equal(rp, rrp)
        np.testing.assert_array_equal(flt, rfv)
        assert list(w) == list(rw) and list(counts) == list(rcounts)
        ss.n_out += sum(counts)
        ref.n_out += sum(rcounts)


@pytest.mark.parametrize("cfg", [(44100, 96000, "ch2t4", 2048),
                                 (96001, 44100, "t8", 1024)],
                         ids=["rational", "poly"])
def test_reference_checkpoint_resumes_in_port(cfg):
    """A reference sharded stream's checkpoint after one block, carried
    into the port's stream (sharded_stream_state_from_reference), gives
    the reference's next block within -260 dB (float64)."""
    src, dst, mesh, seg = cfg
    ref = RefShardedStream(RefResampler(src, dst, 2.0, 160.0, 0,
                                        dtype=jnp.float64),
                           _jax_mesh(mesh), seg_len=seg)
    x = np.random.default_rng(11).standard_normal((3, 2 * ref.block))
    ref.process_block(x[:, : ref.block])
    st = ref.get_state()
    want = np.asarray(ref.process_block(x[:, ref.block :]), np.float64)
    ss = ShardedStreamResampler(_rs(src, dst, 160.0), _mesh(mesh),
                                seg_len=seg)
    ss.set_state(sharded_stream_state_from_reference(st, ss))
    got = _np(ss.process_block(x[:, ss.block :]))
    assert got.shape == want.shape
    assert rms_db(got - want) < -260.0
    bad = dict(st, n_in=st["n_in"] + 1)
    with pytest.raises(ValueError):
        sharded_stream_state_from_reference(bad, ss)
