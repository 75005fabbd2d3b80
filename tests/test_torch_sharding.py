"""The port's sharded oneshot (r8brain_torch/parallel) against its own
unsharded chain and the reference package's ShardedResampler, on the CPU
(``device="cpu"``: the kernels' plain versions) over in-process meshes.

Bounds, each the reference's own test's:
* geometry: ``shard_geometry`` and the polynomial split chain's (M_s, L_s,
  H, R, Fc, padl, the read positions and the float64 spline values) equal
  to the reference's, for tests/test_sharding.py's CONFIGS and
  POLY_CONFIGS over ch4, t4, ch2t4 and t8;
* float64 sharded against unsharded: -260 dB (tests/test_sharding.py:63);
* float32 fast / high, fused and unfused: -125 dB
  (tests/test_sharding_f32.py:24);
* the port's sharded output against the reference's sharded output on the
  same input: -260 dB in float64, -125 dB in float32;
* sharded 44.1k -> 96001 against the port's float64 path: -141 dB under
  the df32 guarantee engine, -115 dB "fast" (tests/test_sharding.py:131);
* channel shards of ``resample_fn``, forward and ``torch.func.grad``,
  against the unsharded transform: -125 dB (the reference's pjit test,
  tests/test_functional.py:108).
"""

import numpy as np
import pytest
import torch
from torch.func import grad

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.parallel.sharding import ShardedResampler as RefSharded
from r8brain_tpu.parallel.sharding import chain_input_span as ref_span
from r8brain_tpu.parallel.sharding import chain_shift_period as ref_period
from r8brain_tpu.parallel.sharding import shard_geometry as ref_geometry
from r8brain_torch import (Mesh, Resampler, ShardedResampler, make_plan,
                           resample_fn)
from r8brain_torch.models.lengths import chain_input_span, chain_shift_period
from r8brain_torch.parallel.dryrun import dryrun_multichip
from r8brain_torch.parallel.sharding import (poly_geometry, poly_split,
                                             shard_geometry)

from .helpers import lcg_uniform, rms_db

CPU = dict(device="cpu")

# tests/test_sharding.py's configurations
CONFIGS = [
    ("up_44k_96k", 44100, 96000, 180.15),
    ("down_96k_44k", 96000, 44100, 180.15),
    ("up_44k_48k", 44100, 48000, 180.15),
    ("x4_up", 44100, 176400, 180.15),
    ("x4_down", 176400, 44100, 140.0),
]
POLY_CONFIGS = [
    ("poly_up_suffix", 44100, 96001, 180.15, 4410),
    ("poly_down", 96001, 44100, 180.15, 4410),
    ("poly_near_1x", 44100, 48001, 160.0, 4410),
    ("poly_big_up_hb", 44100, 352801, 140.0, 2205),
    ("poly_big_down_hb", 352801, 44100, 140.0, 24000),
]
MESHES = {"ch4": ((4,), ("ch",)), "t4": ((4,), ("t",)),
          "ch2t4": ((2, 4), ("ch", "t")), "t8": ((8,), ("t",))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(name):
    shape, names = MESHES[name]
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return JaxMesh(devs, names)


def _mesh(name):
    return Mesh(*MESHES[name])


_RS = {}


def _rs(src, dst, atten, dtype=torch.float64, **kw):
    """The port's resampler of a configuration, built once a module."""
    key = (src, dst, atten, dtype, tuple(sorted(kw.items())))
    if key not in _RS:
        _RS[key] = Resampler(src, dst, 2.0, atten, 0, dtype=dtype, **CPU,
                             **kw)
    return _RS[key]


def _x(C, n, seed, dtype=np.float64):
    return np.stack([lcg_uniform(seed + c, n) for c in range(C)]).astype(
        dtype)


def _np(y):
    return y.double().numpy()


# -- the mesh ------------------------------------------------------------------


def test_mesh_coordinates_are_row_major():
    for shape, names in [((2, 4), ("ch", "t")), ((4, 2), ("t", "ch")),
                         ((8,), ("t",)), ((3,), ("ch",))]:
        m = Mesh(shape, names)
        grid = np.arange(m.size).reshape(shape)
        for r in range(m.size):
            idx = dict(zip(names, np.argwhere(grid == r)[0]))
            assert m.coord(r) == (idx.get("ch", 0), idx.get("t", 0))
            assert m.rank_at(*m.coord(r)) == r
    with pytest.raises(ValueError):
        Mesh((2, 2), ("ch", "x"))
    with pytest.raises(ValueError):
        Mesh((2,), ("t", "ch"))


def test_mesh_permute_is_ppermute():
    """Each shard gets its source's piece; a shard without one gets zeros
    (the reference's ppermute fill); the carry pairs go from a channel
    row's last time shard to its first."""
    m = Mesh((2, 3))
    pieces = {r: torch.full((2, 4), float(r + 1)) for r in range(m.size)}
    got = m.permute(pieces, m.t_pairs(+1))
    for r in range(m.size):
        ci, ti = m.coord(r)
        want = 0.0 if ti == 0 else float(m.rank_at(ci, ti - 1) + 1)
        assert torch.equal(got[r], torch.full((2, 4), want))
    got = m.permute(pieces, m.carry_pairs())
    assert torch.equal(got[m.rank_at(1, 0)],
                       torch.full((2, 4), float(m.rank_at(1, 2) + 1)))
    assert torch.equal(got[m.rank_at(1, 1)], torch.zeros(2, 4))


def test_nccl_refuses_two_ranks_on_one_device(monkeypatch):
    """Under NCCL the mesh gathers each rank's (host, device) and refuses a
    device that two ranks share; other backends gather nothing."""
    import torch.distributed as dist

    m = Mesh((2,), ("t",))
    m.group, m.rank, m.backend, m.nccl = object(), 0, "nccl", True

    def gathered(where):
        def fake(out, obj, group=None):
            out[:] = where
        return fake

    monkeypatch.setattr(dist, "all_gather_object",
                        gathered([("h", 0), ("h", 0)]))
    with pytest.raises(ValueError, match="two ranks on one device"):
        m.check_device(torch.device("cuda", 0))
    monkeypatch.setattr(dist, "all_gather_object",
                        gathered([("h", 0), ("h", 1)]))
    m.check_device(torch.device("cuda", 0))
    m2 = Mesh((2,), ("t",))
    m2.group, m2.rank, m2.backend, m2.nccl = object(), 0, "gloo", False
    monkeypatch.setattr(dist, "all_gather_object", None)
    m2.check_device(torch.device("cuda", 0))


# -- geometry ------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_shard_geometry_equals_reference(cfg, mesh):
    _, src, dst, atten = cfg
    n_t = dict(zip(MESHES[mesh][1], MESHES[mesh][0])).get("t", 1)
    plan = make_plan(src, dst, 2.0, atten, 0)
    ref_plan = ref_make_plan(src, dst, 2.0, atten, 0)
    for n in (4000, 44100, 441000):
        out_len = int(n * dst // src)
        got = shard_geometry(plan, chain_shift_period(plan),
                             chain_input_span(plan), n_t, out_len, n)
        want = ref_geometry(ref_plan, ref_period(ref_plan),
                            ref_span(ref_plan), n_t, out_len, n)
        assert got == want, (n, got, want)


_REF_SHARDED = {}


def _ref_sharded(src, dst, atten, mesh):
    key = (src, dst, atten, mesh)
    if key not in _REF_SHARDED:
        rs = RefResampler(src, dst, 2.0, atten, 0, dtype="float64")
        _REF_SHARDED[key] = RefSharded(rs, _jax_mesh(mesh))
    return _REF_SHARDED[key]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", POLY_CONFIGS, ids=[c[0] for c in POLY_CONFIGS])
def test_poly_geometry_equals_reference(cfg, mesh):
    """The split chain's geometry, read positions and spline values equal
    the reference's integer for integer and value for value."""
    _, src, dst, atten, n = cfg
    n_t = dict(zip(MESHES[mesh][1], MESHES[mesh][0])).get("t", 1)
    plan = make_plan(src, dst, 2.0, atten, 0)
    ref = _ref_sharded(src, dst, atten, mesh)
    for n_in in (n, 3 * n + 17):
        out_len = int(n_in * dst // src)
        geom, relpos, flt = poly_geometry(plan, poly_split(plan), n_t,
                                          out_len, n_in)
        rgeom, rrel, rflt = ref._poly_geometry(out_len, n_in)
        assert geom == rgeom
        np.testing.assert_array_equal(relpos, rrel)
        np.testing.assert_array_equal(flt, np.asarray(rflt))


# -- sharded against unsharded -------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_sharded_parity_f64(cfg, mesh):
    _, src, dst, atten = cfg
    rs = _rs(src, dst, atten)
    n, C = 4000, 4
    x = _x(C, n, 11)
    out_len = rs.default_out_len(n)
    ref = _np(rs.oneshot(x, out_len))
    y = _np(ShardedResampler(rs, _mesh(mesh)).oneshot(x, out_len))
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -260.0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", POLY_CONFIGS, ids=[c[0] for c in POLY_CONFIGS])
def test_poly_sharded_parity_f64(cfg, mesh):
    """Polynomial plans: time shards run the split chain with per-shard
    closed-form read positions (CDSPFracInterpolator.h:907-919); a
    channel-only mesh the whole chain."""
    _, src, dst, atten, n = cfg
    rs = _rs(src, dst, atten)
    assert chain_shift_period(rs.plan) is None
    C = 3
    x = _x(C, n, 7)
    out_len = rs.default_out_len(n)
    ref = _np(rs.oneshot(x, out_len))
    srs = ShardedResampler(rs, _mesh(mesh))
    assert (srs._poly is None) == (mesh == "ch4")
    y = _np(srs.oneshot(x, out_len))
    assert y.shape == ref.shape
    assert rms_db(y - ref) < -260.0


F32_CASES = [
    ("fast_fused", "fast", "auto", "auto", "auto"),
    ("fast_unfused", "fast", False, "auto", "auto"),
    ("high_fused", "high", "auto", "auto", "auto"),
    ("high_toeplitz", "high", False, "toeplitz", "auto"),
    ("high_dfft", "high", False, "fft", "auto"),
    ("guarantee_ozaki", "high", "auto", "ozaki", "ozaki"),
]


@pytest.mark.parametrize("label,precision,fused,conv_engine,frac_engine",
                         F32_CASES, ids=[c[0] for c in F32_CASES])
def test_sharded_f32_parity_up(label, precision, fused, conv_engine,
                               frac_engine):
    """ch2 x t4 against unsharded, -125 dB; the guarantee chain (ozaki
    engines, df32 carry inside each shard's chain) also against the
    float64 path at its -150 dB relative bound (tests/test_ozaki.py:284)."""
    rs = _rs(44100, 96000, 180.15, torch.float32, precision=precision,
             fused=fused, conv_engine=conv_engine, frac_engine=frac_engine)
    n = 40000
    x = _x(4, n, 0, np.float32)
    out_len = rs.default_out_len(n)
    y_s = _np(ShardedResampler(rs, _mesh("ch2t4")).oneshot(x, out_len))
    y_u = _np(rs.oneshot(x, out_len))
    assert rms_db(y_s - y_u) < -125.0, label
    if frac_engine == "ozaki":
        assert rs.df_carry
        ref = _np(_rs(44100, 96000, 180.15).oneshot(x.astype(np.float64),
                                                     out_len))
        assert rms_db(y_s - ref) - rms_db(ref) < -150.0


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_sharded_f32_parity_down(precision):
    rs = _rs(96000, 44100, 180.15, torch.float32, precision=precision)
    n = 48000
    x = _x(2, n, 9, np.float32)
    out_len = rs.default_out_len(n)
    y_s = _np(ShardedResampler(rs, _mesh("ch2t4")).oneshot(x, out_len))
    y_u = _np(rs.oneshot(x, out_len))
    assert rms_db(y_s - y_u) < -125.0


def test_poly_sharded_f32_class():
    """Sharded 44.1k -> 96001 against the port's float64 path, relative:
    the df32 guarantee engine (its sharded gather-dot summed in df32) in
    the -141 dB class, "fast" and "high" on the default engines within
    the reference's -115 dB bound; each against its unsharded chain at
    -125 dB."""
    n, C = 12000, 2
    x = _x(C, n, 5, np.float32)
    rs64 = _rs(44100, 96001, 180.15)
    out_len = rs64.default_out_len(n)
    ref = _np(rs64.oneshot(x.astype(np.float64), out_len))
    for kw, bound in ((dict(precision="high", fused=False,
                            conv_engine="fft"), -141.0),
                      (dict(precision="high"), -141.0),
                      (dict(), -115.0)):
        rs = _rs(44100, 96001, 180.15, torch.float32, **kw)
        y = _np(ShardedResampler(rs, _mesh("t4")).oneshot(x, out_len))
        rel = rms_db(y - ref) - rms_db(ref)
        assert rel < bound, (kw, rel)
        assert rms_db(y - _np(rs.oneshot(x, out_len))) < -125.0, kw


def test_uneven_channels():
    """Channels not divisible by the mesh: padded and cut back."""
    rs = _rs(44100, 96000, 140.0)
    n = 2000
    x = _x(3, n, 0)
    out_len = rs.default_out_len(n)
    ref = _np(rs.oneshot(x, out_len))
    for mesh in ("ch4", "ch2t4"):
        y = _np(ShardedResampler(rs, _mesh(mesh)).oneshot(x, out_len))
        assert y.shape == ref.shape
        assert rms_db(y - ref) < -260.0


def test_passthrough_plan():
    rs = _rs(48000, 48000, 180.15)
    assert not rs.plan.stages
    x = _x(2, 1000, 3)
    for out_len in (1000, 900, 1100):
        y = ShardedResampler(rs, _mesh("ch2t4")).oneshot(x, out_len)
        assert torch.equal(y, rs.oneshot(x, out_len))


def test_shard_slices_tile_the_signal():
    """The slices of all shards cover the input and the output once, and
    a shard's output piece of the in-process run is y[rows, t_out]."""
    rs = _rs(44100, 96000, 140.0)
    srs = ShardedResampler(rs, _mesh("ch2t4"))
    C, n = 3, 3000
    out_len = rs.default_out_len(n)
    seen_in = np.zeros((C, n), int)
    seen_out = np.zeros((C, out_len), int)
    for r in range(8):
        rows, t_in, t_out = srs.shard_slices(C, n, out_len, rank=r)
        seen_in[rows, t_in] += 1
        seen_out[rows, t_out] += 1
    assert (seen_in == 1).all() and (seen_out == 1).all()
    with pytest.raises(ValueError):
        srs.shard_slices(C, n, out_len)


# -- against the reference's ShardedResampler ----------------------------------


@pytest.mark.parametrize("mesh", ["t4", "ch2t4"])
@pytest.mark.parametrize("cfg", [(44100, 96000), (44100, 96001)],
                         ids=["flagship", "poly_96001"])
def test_vs_reference_sharded(cfg, mesh):
    """The same seeded input through the reference's ShardedResampler and
    the port's: float64 within -260 dB, float32 fast within -125 dB."""
    src, dst = cfg
    n, C = 6000, 2
    x = np.random.default_rng(21).uniform(-1, 1, (C, n))
    jm = _jax_mesh(mesh)
    for dtype, jdt, bound in ((torch.float64, jnp.float64, -260.0),
                              (torch.float32, jnp.float32, -125.0)):
        xi = x.astype(np.float64 if dtype == torch.float64 else np.float32)
        ref_rs = RefResampler(src, dst, 2.0, 180.15, 0, dtype=jdt)
        out_len = ref_rs.default_out_len(n)
        want = np.asarray(RefSharded(ref_rs, jm).oneshot(xi, out_len),
                          dtype=np.float64)
        rs = _rs(src, dst, 180.15, dtype)
        got = _np(ShardedResampler(rs, _mesh(mesh)).oneshot(xi, out_len))
        assert got.shape == want.shape
        assert rms_db(got - want) < bound, (dtype, rms_db(got - want))


# -- the functional transform, the dry run -------------------------------------


def test_channel_sharded_resample_fn():
    """Channel shards of resample_fn (each shard's rows through the same
    function) equal the unsharded transform, forward and
    torch.func.grad: the counterpart of the reference's pjit test."""
    rs = _rs(44100, 96000, 136.45, torch.float32)
    n = 4410
    f = resample_fn(rs, n)
    x = torch.from_numpy(_x(8, n, 0, np.float32))
    w = torch.from_numpy(_x(8, rs.default_out_len(n), 40, np.float32))
    mesh = _mesh("ch4")
    srs = ShardedResampler(rs, mesh)
    rows = [srs.shard_slices(8, n, rank=r)[0] for r in range(mesh.size)]

    def loss(f_):
        return lambda v: (w * f_(v)).sum()

    y = f(x)
    y_sh = torch.cat([f(x[r]) for r in rows])
    assert rms_db(_np(y_sh - y)) < -125.0
    g = grad(loss(f))(x)
    g_sh = torch.cat([grad(lambda v, r=r: (w[r] * f(v)).sum())(x[r])
                      for r in rows])
    assert rms_db(_np(g_sh - g)) < -125.0


@pytest.mark.parametrize("n_shards", [4, 8])
def test_dryrun_multichip_cpu(n_shards):
    out = dryrun_multichip(n_shards, device="cpu")
    assert out["preset24"]["vs_f64_rel_db"] < -141.0
    assert out["poly"]["vs_f64_rel_db"] < -141.0
    assert out["stream"]["vs_unsharded_db"] < -120.0
