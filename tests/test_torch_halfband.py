"""The port's half-band executors (``HBUpExec``, ``HBDownExec``,
r8brain_torch/ops/stages.py) and their cascade (``HBUpCascadeExec``,
r8brain_torch/ops/hb_cascade.py) against the reference package's
executors, the per-stage chain and the reference's float64 cascade model,
on the CPU (the kernels' plain versions).

Bounds, on seeded Gaussian input: float64 within 1e-12 of max |y| of the
reference (bit-equal where the summation order is the same); float32
"stencil" bit-equal to the reference; float32 "matmul" (``frac_whole``'s
split model) within -140 dB (RMS relative) of the float64 stencil and
within -135 dB of the reference's float32 product (which sits near -142
dB itself: XLA:CPU's long float32 dot); "ozaki" within -160 dB of the
reference's split product (both exact to ~2^-30 before the one float32
rounding of the output).  The cascade equals the per-stage float64 chain
to 1e-12, edge region included.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.ops import hb_cascade as ref_cascade
from r8brain_tpu.ops import stages as ref_stages
from r8brain_tpu.ops.fused import fuse_stage_list as ref_fuse_stage_list
from r8brain_tpu.ops.ozaki import framed_matmul_ozaki as ref_framed_ozaki
from r8brain_torch.models.plan import HBDownStage, HBUpStage, make_plan
from r8brain_torch.ops import hb_cascade
from r8brain_torch.ops.fused import fuse_stage_list
from r8brain_torch.ops.ozaki import channel_scale
from r8brain_torch.ops.pallas_frac import frac_whole
from r8brain_torch.ops.pallas_ozaki import ozaki_framed
from r8brain_torch.ops.stages import (HB_BLOCK, HBDownExec, HBUpExec,
                                      build_exec)

from .helpers import rms_db


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (kind, src, dst): tests/test_hb_matmul.py's plans at 150 dB
KINDS = {"up": (44100, 352800, HBUpStage, HBUpExec, ref_stages.HBUpExec),
         "down": (2822400, 96000, HBDownStage, HBDownExec,
                  ref_stages.HBDownExec)}
ENGINES = ["matmul", "stencil", "ozaki"]


@functools.lru_cache(maxsize=None)
def _specs(kind, atten=150.0):
    """(port specs, reference specs) of the kind's half-band stages."""
    src, dst, cls, _P, _R = KINDS[kind]
    port = [s for s in make_plan(src, dst, 2.0, atten, 0).stages
            if isinstance(s, cls)]
    ref = [s for s in ref_make_plan(src, dst, 2.0, atten, 0).stages
           if s.kind == port[0].kind]
    assert port and len(port) == len(ref)
    return port, ref


def _rel_db(y, ref):
    return rms_db(y - ref) - rms_db(ref)


def _np(y):
    return np.asarray(y, np.float64) if not isinstance(y, torch.Tensor) \
        else y.double().numpy()


@pytest.mark.parametrize("n", [4097, 8192, 12000])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_matmul_matches_stencil(kind, n):
    """tests/test_hb_matmul.py: the float32 framed engine against the
    stencil at three lengths (-120 dB there; the split model holds -140
    against the float64 stencil)."""
    port, _ref = _specs(kind)
    Exec = KINDS[kind][3]
    x = np.random.default_rng(2 if kind == "down" else 4).standard_normal(
        (3, n))
    for spec in port:
        ys = Exec(spec, torch.float32, engine="stencil").apply(
            torch.from_numpy(x).float())
        ym = Exec(spec, torch.float32, engine="matmul").apply(
            torch.from_numpy(x).float())
        y64 = Exec(spec, torch.float64).apply(torch.from_numpy(x))
        assert ys.shape == ym.shape == y64.shape
        assert rms_db(_np(ym) - _np(ys)) < -120.0
        assert _rel_db(_np(ym), _np(y64)) < -140.0


@pytest.mark.parametrize("kind", ["up", "down"])
def test_engine_defaults(kind):
    spec = _specs(kind)[0][0]
    Exec = KINDS[kind][3]
    assert Exec(spec, torch.float32).engine == "matmul"
    assert Exec(spec, torch.float64).engine == "stencil"
    # the split form is a float32 tool: float64 runs the stencil
    assert Exec(spec, torch.float64, engine="ozaki").engine == "stencil"
    assert build_exec(spec, conv_engine="ozaki").engine == "ozaki"
    assert build_exec(spec, conv_engine="toeplitz_sym").engine == "matmul"
    assert build_exec(spec, torch.float64).engine == "stencil"
    with pytest.raises(ValueError, match="half-band engine"):
        Exec(spec, torch.float32, engine="fft")


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_vs_reference(kind, dtype, engine, precision):
    """Every engine, precision and dtype against the reference executor on
    the same input, at every half-band stage of the kind's plan."""
    port, ref = _specs(kind)
    _src, _dst, _cls, Exec, RefExec = KINDS[kind]
    x = np.random.default_rng(7).standard_normal((3, 4097))
    for a, b in zip(port, ref):
        ex = Exec(a, getattr(torch, dtype), engine=engine,
                  precision=precision)
        rex = RefExec(b, getattr(jnp, dtype), engine=engine,
                      precision=precision)
        assert ex.engine == rex.engine and ex.precision == rex.precision
        y = _np(ex.apply(torch.from_numpy(x).to(getattr(torch, dtype))))
        yr = _np(rex.apply(jnp.asarray(x, getattr(jnp, dtype))))
        assert y.shape == yr.shape
        if dtype == "float64" or ex.engine == "stencil" and \
                dtype == "float32":
            err = np.abs(y - yr).max() / np.abs(yr).max()
            assert err <= (1e-12 if dtype == "float64" else 0.0), err
        elif ex.engine == "ozaki":
            assert _rel_db(y, yr) < -160.0
        else:
            assert _rel_db(y, yr) < -135.0


@pytest.mark.parametrize("kind", ["up", "down"])
def test_operators_equal_reference(kind):
    """The framed engines' operators (and the "high" residual) are the
    reference's, entry for entry."""
    port, ref = _specs(kind)
    _src, _dst, _cls, Exec, RefExec = KINDS[kind]
    for a, b in zip(port, ref):
        ex = Exec(a, torch.float32, precision="high")
        rex = RefExec(b, jnp.float32, precision="high")
        assert np.array_equal(ex.op.hi.numpy(), np.asarray(rex.T))
        r0, rows = rex.T_lo
        lo = np.zeros_like(ex.op.hi.numpy())
        lo[r0 : r0 + rows.shape[0]] = rows
        assert np.array_equal(ex.op.lo.numpy(), lo)
        oz = Exec(a, torch.float32, engine="ozaki")
        roz = RefExec(b, jnp.float32, engine="ozaki")
        assert np.array_equal(oz.op.parts.double().numpy(),
                              np.asarray(roz.oz_parts, np.float64))


@pytest.mark.parametrize("emit_pair", [True, False])
@pytest.mark.parametrize("has_l", [False, True])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_apply_df_vs_reference(kind, has_l, emit_pair):
    """The ozaki engine's carry on a raw (hi, lo) buffer longer than its
    logical count, against the reference's apply_df (JAX's
    framed_matmul_ozaki): hi within -160 dB, and the pair's sum."""
    port, ref = _specs(kind)
    _src, _dst, _cls, Exec, RefExec = KINDS[kind]
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 3000)).astype(np.float32)
    l = (rng.standard_normal((2, 3000)) * 2.0**-26).astype(np.float32)
    n_valid = 2900
    ex = Exec(port[0], torch.float32, engine="ozaki")
    rex = RefExec(ref[0], jnp.float32, engine="ozaki")
    lt = torch.from_numpy(l).to(torch.bfloat16) if has_l else None
    lr = jnp.asarray(l, jnp.bfloat16) if has_l else None
    yh, yl, m = ex.apply_df(torch.from_numpy(h), lt, n_valid, emit_pair)
    rh, rl, rm = rex.apply_df(jnp.asarray(h), lr, n_valid, emit_pair)
    assert m == rm == ex.out_len(n_valid)
    assert (yl is None) == (rl is None) == (not emit_pair)
    y, r = _np(yh), _np(rh)
    assert y.shape == r.shape
    if emit_pair:
        y, r = y + _np(yl.float()), r + _np(rl)
    assert _rel_db(y, r) < -160.0
    # the same function as the collapsed input through apply
    x = h[:, :n_valid] + (_np(lt.float())[:, :n_valid] if has_l else 0.0)
    y_apply = _np(ex.apply(torch.from_numpy(np.asarray(x, np.float32))))
    assert _rel_db(y, y_apply) < -140.0


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("has_lo", [False, True])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_ozaki_product_vs_reference_composition(kind, has_lo, pair):
    """``ozaki_framed`` (its plain version) at the half-band geometry
    against the reference's framed_matmul_ozaki on the same operator
    slices and input: every chunk product is exact in both, so the pair's
    hi agrees within -160 dB and its sum too."""
    port, _ref = _specs(kind)
    ex = KINDS[kind][3](port[0], torch.float32, engine="ozaki")
    hop = HB_BLOCK * (1 if kind == "up" else 2)
    n_blocks, C = 7, 3
    rng = np.random.default_rng(13)
    span = (n_blocks - 1) * hop + ex.op.L_f
    xp = rng.standard_normal((C, span)).astype(np.float32)
    xl = (rng.standard_normal((C, span)) * 2.0**-26).astype(np.float32)
    xlt = torch.from_numpy(xl).to(torch.bfloat16) if has_lo else None
    xt = torch.from_numpy(xp)
    res = ozaki_framed(xt, channel_scale(xt), ex.op.parts, ex.op.L_f, hop,
                       ex.op.Kcols, n_blocks, x_lo=xlt, emit_pair=pair)
    ref = ref_framed_ozaki(jnp.asarray(xp), jnp.asarray(
        ex.op.parts.float().numpy(), jnp.bfloat16), n_blocks, hop,
        x_lo=jnp.asarray(xl, jnp.bfloat16) if has_lo else None, pair=pair)
    if pair:
        y = _np(res[0]) + _np(res[1].float())
        r = (np.asarray(ref[0], np.float64)
             + np.asarray(ref[1], np.float64)).reshape(C, -1)
        assert _rel_db(_np(res[0]), np.asarray(ref[0], np.float64).reshape(
            C, -1)) < -160.0
    else:
        y, r = _np(res), np.asarray(ref, np.float64).reshape(C, -1)
    assert _rel_db(y, r) < -160.0


def test_cpu_tensors_launch_no_kernel():
    port, _ref = _specs("up")
    before = (frac_whole.launches, ozaki_framed.launches)
    x = torch.randn(2, 2000)
    for engine in ENGINES:
        HBUpExec(port[0], engine=engine).apply(x)
    assert (frac_whole.launches, ozaki_framed.launches) == before


# --- the cascade -----------------------------------------------------------

# plans with a run of half-band upsamplers: 44.1k -> 176.4k has one (no
# cascade), 529.2k two, 352.8k two at 150 dB, 2.8224M five (PCM -> DSD64)
CASCADES = [(44100, 529200, 180.15, 2), (44100, 352800, 150.0, 2),
            (44100, 2822400, 180.15, 5), (96000, 2822400, 180.15, 3)]
CIDS = [f"{s}-{d}" for s, d, _a, _m in CASCADES]


@functools.lru_cache(maxsize=None)
def _run(src, dst, atten):
    """(port HB specs, reference HB specs) of the plan's half-band run."""
    port = [s for s in make_plan(src, dst, 2.0, atten, 0).stages
            if isinstance(s, HBUpStage)]
    ref = [s for s in ref_make_plan(src, dst, 2.0, atten, 0).stages
           if s.kind == "hb_up"]
    return tuple(port), tuple(ref)


@functools.lru_cache(maxsize=None)
def _cascade(src, dst, atten, dt):
    return hb_cascade.HBUpCascadeExec(_run(src, dst, atten)[0],
                                      getattr(torch, dt))


def _per_stage(specs, x, dtype):
    for sp in specs:
        x = HBUpExec(sp, dtype).apply(x)
    return x


@pytest.mark.parametrize("cfg", CASCADES, ids=CIDS)
def test_cascade_operator_equals_reference(cfg):
    src, dst, atten, m = cfg
    port, ref = _run(src, dst, atten)
    assert len(port) == m
    ex = _cascade(src, dst, atten, "float32")
    rex = ref_cascade.HBUpCascadeExec(ref, jnp.float32)
    assert (ex.U, ex.op.L_f, ex.minr, ex.E, ex.P) == (
        rex.U, rex.L_f, rex.minr, rex.E, rex.P)
    assert np.array_equal(ex.op.hi.numpy(), np.asarray(rex.T))
    assert np.array_equal(ex.edge_C.numpy(), np.asarray(rex.C))
    assert np.array_equal(ex.edge_D.numpy(), np.asarray(rex.D))


@pytest.mark.parametrize("n", [3, 40, 300, 4097])
@pytest.mark.parametrize("cfg", CASCADES, ids=CIDS)
def test_cascade_equals_per_stage_chain_f64(cfg, n):
    """float64: the cascade against the port's per-stage HBUpExec chain
    and the reference's float64 cascade model to 1e-12 of max |y|, from
    inputs whose every output lies in the edge (M <= E) to long ones."""
    src, dst, atten, _m = cfg
    port, ref = _run(src, dst, atten)
    ex = _cascade(src, dst, atten, "float64")
    x = np.random.default_rng(n).standard_normal((2, n))
    y = ex.apply(torch.from_numpy(x)).numpy()
    y_chain = _per_stage(port, torch.from_numpy(x), torch.float64).numpy()
    assert y.shape == y_chain.shape == (2, ex.out_len(n))
    if y.size == 0:
        return
    y_ref = np.stack([ref_cascade._cascade_ref(x[c], ref) for c in range(2)])
    scale = np.abs(y_chain).max()
    assert np.abs(y - y_chain).max() <= 1e-12 * scale
    assert np.abs(y - y_ref).max() <= 1e-12 * scale


@pytest.mark.parametrize("cfg", CASCADES, ids=CIDS)
def test_cascade_edge_region_covered(cfg):
    """Some input length puts every output in the edge (M <= E) and a
    longer one crosses it; both equal the per-stage chain."""
    src, dst, atten, _m = cfg
    port, _ref = _run(src, dst, atten)
    ex = _cascade(src, dst, atten, "float64")
    n_in = [n for n in range(1, 200) if 0 < ex.out_len(n) <= ex.E]
    assert n_in, "no length lies wholly in the edge"
    for n in (n_in[0], n_in[-1], n_in[-1] + 1):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((1, n)))
        y = ex.apply(x)
        yc = _per_stage(port, x, torch.float64)
        assert torch.allclose(y, yc, rtol=0, atol=1e-12 * yc.abs().max())


@pytest.mark.parametrize("cfg", CASCADES, ids=CIDS)
def test_cascade_f32_vs_chain_and_reference(cfg):
    """float32: the cascade (one frac_whole call) within -140 dB of the
    float64 per-stage chain and within -135 dB of the reference's
    float32 cascade."""
    src, dst, atten, _m = cfg
    port, ref = _run(src, dst, atten)
    ex = _cascade(src, dst, atten, "float32")
    x = np.random.default_rng(5).standard_normal((2, 3000))
    y = _np(ex.apply(torch.from_numpy(x).float()))
    y64 = _np(_per_stage(port, torch.from_numpy(x), torch.float64))
    yr = _np(ref_cascade.HBUpCascadeExec(ref, jnp.float32).apply(
        jnp.asarray(x, jnp.float32)))
    assert y.shape == y64.shape == yr.shape
    assert _rel_db(y, y64) < -140.0
    assert _rel_db(y, yr) < -135.0


def test_cascade_fusion_rule():
    """fuse_stage_list fuses a run of >= 2 float32 half-band upsamplers,
    as the reference does; a lone one, and float64, stay per stage."""
    for src, dst in ((44100, 2822400), (44100, 529200), (44100, 192000),
                     (44100, 176400)):
        plan = make_plan(src, dst, 2.0, 180.15, 0)
        ref_plan = ref_make_plan(src, dst, 2.0, 180.15, 0)
        got = fuse_stage_list(plan, torch.float32, "fast")
        want = ref_fuse_stage_list(ref_plan, jnp.float32, "fast",
                                   ref_stages.build_exec)
        names = None if got is None else [type(e).__name__ for e in got]
        assert names == (None if want is None
                         else [type(e).__name__ for e in want]), (src, dst)
        got64 = fuse_stage_list(plan, torch.float64, "fast")
        assert got64 is None or not any(
            isinstance(e, hb_cascade.HBUpCascadeExec) for e in got64)
    assert hb_cascade.hb_up_run_fusable(
        make_plan(44100, 2822400, 2.0, 180.15, 0).stages, 1,
        torch.float32) == 5
    with pytest.raises(ValueError):
        hb_cascade.HBUpCascadeExec(_run(44100, 529200, 180.15)[0][:1])
