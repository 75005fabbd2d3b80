"""The port's polynomial-mode interpolator (``FracPolyExec``,
``chunk_drift_groups``, ``banded_contract`` and ``banded_contract_ozaki``,
r8brain_torch/ops/stages.py) against the reference package's, the gather
engine, the float64 oracle and the reference's chain, on the CPU.

Bounds: the banded engine against the gather engine at -250 dB (float64)
and -110 dB (float32), tests/test_poly_banded.py's; the port against the
reference executor bit-equal in float32 "fast" and with the split
products (the same float64 operator rounded once, the same segment sums)
and within 1e-12 of max |y| in float64; under "high", whose main product
the port sums in float64, -150 dB from the float64 engine and 6 dB
closer to it than the reference; the device-placed operators bit-equal
to a numpy placement of the same values; the
spline residual of "high" lowering the error of an impulse train's pair
output by at least 40 dB; the chains within -141 dB of the oracle and no
more than 1 dB above the reference's chain.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.ops import stages as ref_stages
from r8brain_tpu.ops.ozaki import split_operator_host_batched as ref_split
from r8brain_torch import Resampler
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops import stages
from r8brain_torch.ops.ozaki import split_operator_batched
from r8brain_torch.ops.stages import (ConvExec, FracPolyExec,
                                      banded_contract_ozaki, build_exec,
                                      chunk_drift_groups)

from .helpers import lcg_uniform, rms_db


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_poly_banded.py's ratios, at 170 dB
RATIOS = [("poly_96001", 44100, 96001),
          ("poly_down", 96001, 44100),
          ("poly_sqrt2", 44100, 44100 * np.sqrt(2.0)),
          ("poly_slight", 44100, 44100 * 1.0001)]
RIDS = [r[0] for r in RATIOS]


@functools.lru_cache(maxsize=None)
def _spec(src, dst, atten=170.0):
    """(port poly spec, reference poly spec) of the plan."""
    port = [s for s in make_plan(src, dst, 2.0, atten, 0).stages
            if s.kind == "frac" and not s.is_whole]
    ref = [s for s in ref_make_plan(src, dst, 2.0, atten, 0).stages
           if s.kind == "frac" and not s.is_whole]
    assert len(port) == len(ref) == 1
    return port[0], ref[0]


@functools.lru_cache(maxsize=None)
def _input(seed=3, C=3, n=16000):
    """Gaussian input with float32 values (held in float64)."""
    x = np.random.default_rng(seed).standard_normal((C, n))
    return x.astype(np.float32).astype(np.float64)


def _np(y):
    return y.double().numpy() if isinstance(y, torch.Tensor) \
        else np.asarray(y, np.float64)


def _rel_db(y, ref):
    return rms_db(y - ref) - rms_db(ref)


@pytest.mark.parametrize("cfg", RATIOS, ids=RIDS)
def test_geometry_and_chunks_equal_reference(cfg):
    """(S, G, W), the host positions and chunk_drift_groups equal the
    reference's (the chunks of the whole run and of a forced small
    ngrp_max, which splits on drift)."""
    _label, src, dst = cfg
    port, ref = _spec(src, dst)
    ex = FracPolyExec(port, torch.float32)
    rex = ref_stages.FracPolyExec(ref, jnp.float32)
    assert (ex.S, ex.G, ex.W, ex.ngrp_max, ex.drift) == \
        (rex.S, rex.G, rex.W, rex.ngrp_max, rex.drift)
    Mp = 40 * ex.G
    pos, rpos = ex.host_positions(Mp), rex.host_positions(Mp)
    for a, b in zip(pos, rpos):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    start = pos[0]
    sg = (start + max(0, -int(start.min()))).reshape(-1, ex.G)
    for ngrp in (sg.shape[0], 8, 3):
        got = chunk_drift_groups(sg, sg, 1, ex.S, ex.fl, ex.W, ngrp, ex.W)
        want = ref_stages.chunk_drift_groups(sg, sg, 1, ex.S, ex.fl, ex.W,
                                             ngrp, ex.W)
        assert got[1:] == want[1:]
        assert len(got[0]) == len(want[0])
        for a, b in zip(got[0], want[0]):
            assert a[:3] == b[:3] and np.array_equal(a[3], b[3])


@pytest.mark.parametrize("cfg", RATIOS, ids=RIDS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, -250.0),
                                       (torch.float32, -110.0)],
                         ids=["f64", "f32"])
def test_banded_matches_gather(cfg, dtype, tol):
    """tests/test_poly_banded.py: the banded engine against the gather
    engine on 3 x 16000 Gaussian samples."""
    _label, src, dst = cfg
    port, _ref = _spec(src, dst)
    x = torch.from_numpy(_input()).to(dtype)
    yg = FracPolyExec(port, dtype, engine="gather").apply(x)
    yb = FracPolyExec(port, dtype, engine="banded").apply(x)
    assert yg.shape == yb.shape
    assert rms_db(_np(yg) - _np(yb)) < tol


@pytest.mark.parametrize("engine", ["banded", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cfg", RATIOS, ids=RIDS)
def test_vs_reference(cfg, dtype, engine):
    """Both engines in both dtypes against the reference executor on the
    same input: float32 bit-equal (the operator is the same float64 value
    rounded once, the segments summed in the same order), float64 within
    1e-12 of max |y|.  The banded engine's "high" sums its main product
    in float64 where the reference sums in float32: within -135 dB
    (relative RMS) of the reference's, and at -150 dB from the float64
    gather engine, 6 dB or more closer than the reference's (-141)."""
    _label, src, dst = cfg
    port, ref = _spec(src, dst)
    x = _input()
    precisions = ["fast", "high"] if dtype == "float32" else ["fast"]
    for prec in precisions:
        ex = FracPolyExec(port, getattr(torch, dtype), engine=engine,
                          precision=prec)
        rex = ref_stages.FracPolyExec(ref, getattr(jnp, dtype), engine=engine,
                                      precision=prec)
        y = _np(ex.apply(torch.from_numpy(x).to(getattr(torch, dtype))))
        yr = _np(rex.apply(jnp.asarray(x, getattr(jnp, dtype))))
        assert y.shape == yr.shape
        if prec == "high" and engine == "banded":
            y64 = _np(FracPolyExec(port, torch.float64).apply(
                torch.from_numpy(x)))
            assert _rel_db(y, yr) < -135.0
            assert _rel_db(y, y64) < min(-150.0, _rel_db(yr, y64) - 6.0)
            continue
        err = np.abs(y - yr).max() / np.abs(yr).max()
        assert err <= (0.0 if dtype == "float32" else 1e-12), (prec, err)


@pytest.mark.parametrize("cfg", RATIOS[:2], ids=RIDS[:2])
def test_split_products_vs_reference(cfg):
    """The guarantee products (frac_engine="ozaki") against the reference
    executor, jitted as the reference's chain runs it (XLA:CPU's eager
    dot takes no bfloat16 operands): bit-equal, every chunk product
    exact in both."""
    _label, src, dst = cfg
    port, ref = _spec(src, dst)
    x = _input(C=2, n=6000)
    kw = dict(precision="high", oz_products=True)
    y = _np(FracPolyExec(port, torch.float32, **kw).apply(
        torch.from_numpy(x).float()))
    yr = _np(jax.jit(ref_stages.FracPolyExec(ref, jnp.float32, **kw).apply)(
        jnp.asarray(x, jnp.float32)))
    assert np.array_equal(y, yr)


CARRY = [(False, True, False), (False, True, True), (False, False, True),
         (False, False, False), (True, True, True), (True, True, False)]


@pytest.mark.parametrize("oz,has_l,emit_pair", CARRY,
                         ids=[f"{'oz' if o else 'high'}-l{int(h)}-pair{int(e)}"
                              for o, h, e in CARRY])
def test_apply_df_vs_reference(oz, has_l, emit_pair):
    """The banded engine's carry on a raw buffer longer than its logical
    count against the reference's apply_df (the split products jitted, as
    above): with the split products the pair's hi (or the collapsed
    output) bit-equal and its sum within -200 dB; under plain "high",
    whose main product sums in float64 here, the sum within -135 dB of
    the reference's (relative RMS) and -150 dB of the float64 product."""
    port, ref = _spec(44100, 96001)
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 5000)).astype(np.float32)
    l = (rng.standard_normal((2, 5000)) * 2.0**-26).astype(np.float32)
    n_valid = 4900
    kw = dict(precision="high", oz_products=oz)
    ex = FracPolyExec(port, torch.float32, **kw)
    rex = ref_stages.FracPolyExec(ref, jnp.float32, **kw)
    lt = torch.from_numpy(l).to(torch.bfloat16) if has_l else None
    lr = jnp.asarray(l, jnp.bfloat16) if has_l else None
    yh, yl, m = ex.apply_df(torch.from_numpy(h), lt, n_valid, emit_pair)
    run = jax.jit(rex.apply_df, static_argnums=(2, 3)) if oz \
        else rex.apply_df
    rh, rl, rm = run(jnp.asarray(h), lr, n_valid, emit_pair)
    assert m == rm == ex.out_len(n_valid)
    assert (yl is None) == (rl is None) == (not emit_pair)
    assert yh.shape == rh.shape and yh.shape[1] % ex.G == 0
    y, r = _np(yh), _np(rh)
    if emit_pair:
        y, r = y + _np(yl), r + _np(rl)
    if oz:
        assert np.array_equal(_np(yh), _np(rh))
        assert _rel_db(y, r) < -200.0
        return
    x64 = h.astype(np.float64) + (_np(lt) if has_l else 0.0)
    y64 = _np(FracPolyExec(port, torch.float64, engine="banded").apply_v(
        torch.from_numpy(x64), n_valid)[0])
    assert _rel_db(y, r) < -135.0
    assert _rel_db(y, y64) < -150.0


def _impulses(n: int, gap: int):
    x = np.zeros((2, n))
    x[0, 50::gap] = 1.0
    x[1, 50 + gap // 2 :: gap] = -0.5  # powers of two: exact products
    return x


def test_spline_residual_gain():
    """precision="high" carries the float32 rounding of the float64
    spline filter values as a second pass.  An impulse train with the impulses further
    apart than a window makes every output one filter value, so every
    product and sum is exact and the pair output of the carry (hi + the
    bfloat16 lo) shows the residual: at least 40 dB closer to the float64
    gather engine than "fast" (whose pair has no lo), which rounds each
    value once to float32.  On Gaussian input "high" never costs more
    than 0.5 dB."""
    port, _ref = _spec(44100, 96001)
    x = _impulses(6000, 97)
    y64 = FracPolyExec(port, torch.float64).apply(torch.from_numpy(x))
    y64 = y64.numpy()
    err = {}
    for prec in ("fast", "high"):
        ex = FracPolyExec(port, torch.float32, precision=prec)
        h, l, m = ex.apply_df(torch.from_numpy(x).float(), None)
        y = _np(h[:, :m]) + (0.0 if l is None else _np(l[:, :m]))
        err[prec] = _rel_db(y, y64[:, :m])
    assert err["high"] < err["fast"] - 40.0, err
    xg = torch.from_numpy(_input(n=6000)).float()
    y64g = _np(FracPolyExec(port, torch.float64).apply(xg.double()))
    db = {p: _rel_db(_np(FracPolyExec(port, torch.float32,
                                      precision=p).apply(xg)), y64g)
          for p in ("fast", "high")}
    assert db["high"] <= db["fast"] + 0.5, db


def _numpy_operators(ex, M):
    """The banded operators of ``ex`` for M outputs, built here in numpy:
    the positions and drift chunks of the executor's geometry, the
    float64 spline values of each group placed at its window offsets by
    plain indexing, then rounded (and split) as each precision class
    asks.  Returns [(A, nloc, operators)] in FracPolyExec's layout."""
    G, S, W, fl = ex.G, ex.S, ex.W, ex.fl
    start, fti, t = ex.host_positions(M)
    n_grp = -(-M // G)
    ext = n_grp * G - M
    start, fti, t = (np.concatenate([a, np.repeat(a[-1], ext)])
                     for a in (start, fti, t))
    sg = (start + max(0, -int(start.min()))).reshape(n_grp, G)
    chunks = chunk_drift_groups(sg, sg, 1, S, fl, W, n_grp, W)[0]
    tb = ex.tab.numpy()
    out = []
    for g0, nloc, A, off in chunks:
        fc = fti.reshape(n_grp, G)[g0 : g0 + nloc]
        tc = t.reshape(n_grp, G)[g0 : g0 + nloc, :, None]
        vals = tb[fc, :, 0] + (tb[fc, :, 1] + tb[fc, :, 2] * tc) * tc
        R = np.zeros((nloc, W, G))
        for i in range(fl):
            R[np.arange(nloc)[:, None], off + i, np.arange(G)] = vals[..., i]
        if ex.oz_products:
            ops = {"R_oz": torch.from_numpy(np.asarray(
                ref_split(R), np.float32)).to(torch.bfloat16)}
        elif ex.precision == "high":
            R32 = R.astype(np.float32)
            ops = {"R": torch.from_numpy(R32),
                   "R64": torch.from_numpy(R32.astype(np.float64)),
                   "R_lo": torch.from_numpy((R - R32).astype(np.float32))}
        else:
            ops = {"R": torch.from_numpy(R.astype(np.float32)),
                   "R_lo": None, "R64": None}
        out.append((A, nloc, ops))
    return out


@pytest.mark.parametrize("kw", [dict(precision="fast"),
                                dict(precision="high"),
                                dict(precision="high", oz_products=True)],
                         ids=["fast", "high", "oz_products"])
def test_device_placed_operators_equal_numpy(kw):
    """The operators placed on the device (``poly_operators``: the host
    float64 spline values scattered into place, then rounded or split)
    are bit-equal to a plain numpy placement of the same values, chunk by
    chunk, and each chunk holds the operators of its precision class:
    the split slices with oz_products, the spline residual and the
    float64 copy under "high", neither under "fast"."""
    port, _ref = _spec(44100, 96001, 180.15)
    x = torch.from_numpy(_input(seed=5, C=2, n=9000)).float()
    ex = FracPolyExec(port, torch.float32, **kw)
    y = ex.apply(x)
    (chunks, _need, _pad), = ex._state.values()
    want = _numpy_operators(ex, y.shape[1])
    assert len(chunks) == len(want)
    for (A, nloc, ops), (A_w, nloc_w, ops_w) in zip(chunks, want):
        assert (A, nloc) == (A_w, nloc_w)
        assert set(ops) == set(ops_w)
        for k, v in ops_w.items():
            assert (ops[k] is None) == (v is None)
            if v is not None:
                assert ops[k].dtype == v.dtype and torch.equal(ops[k], v), k
        if kw.get("oz_products"):
            assert set(ops) == {"R_oz"}
        else:
            high = kw["precision"] == "high"
            assert (ops["R_lo"] is not None) == high
            assert (ops["R64"] is not None) == high


@pytest.mark.parametrize("scale, exact", [(1.0, True), (2.0**-60, True),
                                          (2.0**-120, False)])
def test_operator_split_exactness_checked(scale, exact):
    """The guarantee interpolator's exactness lemma needs bfloat16-exact
    operator slices.  The oneshot's operator build (once a length) asks
    split_operator_batched to check them, so a filter scaled until its
    third slices fall below bfloat16's subnormal grid is refused, not
    rounded; at ordinary extreme scales the output scales with it."""
    port, _ref = _spec(44100, 96001, 180.15)
    x = torch.from_numpy(_input(seed=8, C=2, n=4000)).float()
    y1 = FracPolyExec(port, torch.float32, precision="high",
                      oz_products=True).apply(x)
    ex = FracPolyExec(port, torch.float32, precision="high",
                      oz_products=True)
    ex.tab = ex.tab * scale
    if not exact:
        with pytest.raises(AssertionError, match="bf16-exact"):
            ex.apply(x)
        return
    y = ex.apply(x)
    assert _rel_db(_np(y) / scale, _np(y1)) < -140.0


def test_ozaki_contraction_vs_reference():
    """split_operator_batched equals the reference's host split, and
    banded_contract_ozaki on that operator and the same input equals the
    reference's: bit-equal, collapsed and as a pair with a seam
    residual."""
    rng = np.random.default_rng(2)
    nloc, S, W, G, C = 6, 300, 320, 16, 3
    R64 = rng.standard_normal((nloc, W, G)) * (rng.random((nloc, W, G))
                                               < 0.1)
    parts = split_operator_batched(torch.from_numpy(R64))
    xc = rng.standard_normal((C, (nloc + 2) * S)).astype(np.float32)
    xl = (rng.standard_normal(xc.shape) * 2.0**-26).astype(np.float32)
    rparts = jnp.asarray(ref_split(R64))
    assert np.array_equal(parts.float().numpy(),
                          np.asarray(rparts, np.float32))
    # the operator a constant of the jitted function, as in the reference's
    # executor (XLA:CPU runs no bfloat16 dot of two arguments)
    y = banded_contract_ozaki(torch.from_numpy(xc), parts, nloc, S, W)
    yr = jax.jit(lambda a: ref_stages.banded_contract_ozaki(
        a, rparts, nloc, S, W))(jnp.asarray(xc))
    assert np.array_equal(_np(y), _np(yr))
    h, lo = banded_contract_ozaki(torch.from_numpy(xc), parts, nloc, S, W,
                                  x_lo=torch.from_numpy(xl).bfloat16(),
                                  pair=True)
    rh, rlo = jax.jit(lambda a, b: ref_stages.banded_contract_ozaki(
        a, rparts, nloc, S, W, x_lo=b, pair=True))(
        jnp.asarray(xc), jnp.asarray(xl, jnp.bfloat16))
    assert np.array_equal(_np(h), _np(rh)) and np.array_equal(_np(lo),
                                                              _np(rlo))
    exact = np.einsum("cml,mlg->cmg", np.stack(
        [xc[:, m * S : m * S + W] for m in range(nloc)], 1), R64)
    assert _rel_db(_np(y), exact) < -140.0


def test_latency_spec_takes_the_sliced_path():
    """A spec with input latency (the seam protocol would read the latency
    prefix) runs apply on the logical prefix, like the reference."""
    port, ref = _spec(44100, 96001)
    port = dataclasses.replace(port, in_latency=3)
    ref = dataclasses.replace(ref, in_latency=3)
    x = _input(seed=8, C=2, n=5000)
    ex = FracPolyExec(port, torch.float32)
    raw = torch.from_numpy(np.pad(x, ((0, 0), (0, 77)))).float()
    y, m = ex.apply_v(raw, 5000)
    assert m == y.shape[1] == ex.out_len(5000)
    assert torch.equal(y, ex.apply(raw[:, :5000]))
    yr = ref_stages.FracPolyExec(ref, jnp.float32).apply(
        jnp.asarray(x, jnp.float32))
    assert np.array_equal(_np(y), _np(yr))


def test_state_is_built_once_per_length():
    port, _ref = _spec(44100, 96001)
    ex = FracPolyExec(port, torch.float32)
    x = torch.from_numpy(_input(seed=4, C=1, n=4000)).float()
    y = ex.apply(x)
    st = dict(ex._state)
    assert len(st) == 1
    assert torch.equal(ex.apply(x), y) and ex._state.keys() == st.keys()
    assert next(iter(ex._state.values())) is next(iter(st.values()))
    for n in range(3000, 3000 + 10 * stages.POLY_CACHE, 10):
        ex.apply(x[:, :n])
    assert len(ex._state) == stages.POLY_CACHE


def test_build_exec_engines():
    port, _ref = _spec(44100, 96001)
    assert build_exec(port).engine == "banded"
    assert build_exec(port, torch.float64).engine == "gather"
    for fe in ("im2col", "pallas", "conv"):
        assert build_exec(port, frac_engine=fe).engine == "banded"
    ex = build_exec(port, frac_engine="ozaki")
    assert ex.engine == "banded" and ex.precision == "high" and \
        ex.oz_products
    assert build_exec(port, frac_engine="gather").engine == "gather"
    with pytest.raises(ValueError, match="unknown frac engine"):
        build_exec(port, frac_engine="sinc")


# --- the chains --------------------------------------------------------------

CHAINS = [(44100, 96001), (44100, 352800.3), (96000, 44100.5)]


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("rates", CHAINS, ids=[f"{s}-{d}" for s, d in CHAINS])
def test_chain_vs_oracle_and_reference(rates, precision):
    """The default float32 chain of a polynomial plan, against the oracle
    (-141 dB, 25 ms edge skip) and no more than 1 dB above the
    reference's chain on the same input; float64 in the oracle's class
    (-220 dB, tests/test_goldens.py's "poly")."""
    src, dst = rates
    n = 6000
    x = np.stack([lcg_uniform(41 + c, n) for c in range(2)]).astype(
        np.float32).astype(np.float64)
    out_len = int(np.floor(n * dst / src))
    rs = Resampler(src, dst, 2.0, 180.15, precision=precision, device="cpu")
    assert any(isinstance(e, FracPolyExec) and e.engine == "banded"
               for e in rs.execs)
    y = _np(rs.oneshot(x.astype(np.float32), out_len))
    orc = np.stack([OracleResampler(src, dst, 4096, 2.0, 180.15, 0).oneshot(
        x[c], out_len) for c in range(2)])
    y_ref = _np(RefResampler(src, dst, 2.0, 180.15, precision=precision,
                             dtype=jnp.float32).oneshot(
        x.astype(np.float32), out_len))
    s = slice(int(0.025 * dst), -int(0.025 * dst))
    db, ref_db = rms_db(y[:, s] - orc[:, s]), rms_db(y_ref[:, s] - orc[:, s])
    assert db < -141.0, db
    assert db < ref_db + 1.0, (db, ref_db)
    if precision == "fast":
        y64 = _np(Resampler(src, dst, 2.0, 180.15, dtype=torch.float64,
                            device="cpu").oneshot(x, out_len))
        assert rms_db(y64 - orc) < -220.0
    # the seam protocol hands the poly stage's raw group buffer on: the
    # same output as the stages run on each other's logical output
    xs = torch.from_numpy(x).float()
    T = rs.in_len_for_out(out_len)
    v = torch.nn.functional.pad(xs, (0, max(0, T - n)))
    for e in rs.execs:
        v = e.apply(v)
    assert np.array_equal(_np(v[:, :out_len]), y)


def test_chain_executors():
    """44.1k -> 96001 runs [conv, poly, conv] stage by stage under every
    default; the guarantee chain's poly stage takes the split products."""
    rs = Resampler(44100, 96001, 2.0, 180.15, device="cpu")
    assert [type(e) for e in rs.execs] == [ConvExec, FracPolyExec, ConvExec]
    assert rs.execs[1].engine == "banded"
    oz = Resampler(44100, 96001, 2.0, 180.15, precision="high",
                   conv_engine="ozaki", frac_engine="ozaki", device="cpu")
    assert [e.engine for e in oz.execs] == ["ozaki", "banded", "ozaki"]
    assert oz.execs[1].oz_products
    f64 = Resampler(44100, 96001, 2.0, 180.15, dtype=torch.float64,
                    device="cpu")
    assert [e.engine for e in f64.execs] == ["fft", "gather", "fft"]
