"""The port's float32 matmul conv engines (``ConvExec`` engines
"toeplitz", "toeplitz_sym", "pallas" and "direct",
r8brain_torch/ops/stages.py) against the reference package's ConvExec on
the CPU.

On the CPU "toeplitz", "pallas" and "direct" run ``frac_whole_ref`` and
"toeplitz_sym" runs ``sym_conv_ref``, the plain versions the card's
kernels are held to.  Bounds: every operator bit-equal to the
reference's; float64 "toeplitz_sym" within 1e-13 (relative to max |y|) of
float64 "toeplitz"; each float32 stage no more than 0.5 dB above the
reference's stage against the float64 stage (the port folds its sums
every 32 or 16 terms, the reference's XLA:CPU dots do not), and within
2^-19 of max |y| of the reference's output.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r8brain_tpu.models.plan import ConvStage as RefConvStage
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.ops.stages import ConvExec as RefConvExec
from r8brain_torch.models.plan import ConvStage, make_plan
from r8brain_torch.ops import operators, stages
from r8brain_torch.ops.pallas_frac import KC, frac_whole
from r8brain_torch.ops.pallas_symconv import sym_conv
from r8brain_torch.ops.stages import MATMUL_ENGINES, ConvExec

from .helpers import lcg_uniform, rms_db

jax.config.update("jax_enable_x64", True)

# the conv specs of tests/test_toeplitz_sym.py and 96k -> 44.1k at
# trans_band 5 (the reference's 16-bit preset geometry)
CONFIGS = [(44100, 96001, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
           (44100, 96000, 2.0, 180.15), (96000, 44100, 5.0, 136.45)]


def _conv_specs():
    out, seen = [], set()
    for cfg in CONFIGS:
        pairs = zip(make_plan(*cfg, 0).stages, ref_make_plan(*cfg, 0).stages)
        for st, rst in pairs:
            if not isinstance(st, ConvStage):
                continue
            assert isinstance(rst, RefConvStage)
            key = (st.filt.kernel.shape[0], st.up, st.down)
            if key not in seen:
                seen.add(key)
                out.append((st, rst))
    return out


SPECS = _conv_specs()
IDS = [f"K{s.filt.kernel.shape[0]}_u{s.up}_d{s.down}" for s, _r in SPECS]
PRECISIONS = ["fast", "high"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's small tensor ops on one thread: the suite runs
    several workers at once, and torch's thread pool would spin on each
    tiny op (about 5x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lo_equal(a, b):
    """Truncated residuals (r0, rows) or None, equal bit for bit."""
    if a is None or b is None:
        return a is None and b is None
    return a[0] == b[0] and np.array_equal(a[1], b[1]) \
        and a[1].dtype == b[1].dtype


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_operators_bit_equal(pair, precision):
    """Every engine's host-built operator equals the reference's bit for
    bit: the superkernel and its residual, the banded operator with its
    truncated residual, the folded Te/To (and their 128-aligned residual
    row blocks) with the common origin, and the mini-Toeplitz."""
    st, rst = pair
    ex = {e: ConvExec(st, torch.float32, precision, engine=e)
          for e in MATMUL_ENGINES}
    ref = {e: RefConvExec(rst, jnp.float32, precision=precision, engine=e)
           for e in MATMUL_ENGINES}
    d, rd = ex["direct"], ref["direct"]
    assert (d.s_min, d.D_direct) == (rd.s_min, rd.D_direct)
    assert np.array_equal(d.skT_direct.T.numpy(), rd.sk_direct)
    if precision == "high":
        assert np.array_equal(d.op.lo.T.numpy(), rd.sk_lo)
    else:
        assert d.op.lo is None
    t, rt = ex["toeplitz"], ref["toeplitz"]
    assert t.B_toep == rt.B_toep and len(rt.toep_chunks) == 1
    rd0, rT, rlo = rt.toep_chunks[0]
    assert rd0 == 0 and t.op.hi.dtype == torch.float32
    assert np.array_equal(t.op.hi.numpy(), rT) and _lo_equal(t.toep_lo, rlo)
    if rlo is not None:
        placed = np.zeros_like(rT)
        placed[rlo[0] : rlo[0] + rlo[1].shape[0]] = rlo[1]
        assert np.array_equal(t.op.lo.numpy(), placed)
    s, rs = ex["toeplitz_sym"], ref["toeplitz_sym"]
    assert s.engine == rs.engine == "toeplitz_sym"
    assert (s.B_sym, s.sym_dmin, s.sym_comp) \
        == (rs.B_sym, rs.sym_dmin, rs.sym_comp)
    assert len(s.toep_sym) == len(rs.toep_sym)
    for j, (ph, rph) in enumerate(zip(s.toep_sym, rs.toep_sym)):
        assert (ph["dlo"], ph["L_f"], ph["Hp"]) \
            == (rph["dlo"], rph["L_f"], rph["Hp"])
        for k in ("Te", "To"):
            assert np.array_equal(ph[k], rph[k]) and ph[k].dtype == np.float32
        for i, k in enumerate(("Te_lo", "To_lo")):
            assert _lo_equal(ph[k], rph[k])
            if ph[k] is not None:
                r0, rows = ph[k]
                assert s.sym_lo_rows[j][i] == (r0, rows.shape[0])
                assert np.array_equal(
                    s.sym_lo[j, i, : rows.shape[0]].numpy(), rows)
        assert np.array_equal(s.sym_ops[j, 0, : ph["Hp"]].numpy(), ph["Te"])
        assert np.array_equal(s.sym_ops[j, 1, : ph["Hp"]].numpy(), ph["To"])
    p, rp = ex["pallas"], ref["pallas"]
    assert (p.B_pallas, p.Lf_pallas) == (rp.B_pallas, rp.Lf_pallas)
    assert np.array_equal(p.T_pallas, rp.T_pallas)
    assert np.array_equal(p.op.hi.numpy(), rp.T_pallas)
    if precision == "high":
        assert np.array_equal(p.T_pallas_lo, rp.T_pallas_lo)
        assert np.array_equal(p.op.lo.numpy(), rp.T_pallas_lo)
    else:
        assert p.T_pallas_lo is None and rp.T_pallas_lo is None


@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_f64_fold_is_exact(pair):
    """The fold is algebra: float64 toeplitz_sym equals float64 toeplitz
    (the port's and the reference's) to 1e-13 of max |y|."""
    st, rst = pair
    x = np.stack([lcg_uniform(7, 6000)] * 2)
    sym = ConvExec(st, torch.float64, engine="toeplitz_sym")
    toe = ConvExec(st, torch.float64, engine="toeplitz")
    assert (sym.engine, sym.precision) == ("toeplitz_sym", "fast")
    ys = sym.apply(torch.from_numpy(x)).numpy()
    yt = toe.apply(torch.from_numpy(x)).numpy()
    yr = np.asarray(RefConvExec(rst, jnp.float64, engine="toeplitz").apply(
        jnp.asarray(x)))
    assert ys.shape == yt.shape == yr.shape
    m = np.abs(yr).max()
    assert np.abs(ys - yt).max() / m < 1e-13
    assert np.abs(ys - yr).max() / m < 1e-13
    assert np.abs(yt - yr).max() / m < 1e-13


@pytest.mark.parametrize("n", [700, 1100, 4096, 9001])
def test_f64_sym_short_and_multi_block(n):
    st, rst = SPECS[0]
    x = lcg_uniform(n, n)[None]
    ys = ConvExec(st, torch.float64, engine="toeplitz_sym").apply(
        torch.from_numpy(x)).numpy()
    yt = ConvExec(st, torch.float64, engine="toeplitz").apply(
        torch.from_numpy(x)).numpy()
    yr = np.asarray(RefConvExec(rst, jnp.float64, engine="toeplitz").apply(
        jnp.asarray(x)))
    assert ys.shape == yt.shape == yr.shape
    m = np.abs(yr).max()
    assert np.abs(ys - yt).max() / m < 1e-13
    assert np.abs(ys - yr).max() / m < 1e-13


@pytest.mark.parametrize("precision", PRECISIONS)
def test_min_phase_falls_back_visibly(precision, monkeypatch):
    """A min-phase kernel is not symmetric: toeplitz_sym builds the plain
    operator, says so in the trace, and computes what toeplitz does."""
    events = []
    monkeypatch.setattr(stages, "trace",
                        lambda ev, **kw: events.append((ev, kw)))
    st = make_plan(44100, 96000, 2.0, 140.0, 1).stages[0]
    k = np.asarray(st.filt.kernel)
    assert not np.array_equal(k, k[::-1])
    sym = ConvExec(st, torch.float32, precision, engine="toeplitz_sym")
    assert sym.engine == "toeplitz"
    assert events == [("conv_toeplitz_sym_fallback",
                       dict(K=k.shape[0], up=st.up, down=st.down))]
    toe = ConvExec(st, torch.float32, precision, engine="toeplitz")
    x = torch.from_numpy(lcg_uniform(3, 5000)[None].astype(np.float32))
    assert torch.equal(sym.apply(x), toe.apply(x))


@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_apply_v_raw(pair):
    """The toeplitz engine's seam protocol: apply_v on a raw buffer with
    surplus columns returns the reference's raw block count and logical
    length, and its prefix equals apply on the prefix."""
    st, rst = pair
    ex = ConvExec(st, torch.float32, "fast", engine="toeplitz")
    ref = RefConvExec(rst, jnp.float32, precision="fast", engine="toeplitz")
    x = np.random.default_rng(2).uniform(-1, 1, (2, 4000)).astype(np.float32)
    for n_valid in (2900, 3500):
        y, m = ex.apply_v(torch.from_numpy(x), n_valid)
        ry, rm = ref.apply_v(jnp.asarray(x), n_valid)
        assert m == rm and y.shape == ry.shape
        assert torch.equal(y[:, :m], ex.apply(torch.from_numpy(
            x[:, :n_valid])))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("pair", SPECS, ids=IDS)
def test_toeplitz_is_one_call_at_reference_geometry(pair, precision,
                                                    monkeypatch):
    """The toeplitz engine makes one frac_whole call: hop B*down, D = L_f,
    O = B*up, the reference's block count, 32-term folds, and the
    operator as the executor packed it once (its bf16 slices, with the
    placed residual's slice under "high") with its band, on an input that
    covers the reference's framing extent (n_blocks + n_seg) * hop."""
    st, rst = pair
    ex = ConvExec(st, torch.float32, precision, engine="toeplitz")
    ref = RefConvExec(rst, jnp.float32, precision=precision,
                      engine="toeplitz")
    x = np.random.default_rng(9).uniform(-1, 1, (2, 3000)).astype(np.float32)
    calls = []
    real = operators.frac_whole
    monkeypatch.setattr(operators, "frac_whole", lambda *a, **k: calls.append(
        (a[0].shape[1], a[1], a[2:6], k)) or real(*a, **k))
    y, m = ex.apply_v(torch.from_numpy(x), 3000)
    ry, rm = ref.apply_v(jnp.asarray(x), 3000)
    assert (m, y.shape) == (rm, ry.shape)
    B, down, up = ref.B_toep, rst.down, rst.up
    L_f = ref.toep_chunks[0][1].shape[0]
    n_blocks = ry.shape[1] // (B * up)
    assert len(calls) == 1
    width, T, geo, kw = calls[0]
    assert T is ex.op.parts and geo == (B * down, L_f, B * up, n_blocks)
    assert kw == dict(kc=KC, band=ex.op.band)
    assert (ex.op.lo is None) == (precision == "fast")
    assert T.shape[2] == (3 if precision == "fast" else 4)
    assert width >= (n_blocks + -(-L_f // (B * down))) * B * down


@functools.lru_cache(maxsize=None)
def _stage_input(i):
    """2 x 5000 float32 samples and the reference's float64 stage of
    SPECS[i] on them."""
    x = np.stack([lcg_uniform(11 + c, 5000) for c in range(2)]).astype(
        np.float32)
    y64 = np.asarray(RefConvExec(SPECS[i][1], jnp.float64,
                                 engine="toeplitz").apply(
        jnp.asarray(x.astype(np.float64))))
    return x, y64


@functools.lru_cache(maxsize=None)
def _ref_stage(i, engine, precision):
    """The reference's float32 stage of SPECS[i] on _stage_input(i).  At 2
    channels its pallas engine runs its toeplitz fallback (no TPU channel
    tile fits), so the two share one run."""
    if engine == "pallas":
        return _ref_stage(i, "toeplitz", precision)
    ex = RefConvExec(SPECS[i][1], jnp.float32, precision=precision,
                     engine=engine)
    return np.asarray(ex.apply(jnp.asarray(_stage_input(i)[0])), np.float64)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("engine", MATMUL_ENGINES)
@pytest.mark.parametrize("i", range(len(SPECS)), ids=IDS)
def test_f32_stage_vs_reference(i, engine, precision):
    """Each float32 engine's stage against the reference's same engine:
    within 2^-19 of max |y|, and no more than 0.5 dB above the
    reference's error against the float64 stage."""
    x, y64 = _stage_input(i)
    ex = ConvExec(SPECS[i][0], torch.float32, precision, engine=engine)
    assert ex.engine == engine
    y = ex.apply(torch.from_numpy(x)).double().numpy()
    ry = _ref_stage(i, engine, precision)
    assert y.shape == ry.shape == y64.shape
    m = np.abs(y64).max()
    assert np.abs(y - ry).max() <= 2.0**-19 * m
    db, ref_db = rms_db(y - y64), rms_db(ry - y64)
    assert db < ref_db + 0.5, (db, ref_db)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pallas_keeps_its_engine_at_two_channels(precision, monkeypatch):
    """The reference's pallas engine falls back to toeplitz where its TPU
    channel tiles do not fit (C=2 on the CPU); frac_whole has no channel
    tiles, so the port's stays on the mini-Toeplitz call."""
    st, _rst = SPECS[2]
    ex = ConvExec(st, torch.float32, precision, engine="pallas")
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 3000)).astype(np.float32))
    calls = []
    real = operators.frac_whole
    monkeypatch.setattr(operators, "frac_whole",
                        lambda *a, **k: calls.append(a[2:5]) or real(*a, **k))
    ex.apply(x)
    assert ex.engine == "pallas"
    assert calls == [(64 * st.down, ex.Lf_pallas, 64 * st.up)]


def test_defaults_match_reference():
    """ConvExec and FracWholeExec default to precision "fast" and engine
    "auto", as the reference's do: float32 "toeplitz", float64 "fft"."""
    st, rst = SPECS[2]
    ex, ref = ConvExec(st), RefConvExec(rst)
    assert (ex.engine, ex.precision) == (ref.engine, ref.precision) \
        == ("toeplitz", "fast")
    assert ConvExec(st, torch.float64).engine == "fft"
    frac = make_plan(44100, 96000, 2.0, 180.15, 0).stages[1]
    fx = stages.FracWholeExec(frac)
    assert (fx.engine, fx.precision, fx.op.lo) == ("im2col", "fast", None)
    with pytest.raises(ValueError, match="unknown conv engine"):
        ConvExec(st, engine="nonesuch")
    with pytest.raises(ValueError, match="unknown frac engine"):
        stages.FracWholeExec(frac, engine="nonesuch")


@pytest.mark.parametrize("engine", MATMUL_ENGINES)
def test_cpu_stage_launches_no_kernel(engine):
    st, _rst = SPECS[1]
    ex = ConvExec(st, torch.float32, "high", engine=engine)
    before = (frac_whole.launches, sym_conv.launches)
    ex.apply(torch.zeros((1, 2000)))
    assert (frac_whole.launches, sym_conv.launches) == before
