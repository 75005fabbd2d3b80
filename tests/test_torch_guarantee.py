"""The port's guarantee chain (``conv_engine="ozaki"`` +
``frac_engine="ozaki"``, r8brain_torch/ops/stages.py and
models/resampler.py) against the reference package's Resampler and the
float64 oracle, on the CPU.

With ``precision="high"`` the stages hand (hi, lo) pairs across their seam
(the df32 carry); ``R8BT_DF_CARRY=0`` turns it off.  The bounds are those
of tests/test_ozaki.py: -150 dB against the oracle with the carry, -141 dB
without, and the port within -150 dB of the reference's output.
"""

import numpy as np
import pytest
import torch

from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_torch import Resampler
from r8brain_torch.ops.pallas_ozaki import ozaki_framed
from r8brain_torch.ops.stages import ConvExec, FracWholeExec, build_exec

from .helpers import lcg_uniform, rms_db

OZ_CONFIGS = [("up_44k_96k", 44100, 96000, 180.15),
              ("up_44k_48k", 44100, 48000, 180.15),
              ("down_96k_44k", 96000, 44100, 180.15),
              ("preset_def", 44100, 96000, 206.91)]
OZ = dict(precision="high", fused=False, conv_engine="ozaki",
          frac_engine="ozaki")
CARRY_DB = {"1": -150.0, "0": -141.0}


def _rel_db(y, ref):
    return rms_db(y - ref) - rms_db(ref)


def _pair(src, dst, atten, carry, monkeypatch):
    monkeypatch.setenv("R8BT_DF_CARRY", carry)
    rs = Resampler(src, dst, 2.0, atten, device="cpu", **OZ)
    ref = RefResampler(src, dst, 2.0, atten, 0, dtype="float32", **OZ)
    assert rs.df_carry == ref.df_carry == (carry == "1")
    return rs, ref


@pytest.mark.parametrize("carry", ["1", "0"], ids=["carry", "no_carry"])
@pytest.mark.parametrize("cfg", OZ_CONFIGS, ids=[c[0] for c in OZ_CONFIGS])
def test_chain_vs_reference_and_oracle(cfg, carry, monkeypatch):
    """tests/test_ozaki.py's input and bounds (:170-185, :264-297)."""
    _label, src, dst, atten = cfg
    rs, ref = _pair(src, dst, atten, carry, monkeypatch)
    assert [type(e) for e in rs.execs] == [ConvExec, FracWholeExec]
    n = 12000
    x = lcg_uniform(101, n).astype(np.float32)
    out_len = int(np.floor(n * dst / src))
    orc = OracleResampler(src, dst, 4096, 2.0, atten, 0).oneshot(
        x.astype(np.float64), out_len)
    y = rs.oneshot(x, out_len)
    assert y.dtype == torch.float32 and y.shape == (out_len,)
    y = y.double().numpy()
    y_ref = np.asarray(ref.oneshot(x, out_len), np.float64)
    assert _rel_db(y, y_ref) < -150.0
    assert _rel_db(y, orc) < CARRY_DB[carry]


@pytest.mark.parametrize("n", [1, 300, 511, 512, 513, 2047, 5000])
def test_input_lengths(n, monkeypatch):
    """Lengths around the conv stage's 256-cycle block boundaries (the
    block count n_blocks changes there) and too short for any output,
    several channels with different peaks (different grids)."""
    rs, ref = _pair(44100, 96000, 180.15, "1", monkeypatch)
    x = np.stack([lcg_uniform(30 + i, n) * g
                  for i, g in enumerate((1.0, 0.01, 3.0))]).astype(np.float32)
    y = rs.oneshot(x).double().numpy()
    y_ref = np.asarray(ref.oneshot(x), np.float64)
    assert y.shape == y_ref.shape == (3, rs.default_out_len(n))
    if y.size:
        for c in range(3):
            assert _rel_db(y[c], y_ref[c]) < -150.0


def test_seam_protocols_agree(monkeypatch):
    """apply_v on a raw buffer with surplus columns, apply on the sliced
    prefix, and the carry chain collapsed at the seam describe the same
    stage outputs."""
    rs, _ref = _pair(44100, 48000, 180.15, "1", monkeypatch)
    conv, frac = rs.execs
    x = torch.from_numpy(np.stack([lcg_uniform(7, 3000),
                                   lcg_uniform(8, 3000)]).astype(np.float32))
    buf, m = conv.apply_v(x, x.shape[1])
    assert buf.shape[1] > m == conv.out_len(3000)
    assert torch.equal(buf[:, :m], conv.apply(x))
    y_v, n_v = frac.apply_v(buf, m)
    assert torch.equal(y_v[:, :n_v], frac.apply(buf[:, :m]))
    h, l, n = conv.apply_df(x, None, x.shape[1], emit_pair=True)
    assert n == m and l.dtype == torch.bfloat16 and h.shape == l.shape
    yd, none, nd = frac.apply_df(h, l, n, emit_pair=False)
    assert none is None and nd == n_v
    assert _rel_db(yd.double().numpy(), y_v[:, :n_v].double().numpy()) \
        < -140.0


@pytest.mark.parametrize("emit_pair", [False, True], ids=["last", "pair"])
@pytest.mark.parametrize("has_l", [False, True], ids=["first", "lo"])
@pytest.mark.parametrize("stage", [0, 1], ids=["conv", "frac"])
def test_apply_df_vs_reference(stage, has_l, emit_pair, monkeypatch):
    """Each executor's df32 carry step, in every (residual in, pair out)
    combination, against the reference executor's apply_df on the same
    raw buffers (valid prefix 2900 of 3000 columns): the same count, and
    the collapsed output within -150 dB."""
    import jax.numpy as jnp

    rs, ref = _pair(44100, 48000, 180.15, "1", monkeypatch)
    rng = np.random.default_rng(12 + stage)
    h = rng.uniform(-1.0, 1.0, (2, 3000)).astype(np.float32)
    l = None
    if has_l:
        l = torch.from_numpy(rng.uniform(-1.0, 1.0, (2, 3000)) * 2.0**-24
                             ).to(torch.bfloat16)
    yh, yl, n = rs.execs[stage].apply_df(torch.from_numpy(h), l, 2900,
                                         emit_pair=emit_pair)
    rh, rl, rn = ref.execs[stage].apply_df(
        jnp.asarray(h), None if l is None else jnp.asarray(
            l.float().numpy(), jnp.bfloat16), 2900, emit_pair=emit_pair)
    assert n == rn > 0 and (yl is None) == (rl is None) == (not emit_pair)
    y = yh[:, :n].double().numpy()
    r = np.asarray(rh, np.float64)[:, :n]
    if emit_pair:
        assert yl.dtype == torch.bfloat16 and yl.shape == yh.shape
        y = y + yl[:, :n].double().numpy()
        r = r + np.asarray(rl, np.float64)[:, :n]
    assert _rel_db(y, r) < -150.0


def test_cpu_chain_launches_no_kernel(monkeypatch):
    rs, _ref = _pair(44100, 96000, 180.15, "1", monkeypatch)
    before = ozaki_framed.launches
    rs.oneshot(lcg_uniform(3, 2000))
    assert ozaki_framed.launches == before


def test_unported_engines_raise():
    """Every fused mode builds (fused="poly" fuses the [conv, poly-frac]
    pair of 44.1k -> 96001: [FusedPolyExec, ConvExec]); the half-band and
    polynomial stages build on every engine (the ozaki chain's take the
    split form); the ozaki engine in float64 raises, and an unknown
    engine name is a ValueError."""
    cpu = dict(device="cpu")
    rs = Resampler(44100, 96001, 2.0, 180.15, fused="poly", **cpu)
    assert [type(e).__name__ for e in rs.execs] == ["FusedPolyExec",
                                                    "ConvExec"]
    for dst, kinds in ((176400, ["ConvExec", "HBUpExec"]),
                       (96001, ["ConvExec", "FracPolyExec", "ConvExec"])):
        for kw, engine in ((OZ, "ozaki"), (dict(fused=False), "toeplitz"),
                           (dict(conv_engine="toeplitz_sym"),
                            "toeplitz_sym")):
            rs = Resampler(44100, dst, 2.0, 180.15, **kw, **cpu)
            assert [type(e).__name__ for e in rs.execs] == kinds
            assert rs.execs[0].engine == engine
            assert rs.execs[1].engine == {
                "HBUpExec": "ozaki" if engine == "ozaki" else "matmul",
                "FracPolyExec": "banded"}[kinds[1]]
    with pytest.raises(NotImplementedError, match="float32"):
        Resampler(44100, 96000, 2.0, 180.15, dtype=torch.float64, **OZ,
                  **cpu)
    conv = Resampler(44100, 96000, device="cpu").plan.stages[0]
    assert build_exec(conv, conv_engine="toeplitz").engine == "toeplitz"
    with pytest.raises(ValueError, match="unknown conv engine"):
        build_exec(conv, conv_engine="toeplitz_asym")


CARRY_CLASS = [(44100.0, 96001.0, 180.15), (431181.83, 44100.0, 139.53)]


@pytest.mark.parametrize("carry", ["1", "0"], ids=["carry", "no_carry"])
@pytest.mark.parametrize("cfg", CARRY_CLASS,
                         ids=[f"{s:g}-{d:g}" for s, d, _a in CARRY_CLASS])
def test_df_carry_chain_class(cfg, carry, monkeypatch):
    """tests/test_ozaki.py::test_df_carry_chain_class on the port: the
    guarantee chain with the polynomial stage's split products (and,
    at 431181.83 -> 44100, two half-band decimators on the split form)
    holds -150 dB against the oracle with the carry, -141 dB without."""
    src, dst, atten = cfg
    monkeypatch.setenv("R8BT_DF_CARRY", carry)
    rs = Resampler(src, dst, 2.0, atten, device="cpu", **OZ)
    assert rs.df_carry == (carry == "1")
    assert all(e.engine in ("ozaki", "banded") for e in rs.execs)
    n = 4000
    x32 = lcg_uniform(17, n).astype(np.float32)
    out_len = int(np.floor(n * dst / src))
    orc = OracleResampler(src, dst, 4096, 2.0, atten, 0).oneshot(
        x32.astype(np.float64), out_len)
    y = rs.oneshot(x32, out_len).double().numpy()
    assert _rel_db(y, orc) < CARRY_DB[carry]
