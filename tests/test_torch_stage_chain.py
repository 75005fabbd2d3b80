"""The port's float32 stage-by-stage chain (``Resampler(fused=False)``,
r8brain_torch/models/resampler.py) with every matmul conv engine and
interpolator engine, against the float64 oracle, the reference package's
same chain and the C++ goldens, on the CPU.

Bounds, dB re full scale at 2 x 12000 samples of ``lcg_uniform(101 + c)``
with a 50 ms edge skip: against the oracle, the -141 dB class (for
``conv_engine="direct"`` under ``precision="fast"``: no more than 1 dB
above the reference's chain, which sits at -141.06 dB on 44.1k -> 96k);
and every chain no more than 1 dB above the reference's same chain
against the oracle, and within -135 dB of it.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.models.oracle import OracleResampler
from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.models.resampler import Resampler as RefResampler
from r8brain_tpu.ops.stages import ConvExec as RefConvExec
from r8brain_torch import Resampler
from r8brain_torch.ops import stages
from r8brain_torch.ops.stages import ConvExec, FracWholeExec

from .helpers import lcg_uniform, load_golden, load_manifest, rms_db

CHAINS = [(44100, 96000, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
          (44100, 48000, 2.0, 180.15), (96000, 44100, 5.0, 136.45)]
CONV_ENGINES = ["auto", "toeplitz_sym", "pallas", "direct"]
FRAC_ENGINES = ["auto", "pallas", "conv"]
EDGE_S = 0.05
CLASS_DB = -141.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's small tensor ops on one thread: the suite runs
    several workers at once, and torch's thread pool would spin on each
    tiny op (about 5x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_id(cfg):
    return "{}-{}-tb{:g}".format(*cfg[:3])


@functools.lru_cache(maxsize=None)
def _case(cfg):
    """Input, out_len, the oracle's output and the edge skip."""
    src, dst, tb, atten = cfg
    n = 12000
    x = np.stack([lcg_uniform(101 + c, n) for c in range(2)]).astype(
        np.float32)
    out_len = int(np.floor(n * dst / src))
    orc = np.stack([OracleResampler(src, dst, 4096, tb, atten, 0).oneshot(
        x[c].astype(np.float64), out_len) for c in range(2)])
    return x, out_len, orc, int(EDGE_S * dst)


@functools.lru_cache(maxsize=None)
def _ref_chain(cfg, conv_engine, frac_engine, precision):
    """The reference's chain on _case(cfg)'s input.  At 2 channels its
    "pallas" engines run their toeplitz and im2col fallbacks (no TPU
    channel tile fits), so they share the "auto" engines' run."""
    if "pallas" in (conv_engine, frac_engine):
        return _ref_chain(cfg, "auto" if conv_engine == "pallas"
                          else conv_engine, "auto" if frac_engine == "pallas"
                          else frac_engine, precision)
    x, out_len, _orc, _skip = _case(cfg)
    ref = RefResampler(*cfg, 0, dtype="float32", fused=False,
                       precision=precision, conv_engine=conv_engine,
                       frac_engine=frac_engine)
    return np.asarray(ref.oneshot(x, out_len), np.float64)


def _run(cfg, **kw):
    x, out_len, _orc, _skip = _case(cfg)
    rs = Resampler(*cfg, fused=False, device="cpu", **kw)
    y = rs.oneshot(x, out_len)
    assert y.dtype == torch.float32 and y.shape == (2, out_len)
    return rs, y.double().numpy()


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("frac_engine", FRAC_ENGINES)
@pytest.mark.parametrize("conv_engine", CONV_ENGINES)
@pytest.mark.parametrize("cfg", CHAINS, ids=_cfg_id)
def test_chain_vs_oracle_and_reference(cfg, conv_engine, frac_engine,
                                       precision):
    x, out_len, orc, skip = _case(cfg)
    kw = dict(precision=precision, conv_engine=conv_engine,
              frac_engine=frac_engine)
    rs, y = _run(cfg, **kw)
    want_conv = "toeplitz" if conv_engine == "auto" else conv_engine
    want_frac = "im2col" if frac_engine == "auto" else frac_engine
    assert [(type(e), e.engine) for e in rs.execs] \
        == [(ConvExec, want_conv), (FracWholeExec, want_frac)]
    y_ref = _ref_chain(cfg, conv_engine, frac_engine, precision)
    s = slice(skip, -skip)
    db, ref_db = rms_db(y[:, s] - orc[:, s]), rms_db(y_ref[:, s] - orc[:, s])
    assert db < ref_db + 1.0, (db, ref_db)
    if not (conv_engine == "direct" and precision == "fast"):
        assert db < CLASS_DB, (db, ref_db)
    # the two chains' float32 errors are independent: they agree within
    # the class
    assert rms_db(y[:, s] - y_ref[:, s]) < -135.0


@pytest.mark.parametrize("frac_engine", ["pallas", "conv"])
@pytest.mark.parametrize("cfg", CHAINS, ids=_cfg_id)
def test_frac_engines_are_one_contraction(cfg, frac_engine):
    """The interpolator's "pallas" and "conv" engines make im2col's call:
    the chains are bit-equal."""
    _rs, y = _run(cfg, precision="high", frac_engine=frac_engine)
    _rs, y_auto = _run(cfg, precision="high")
    assert np.array_equal(y, y_auto)


@pytest.mark.parametrize("conv_engine", ["auto", "toeplitz_sym"])
@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("cfg", CHAINS, ids=_cfg_id)
def test_raw_seam_equals_sliced_stages(cfg, precision, conv_engine):
    """The chain hands the conv stage's raw buffer (the toeplitz engine's
    whole blocks, past the logical length) to the interpolator: bit-equal
    to running each stage on its predecessor's logical output."""
    x, out_len, _orc, _skip = _case(cfg)
    rs, y = _run(cfg, precision=precision, conv_engine=conv_engine)
    T = max(x.shape[1], rs.in_len_for_out(out_len))
    v = torch.nn.functional.pad(torch.from_numpy(x), (0, T - x.shape[1]))
    conv, frac = rs.execs
    raw, m = conv.apply_v(v, T)
    assert m == conv.out_len(T)
    assert (raw.shape[1] > m) == (conv.engine == "toeplitz")
    y_sliced = frac.apply(conv.apply(v))[:, :out_len]
    assert np.array_equal(y_sliced.double().numpy(), y)


GOLDENS = load_manifest()


@pytest.mark.parametrize("cfg", GOLDENS, ids=[c["label"] for c in GOLDENS])
def test_goldens_on_toeplitz_sym(cfg, monkeypatch):
    """Every C++ golden within -141 dB on the unfused float32 chain with
    conv_engine="toeplitz_sym" (half-band and polynomial stages on their
    "auto" engines); a kernel that does not fold (min-phase, or phase
    rows that are not palindromes) takes the traced fallback to
    "toeplitz", as in the reference."""
    events = []
    monkeypatch.setattr(stages, "trace", lambda ev, **kw: events.append(ev))
    x = lcg_uniform(cfg["seed"], cfg["inlen"])
    _lf, _q, ref = load_golden(cfg["file"])
    rs = Resampler(cfg["src"], cfg["dst"], cfg["tb"], cfg["atten"],
                   cfg["phase"], fused=False, conv_engine="toeplitz_sym",
                   device="cpu")
    ref_stages = ref_make_plan(cfg["src"], cfg["dst"], cfg["tb"],
                               cfg["atten"], cfg["phase"]).stages
    convs = [i for i, s in enumerate(rs.plan.stages) if s.kind == "conv"]
    fallbacks = 0
    for i in convs:
        k = np.asarray(rs.plan.stages[i].filt.kernel)
        symmetric = np.array_equal(k, k[::-1])
        # the reference's choice: a symmetric kernel whose phase rows are
        # not palindromes (up = 3 with down = 2 or 4) falls back too
        want = RefConvExec(ref_stages[i], jnp.float32, precision="fast",
                           engine="toeplitz_sym").engine
        assert rs.execs[i].engine == want
        assert symmetric or want == "toeplitz"
        fallbacks += want == "toeplitz"
    assert events == ["conv_toeplitz_sym_fallback"] * fallbacks
    y = rs.oneshot(x, cfg["outlen"]).double().numpy()
    assert rms_db(y - ref) < CLASS_DB, cfg["label"]
