"""The differential fuzzer's thinnest margins, pinned through the port.

tests/test_fuzzer_pins.py's four configurations (the reference fuzzer's
worst pairs, tests/test_differential_slow.py; ``tools/torch_fuzz.py``
``PINS``, where the faults of the port's own sweeps join them) on the
port on the CPU, at
the reference's bounds against the port's float64 oracle: the guarantee
chain (ozaki engines, df32 carry) at -150 dB relative, the float32 "fast"
chain at -115.  Each also runs through the reference's ``Resampler``
with the same options on the same input and plan, and port against JAX
is held at -112 dB relative (the reference fuzzer's f32 <-> oz triangle
bound).
"""

import numpy as np
import pytest
import torch

from r8brain_torch import plan_from_reference

from tools import torch_fuzz

from .helpers import rms_db

#: port against the reference package's chain, relative
JAX_DB = -112.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pin", torch_fuzz.PINS,
                         ids=[p[0] for p in torch_fuzz.PINS])
def test_fuzzer_worst_config_pinned(pin):
    import jax.numpy as jnp

    from r8brain_tpu.models.plan import make_plan as ref_make_plan
    from r8brain_tpu.models.resampler import Resampler as RefResampler

    _label, cfg, ex, bound, n, _seed = pin
    ref_plan = ref_make_plan(*cfg)
    y, ref = torch_fuzz.run_pin(pin, "cpu", plan_from_reference(ref_plan))
    d = torch_fuzz.rel_db(y, ref)
    assert d < bound, f"{d:.1f} dB"
    x32 = torch_fuzz.pin_input(pin)
    yj = np.asarray(RefResampler(*cfg, dtype=jnp.float32, plan=ref_plan,
                                 **torch_fuzz.OPTIONS[ex])
                    .oneshot(x32, y.shape[0]), np.float64)
    dj = torch_fuzz.rel_db(y, yj)
    assert dj < JAX_DB, f"port vs JAX {dj:.1f} dB"


@pytest.mark.parametrize("pin", torch_fuzz.CLASS_PINS,
                         ids=[p[0] for p in torch_fuzz.CLASS_PINS])
def test_class_fault_pinned(pin):
    """The faults the port's sweep found at the sold class (a float32
    executor above -141 dB re full scale on the card, its CPU model
    within): the CPU path holds the class against the oracle, and the port
    is within -112 dB relative of the reference's float32 chain with the
    executor's options (a stream's: the f32 chain's)."""
    import jax.numpy as jnp

    from r8brain_tpu.models.plan import make_plan as ref_make_plan
    from r8brain_tpu.models.resampler import Resampler as RefResampler

    _label, cfg, ex, bound, _n, _seed = pin
    ref_plan = ref_make_plan(*cfg)
    y, ref = torch_fuzz.run_pin(pin, "cpu", plan_from_reference(ref_plan))
    d = rms_db(y - ref)
    assert d < bound, f"{d:.2f} dB re full scale"
    yj = np.asarray(RefResampler(*cfg, dtype=jnp.float32, plan=ref_plan,
                                 **torch_fuzz.OPTIONS.get(ex, {}))
                    .oneshot(torch_fuzz.pin_input(pin), y.shape[0]),
                    np.float64)
    dj = torch_fuzz.rel_db(y, yj)
    assert dj < JAX_DB, f"port vs JAX {dj:.1f} dB"


#: each executor's frac_whole fold: (src, dst, tb, atten, precision, each
#: executor's fold).  No chain rule folds a chain at 16: the big-pair fold
#: sums are exact (ops/pallas_frac.py), so a chain of any length holds its
#: class at 32; under "high" the half-band (not the cascade) and frac
#: stages fold 16 of their own
FOLDS = [
    ((44100, 96000, 2.0, 180.15), "fast", [32]),
    ((44100, 192000, 2.0, 180.15), "fast", [32, 32, 32]),
    ((44100, 192000, 2.0, 180.15), "high", [32, 32, 16]),
    ((44100, 96001, 2.0, 180.15), "fast", [32, None, 32]),
    ((44100, 352800.3, 2.0, 180.15), "fast", [32, None, 32, 32]),
    ((96000, 2822400, 2.0, 180.15), "high", [32, 32, 32]),
    ((44100, 2822400, 2.0, 180.15), "fast", [32, 32]),
    ((2822400, 96000, 2.0, 180.15), "fast", [32, 32, 32, 32]),
    ((2822400, 96000, 2.0, 180.15), "high", [16, 16, 16, 32]),
    ((2822400, 44100, 2.0, 180.15), "fast", [32] * 6),
    ((44100.0, 328545.0, 1.383, 194.9), "fast", [32, 32, 32]),
]


@pytest.mark.parametrize("cfg,precision,folds", FOLDS,
                         ids=[f"{c[0]:g}-{c[1]:g}-{p}" for c, p, _f in FOLDS])
def test_chain_fold_rule(cfg, precision, folds):
    """Each executor's frac_whole fold, its own whatever the chain's
    length or last stage (a polynomial stage has none)."""
    from r8brain_torch import Resampler

    rs = Resampler(*cfg, 0, precision=precision, device="cpu")
    assert [getattr(getattr(e, "op", None), "kc", None)
            for e in rs.execs] == folds, \
        [type(e).__name__ for e in rs.execs]


def test_chain_fold_rule_in_stream_sub_chains():
    """A stream's own sub-chain executors (a run of a fused parent's
    stages, built anew) fold as the parent's executors do: 96k ->
    2.8224M's run after its fused pair is [conv, cascade], each at 32 as
    in the parent's three-executor chain."""
    from r8brain_torch import Resampler
    from r8brain_torch.models.stream import _sub_execs

    rs = Resampler(96000, 2822400, 2.0, 180.15, 0, device="cpu")
    sub = _sub_execs(rs, rs.plan.stages[2:])
    assert [type(e).__name__ for e in sub] == ["ConvExec", "HBUpCascadeExec"]
    assert [e.op.kc for e in sub] == [32, 32]
    assert [e.op.kc for e in rs.execs[1:]] == [32, 32]
