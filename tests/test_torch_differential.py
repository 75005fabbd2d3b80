"""The differential fuzzer's first 12 draws through the port on the CPU.

tools/torch_fuzz.py's trial loop (the reference's
tests/test_differential_slow.py, letter for letter) for draws 0-11,
three of each ratio family, each draw its own case: the port's orc, f32,
oz, stm and nat executors (nat only where a C++ toolchain exists, as in
the reference), and also high, fft and sym (each kernel through its plain
version here), on the plan the reference's planner makes, carried across
with ``plan_from_reference``; every pair at its bound (``BOUNDS``: the
reference's values, and the f32 chain's class for the card's three).  A
sixth executor, ``jax``, is the reference's float32 "fast" ``Resampler``
on the same plan and input, and port against JAX is held at -112 dB
relative (the reference fuzzer's f32 <-> oz triangle bound).  The ``sym``
executor runs exactly where the reference's stage executor keeps
``conv_engine="toeplitz_sym"`` on some conv stage.
"""

import shutil

import numpy as np
import pytest
import torch

from r8brain_torch import plan_from_reference

from tools import torch_fuzz

TRIALS = list(torch_fuzz.draws(12))
#: port's f32 chain against the reference package's, relative
JAX_DB = -112.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_f32(cfg, ref_plan):
    import jax.numpy as jnp

    from r8brain_tpu.models.resampler import Resampler

    def run(_cfg, _plan, x32, out_len):
        rs = Resampler(*cfg, dtype=jnp.float32, plan=ref_plan,
                       precision="fast")
        return np.asarray(rs.oneshot(x32, out_len), np.float64)
    return run


def _reference_keeps_sym(ref_plan) -> bool:
    import jax.numpy as jnp

    from r8brain_tpu.models.plan import ConvStage
    from r8brain_tpu.ops.stages import ConvExec

    return any(ConvExec(s, jnp.float32, engine="toeplitz_sym").engine
               == "toeplitz_sym" for s in ref_plan.stages
               if isinstance(s, ConvStage))


def test_draws_cover_every_family():
    """Draws 0-11 are three of each family, in the reference's order."""
    assert [t for t, _c, _n in TRIALS] == list(range(12))
    assert all(2500 <= n < 6000 for _t, _c, n in TRIALS)
    assert TRIALS[0][1] == (176161.78, 44100.0, 2.206, 170.51, 1)


@pytest.mark.parametrize("trial,cfg,n", TRIALS,
                         ids=[f"draw{t}" for t, _c, _n in TRIALS])
def test_differential_draw(trial, cfg, n):
    from r8brain_tpu.models.plan import make_plan as ref_make_plan

    ref_plan = ref_make_plan(*cfg)
    plan = plan_from_reference(ref_plan)
    executors = [e for e in torch_fuzz.BASE + torch_fuzz.CARD
                 if e != "nat" or shutil.which("g++") is not None]
    r = torch_fuzz.run_trial(trial, cfg, n, executors, "cpu", plan=plan,
                             extra={"jax": _jax_f32(cfg, ref_plan)})
    outs = r["outputs"]
    assert ("sym" in outs) == _reference_keeps_sym(ref_plan), cfg
    assert "fft" in outs or not any(s.kind == "conv" for s in plan.stages)
    for pair, d in r["pairs"].items():
        assert d < torch_fuzz.BOUNDS[pair], (pair, round(d, 2), cfg)
    want = {"orc_f32", "orc_oz", "f32_oz", "orc_stm", "f32_stm",
            "orc_high"} | ({"orc_nat", "f32_nat", "oz_nat"} if "nat" in
                           executors else set())
    assert want <= set(r["pairs"]), sorted(r["pairs"])
    dj = torch_fuzz.rel_db(outs["f32"], outs["jax"])
    assert dj < JAX_DB, (round(dj, 2), cfg)
    for y in outs.values():
        assert y.shape == (r["out_len"],) and np.isfinite(y).all()
