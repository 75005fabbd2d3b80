"""The port's framed-matmul kernel module (r8brain_torch/ops/pallas_frac.py).

On the CPU ``frac_whole`` runs its plain version ``frac_whole_ref``; these
tests hold that against the reference package's Pallas kernel (interpreter
mode, the way tests/test_pallas.py runs it) and against numpy in float64,
and show that the float32 accuracy model -- the kernel's KC-term chunks
folded with two_sum -- holds the -141 dB class on the flagship operator.
The CUDA kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.ops.pallas_frac import HAVE_PALLAS, frac_whole_pallas
from r8brain_torch.ops.fused import FusedUpExec
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops.pallas_frac import (KC, KC_LO, frac_whole,
                                           frac_whole_ref)
from r8brain_torch.ops.stages import FracWholeExec

from .helpers import rms_db

# (label, Q, I, D, O) of tests/test_pallas.py
SHAPES = [("aligned", 8, 64, 772, 128), ("unaligned", 8, 147, 171, 160)]
IDS = [s[0] for s in SHAPES]


def _inputs(I, D, O, n_win, C, seed, lo=False):
    rng = np.random.default_rng(seed)
    L = (n_win - 1) * I + D
    xp = rng.standard_normal((C, L))
    skT = rng.standard_normal((D, O))
    skT_lo = rng.standard_normal((D, O)) * 2.0**-24 if lo else None
    return xp, skT, skT_lo


def _numpy_ref(xp, skT, I, D, n_win):
    return np.concatenate([xp[:, m * I : m * I + D] @ skT
                           for m in range(n_win)], axis=1)


def _max_rel(y, ref):
    return np.abs(np.asarray(y, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.skipif(not HAVE_PALLAS, reason="no pallas")
@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_matches_reference_pallas_kernel(shape, lo):
    _label, Q, I, D, O = shape
    C, n_blocks = 128, 4
    n_win = n_blocks * Q
    xp, skT, skT_lo = _inputs(I, D, O, n_win, C, seed=0, lo=lo)
    f32 = np.float32
    y_ref = frac_whole_pallas(
        jnp.asarray(xp, f32), jnp.asarray(skT, f32), Q, I, D, O, CT=128,
        interpret=True,
        skT_lo=None if skT_lo is None else jnp.asarray(skT_lo, f32))
    y = frac_whole(torch.tensor(xp, dtype=torch.float32),
                   torch.tensor(skT, dtype=torch.float32), I, D, O, n_win,
                   skT_lo=None if skT_lo is None
                   else torch.tensor(skT_lo, dtype=torch.float32))
    assert y.shape == (C, n_win * O) and y.dtype == torch.float32
    y_ref = np.asarray(y_ref, np.float64)
    assert _max_rel(y.numpy(), y_ref) < 1e-5


@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f64_matches_numpy(shape, lo):
    _label, _Q, I, D, O = shape
    C, n_win = 5, 9
    xp, skT, skT_lo = _inputs(I, D, O, n_win, C, seed=1, lo=lo)
    ref = _numpy_ref(xp, skT, I, D, n_win)
    if lo:
        ref = ref + _numpy_ref(xp, skT_lo, I, D, n_win)
    # the last window must end exactly at the end of xp
    assert (n_win - 1) * I + D == xp.shape[1]
    y = frac_whole_ref(torch.from_numpy(xp), torch.from_numpy(skT), I, D, O,
                       n_win, skT_lo=None if skT_lo is None
                       else torch.from_numpy(skT_lo))
    assert y.dtype == torch.float64
    assert _max_rel(y.numpy(), ref) < 1e-12


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_model_tracks_f64(shape):
    """The chunked float32 model against float64 on awkward sizes: C not a
    multiple of 8, D not a multiple of KC, and an xp longer than needed."""
    _label, _Q, I, D, O = shape
    assert D % KC != 0
    C, n_win = 3, 7
    xp, skT, skT_lo = _inputs(I, D, O, n_win, C, seed=2, lo=True)
    xp = np.pad(xp, ((0, 0), (0, 11)))
    ref = (_numpy_ref(xp, skT, I, D, n_win)
           + _numpy_ref(xp, skT_lo, I, D, n_win))
    y = frac_whole(*(torch.tensor(a, dtype=torch.float32)
                     for a in (xp, skT)), I, D, O, n_win,
                   skT_lo=torch.tensor(skT_lo, dtype=torch.float32))
    assert _max_rel(y.numpy(), ref) < 1e-5


@pytest.fixture(scope="module")
def flagship_exec():
    return FusedUpExec(make_plan(44100, 96000, 2.0, 180.15, 0), torch.float32)


def test_f32_model_holds_class_on_flagship(flagship_exec):
    """Full-scale uniform input through the flagship operator: the
    KC-chunked two_sum model stays under -141 dB against float64 (a single
    running float32 sum over D = 1027 terms would not)."""
    ex = flagship_exec
    I, D, O = ex.p_in, ex.D, ex.p_out
    assert (I, D, O) == (294, 1027, 640)
    C, n_win = 4, 60
    rng = np.random.default_rng(3)
    xp = rng.uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    x32 = torch.tensor(xp, dtype=torch.float32)
    y = frac_whole(x32, ex.skT, I, D, O, n_win).double()
    ref = frac_whole_ref(torch.from_numpy(xp), ex.skT.double(), I, D, O,
                         n_win)
    d = rms_db((y - ref).numpy())
    assert d < -141.0, d
    # the same data summed in one running float32 pass misses the class
    xw = x32.unfold(1, D, I)[:, :n_win]
    naive = torch.zeros(C, n_win, O)
    for k in range(D):
        naive += xw[:, :, k : k + 1] * ex.skT[k]
    assert rms_db((naive.reshape(C, -1).double() - ref).numpy()) > d + 3.0


def test_rejects_bad_arguments():
    xp = torch.zeros(2, 100)
    skT = torch.zeros(40, 8)
    with pytest.raises(ValueError, match="windows"):
        frac_whole(xp, skT, 10, 40, 8, 8)  # needs 110 samples
    with pytest.raises(ValueError):
        frac_whole(xp, skT, 10, 41, 8, 2)  # skT shape != [D, O]
    with pytest.raises(TypeError):
        frac_whole(xp.double(), skT, 10, 40, 8, 2)
    with pytest.raises(ValueError):
        frac_whole(xp, skT, 10, 40, 8, 2, skT_lo=torch.zeros(40, 7))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        frac_whole(xp.to("meta"), skT.to("meta"), 10, 40, 8, 2)
    with pytest.raises(ValueError, match="kc"):
        frac_whole(xp, skT, 10, 40, 8, 2, kc=16)


def test_cpu_tensor_runs_plain_version_uncounted():
    before = frac_whole.launches
    xp, skT, _ = _inputs(147, 171, 160, 3, 2, seed=4)
    y = frac_whole(torch.from_numpy(xp), torch.from_numpy(skT), 147, 171,
                   160, 3)
    ref = frac_whole_ref(torch.from_numpy(xp), torch.from_numpy(skT), 147,
                         171, 160, 3)
    assert torch.equal(y, ref)
    assert frac_whole.launches == before


@pytest.fixture(scope="module")
def frac_stage_exec():
    """The im2col interpolator of 44.1k -> 96k under "high" (D=170, I=147,
    O=160, ~24 nonzero taps a column)."""
    frac = make_plan(44100, 96000, 2.0, 180.15, 0).stages[1]
    return FracWholeExec(frac, torch.float32, "high", engine="im2col")


@pytest.mark.parametrize("kc", [KC_LO, KC])
def test_fold_length_on_the_frac_stage(frac_stage_exec, kc):
    """Both fold lengths hold the -141 dB class on the frac stage's
    operator against its float64 product; the stage's 8-term fold (what
    its executor asks for) gains over 2 dB on the 32-term one (about 3 dB
    measured, -149.8 against -146.8 dB re full scale)."""
    ex = frac_stage_exec
    assert ex.kc == KC_LO
    D, I, O = ex.D, ex.spec.in_step, ex.spec.out_step
    C, n_win = 2, 300
    xp = np.random.default_rng(7).uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    x32 = torch.tensor(xp, dtype=torch.float32)
    ref = frac_whole_ref(x32.double(), ex.skT.double(), I, D, O, n_win,
                         skT_lo=ex.skT_lo.double())

    def err_db(k):
        y = frac_whole(x32, ex.skT, I, D, O, n_win, skT_lo=ex.skT_lo, kc=k)
        return rms_db((y.double() - ref).numpy())

    d = err_db(kc)
    assert d < -141.0, d
    if kc == KC_LO:
        assert d < err_db(KC) - 2.0

