"""The port's framed-matmul kernel module (r8brain_torch/ops/pallas_frac.py).

On the CPU ``frac_whole`` runs its plain version ``frac_whole_ref``; these
tests hold that against the reference package's Pallas kernel (interpreter
mode, the way tests/test_pallas.py runs it) and against numpy in float64,
and show that the float32 accuracy model -- the kernel's three-slice bf16
split, the big pair in KC-term chunks folded with two_sum -- is exact
where it says so and holds the -141 dB class on the flagship operator and
the frac stage.  The CUDA kernel itself is held to its plain version on
the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.ops.pallas_frac import HAVE_PALLAS, frac_whole_pallas
from r8brain_torch.ops.fused import FusedUpExec
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops.pallas_frac import (KC, KC_LO, TILE_K, _swizzle,
                                           frac_whole, frac_whole_ref,
                                           operator_parts, split3,
                                           unpack_parts)
from r8brain_torch.ops.dfloat import two_sum
from r8brain_torch.ops.framing import _framed_matmul, _frames
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


def _parts(skT, skT_lo=None, dtype=torch.float32):
    """operator_parts of numpy operators in ``dtype``."""
    return operator_parts(torch.tensor(skT, dtype=dtype),
                          None if skT_lo is None
                          else torch.tensor(skT_lo, dtype=dtype))


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
                   _parts(skT, skT_lo), I, D, O, n_win)
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
    y = frac_whole_ref(torch.from_numpy(xp),
                       _parts(skT, skT_lo, torch.float64), I, D, O, n_win)
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
    y = frac_whole(torch.tensor(xp, dtype=torch.float32),
                   _parts(skT, skT_lo), I, D, O, n_win)
    assert _max_rel(y.numpy(), ref) < 1e-5


@pytest.fixture(scope="module")
def flagship_exec():
    return FusedUpExec(make_plan(44100, 96000, 2.0, 180.15, 0), torch.float32)


def _chunked_f32(x32, skT, I, D, O, n_win, kc):
    """The previous float32 model: kc-term float32 chunks of x * skT
    folded with two_sum (the CUDA-core kernel's arithmetic)."""
    hi = lo = None
    for d0 in range(0, D, kc):
        d1 = min(D, d0 + kc)
        acc = torch.matmul(_frames(x32[:, d0:], n_win, I, d1 - d0),
                           skT[d0:d1])
        if hi is None:
            hi, lo = acc, torch.zeros_like(acc)
        else:
            hi, e = two_sum(hi, acc)
            lo = lo + e
    return (hi + lo).reshape(x32.shape[0], n_win * O)


def test_f32_model_holds_class_on_flagship(flagship_exec):
    """Full-scale uniform input through the flagship operator: the split
    model stays under -141 dB against float64 at both fold lengths, and
    reads at least 3 dB better than the previous chunked float32 sum on
    the same data (-152.3 / -149.9 dB at 16 / 32 terms against -144.5);
    a single running float32 sum over D = 1027 terms misses the class."""
    ex = flagship_exec
    I, D, O = ex.p_in, ex.D, ex.p_out
    assert (I, D, O) == (294, 1027, 640)
    C, n_win = 4, 60
    rng = np.random.default_rng(3)
    xp = rng.uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    x32 = torch.tensor(xp, dtype=torch.float32)
    ref = frac_whole_ref(torch.from_numpy(xp),
                         operator_parts(ex.skT.double()), I, D, O, n_win)
    old = rms_db((_chunked_f32(x32, ex.skT, I, D, O, n_win, KC).double()
                  - ref).numpy())
    for kc in (KC_LO, KC):
        y = frac_whole(x32, ex.sk_parts, I, D, O, n_win, kc=kc).double()
        db = rms_db((y - ref).numpy())
        assert db < -141.0 and db < old - 3.0, (kc, db, old)
        if kc == KC:
            d = db
    # the same data summed in one running float32 pass misses the class
    xw = x32.unfold(1, D, I)[:, :n_win]
    naive = torch.zeros(C, n_win, O)
    for k in range(D):
        naive += xw[:, :, k : k + 1] * ex.skT[k]
    assert rms_db((naive.reshape(C, -1).double() - ref).numpy()) > d + 3.0


def test_rejects_bad_arguments():
    xp = torch.zeros(2, 100)
    skT = torch.zeros(40, 8)
    parts = operator_parts(skT)
    with pytest.raises(ValueError, match="windows"):
        frac_whole(xp, parts, 10, 40, 8, 8)  # needs 110 samples
    with pytest.raises(ValueError, match="parts"):
        frac_whole(xp, parts, 10, 70, 8, 2)  # packed for D <= 64
    with pytest.raises(TypeError):
        frac_whole(xp.double(), parts, 10, 40, 8, 2)
    with pytest.raises(TypeError):
        frac_whole(xp, operator_parts(skT.double()), 10, 40, 8, 2)
    with pytest.raises(ValueError):
        operator_parts(skT, torch.zeros(40, 7))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        frac_whole(xp.to("meta"), parts, 10, 40, 8, 2)
    with pytest.raises(ValueError, match="kc"):
        frac_whole(xp, parts, 10, 40, 8, 2, kc=8)


def test_cpu_tensor_runs_plain_version_uncounted():
    before = frac_whole.launches
    xp, skT, _ = _inputs(147, 171, 160, 3, 2, seed=4)
    parts = operator_parts(torch.from_numpy(skT))
    y = frac_whole(torch.from_numpy(xp), parts, 147, 171, 160, 3)
    ref = frac_whole_ref(torch.from_numpy(xp), parts, 147, 171, 160, 3)
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
    operator against its float64 product.  The stage's 16-term fold (what
    its executor asks for) gains over 1 dB on the 32-term one (-150.46
    against -148.93 dB re full scale measured) and reads better than the
    previous chunked float32 model's 8-term fold (-149.85); the 32-term
    fold better than that model's (-146.8)."""
    ex = frac_stage_exec
    assert ex.kc == KC_LO
    D, I, O = ex.D, ex.spec.in_step, ex.spec.out_step
    C, n_win = 2, 300
    xp = np.random.default_rng(7).uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    x32 = torch.tensor(xp, dtype=torch.float32)
    ref = frac_whole_ref(x32.double(), operator_parts(
        ex.skT.double(), ex.skT_lo.double()), I, D, O, n_win)

    def err_db(k):
        y = frac_whole(x32, ex.sk_parts, I, D, O, n_win, kc=k)
        return rms_db((y.double() - ref).numpy())

    d = err_db(kc)
    assert d < -141.0, d
    if kc == KC_LO:
        assert d < err_db(KC) - 1.0 and d < -149.85, d
    else:
        assert d < -148.0, d



def test_split_is_exact_on_random_float32():
    """x0 + x1 + x2 == x, each slice a bfloat16 value at most 2^-8 of the
    one before, for uniform samples and Gaussians over 2^-60 .. 2^60."""
    rng = np.random.default_rng(20)
    n = 50000
    x = np.concatenate([rng.uniform(-1.0, 1.0, n),
                        rng.standard_normal(n)
                        * np.exp2(rng.integers(-60, 61, n))])
    x = torch.from_numpy(x.astype(np.float32))
    parts = split3(x)
    for p in parts:
        assert p.dtype == torch.float32
        assert torch.equal(p, p.to(torch.bfloat16).float())
    x0, x1, x2 = (p.double() for p in parts)
    assert torch.equal(x0 + x1 + x2, x.double())
    assert bool((x1.abs() <= x0.abs() * 2.0**-8).all())
    assert bool((x2.abs() <= x1.abs() * 2.0**-8).all())


_F32_MAX = float(np.finfo(np.float32).max)
_BF16_MAX = float(torch.finfo(torch.bfloat16).max)
# (value, exact): where the split is exact and where it is not
EDGES = ([(0.0, True), (-0.0, True), (_BF16_MAX, True), (-_BF16_MAX, True),
          # the largest finite floats round to infinity in bfloat16
          (_F32_MAX, False), (-_F32_MAX, False),
          # a residual below bfloat16's subnormal step (2^-133) is lost
          (2.0**-126 * (1 + 2.0**-23), False), (3 * 2.0**-140, False),
          (2.0**-100 * (1 + 2.0**-23), True), (2.0**-126, True)]
         + [(sg * 2.0**k, True) for k in (-126, -60, -1, 0, 1, 60, 127)
            for sg in (1.0, -1.0)])


@pytest.mark.parametrize("value,exact", EDGES,
                         ids=[f"{v:.3g}" for v, _ in EDGES])
def test_split_edge_values(value, exact):
    x = torch.tensor([value], dtype=torch.float32)
    x0, x1, x2 = split3(x)
    total = x0.double() + x1.double() + x2.double()
    assert bool(torch.equal(total, x.double())) == exact
    if exact:
        assert torch.equal(torch.signbit(x0), torch.signbit(x))


def test_operator_split_on_flagship(flagship_exec):
    """The flagship operator splits exactly but for a few tiny taps, whose
    third slice falls below bfloat16's normal range (4 of 657280, all
    below 2^-100)."""
    skT = flagship_exec.skT
    s = unpack_parts(flagship_exec.sk_parts, *skT.shape)
    bad = s.double().sum(dim=0) != skT.double()
    assert int(bad.sum()) <= 8
    assert bool((skT[bad].abs() < 2.0**-100).all())


# (D, O, lo, BN): the flagship's (the 128-column tile), the frac stage's
# (64: 128 would pad 160 to 256), the direct stage's (O = 2: the 8-column
# tile with the side-by-side slices) and an odd one (D no multiple of 16,
# O of 8)
PACK_SHAPES = [(1027, 640, False, 128), (170, 160, True, 64),
               (709, 2, True, 8), (21, 9, False, 64)]


@pytest.mark.parametrize("D,O,lo,BN", PACK_SHAPES,
                         ids=[f"{d}x{o}{'-lo' if lo else ''}"
                              for d, o, lo, _ in PACK_SHAPES])
def test_operator_parts_layout(D, O, lo, BN):
    """operator_parts: [col tiles, k-tiles, P, BN, 64] bfloat16 (P + 1 for
    the 8-column tile), zero past D and O, unpacking to the slices; tile
    rows 128-byte swizzled (the 16-byte chunk c of row n at c ^ (n % 8));
    the 8-column tile's last holds slice p's column j at column 2p + j."""
    rng = np.random.default_rng(D + O)
    skT = torch.tensor(rng.standard_normal((D, O)), dtype=torch.float32)
    skT_lo = (torch.tensor(rng.standard_normal((D, O)) * 2.0**-24,
                           dtype=torch.float32) if lo else None)
    parts = operator_parts(skT, skT_lo)
    assert parts.dtype == torch.bfloat16
    assert parts.shape == (-(-O // BN), -(-D // TILE_K), 3 + lo + (BN == 8),
                           BN, TILE_K)
    s = unpack_parts(parts, D, O)
    want = list(split3(skT))
    if lo:
        want.append(skT_lo.to(torch.bfloat16).float())
    assert torch.equal(s, torch.stack(want))
    assert torch.equal(_swizzle(_swizzle(parts)), parts)
    # element (d, j) = (8, 1) of slice 0: tile row n = 1, chunk 1 -> 0
    assert parts[0, 0, 0, 1, 0] == want[0][8, 1].to(torch.bfloat16)
    # everything past D and O is zero
    full = unpack_parts(parts, parts.shape[1] * TILE_K, parts.shape[0] * BN)
    assert not bool(full[:, D:].any()) and not bool(full[:, :, O:].any())
    if BN == 8:
        side = _swizzle(parts)[0, :, -1].transpose(1, 2).reshape(-1, BN)
        for p, w in enumerate(want):
            assert torch.equal(side[:D, 2 * p : 2 * p + O].float(), w)
        assert not bool(side[D:].any())


# (I, D, O, C): the direct stage's geometry (O = 2), an odd one (D no
# multiple of 16, O of 8), and the toeplitz stage's, each at C no multiple
# of 64
PAD_CASES = [(1, 709, 2, 67), (3, 37, 9, 67), (256, 964, 512, 5)]


@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("case", PAD_CASES,
                         ids=[f"I{c[0]}-D{c[1]}-O{c[2]}" for c in PAD_CASES])
def test_padded_operator_edges(case, lo):
    """The model on the packed slices equals the model on the unpadded
    split (a plain chunked sum of split3's slices), and holds 1e-5 of max
    |y| against float64, at the padded geometries."""
    I, D, O, C = case
    n_win = 7
    xp, skT, skT_lo = _inputs(I, D, O, n_win, C, seed=21, lo=lo)
    x32 = torch.tensor(xp, dtype=torch.float32)
    parts = _parts(skT, skT_lo)
    s = list(split3(torch.tensor(skT, dtype=torch.float32)))
    if lo:
        s.append(torch.tensor(skT_lo, dtype=torch.float32).to(
            torch.bfloat16).float())
    x0, x1, x2 = split3(x32)
    small = (_framed_matmul(x0, s[1] + s[2], n_win, I)
             + _framed_matmul(x1, s[0] + s[1], n_win, I)
             + _framed_matmul(x2, s[0], n_win, I))
    if lo:
        small = small + _framed_matmul(x0, s[3], n_win, I)
    for kc in (KC_LO, KC):
        y = frac_whole(x32, parts, I, D, O, n_win, kc=kc)
        hi = lo_ = None
        for d0 in range(0, D, kc):
            d1 = min(D, d0 + kc)
            acc = torch.matmul(_frames(x0[:, d0:], n_win, I, d1 - d0),
                               s[0][d0:d1])
            if hi is None:
                hi, lo_ = acc, torch.zeros_like(acc)
            else:
                hi, e = two_sum(hi, acc)
                lo_ = lo_ + e
        assert torch.equal(y, (hi + (lo_ + small)).reshape(C, -1))
        ref = _numpy_ref(xp, skT, I, D, n_win)
        if lo:
            ref = ref + _numpy_ref(xp, skT_lo, I, D, n_win)
        assert _max_rel(y.numpy(), ref) < 1e-5


def test_rejects_mismatched_parts():
    """An operator packed for another D, O or tile, or not packed at all,
    is refused."""
    xp, skT, _ = _inputs(10, 40, 8, 2, 2, seed=4)
    x32, s32 = (torch.tensor(a, dtype=torch.float32) for a in (xp, skT))
    with pytest.raises(ValueError, match="parts"):  # the 8-column tile
        frac_whole(x32, operator_parts(s32[:, :2]), 10, 40, 8, 2)
    with pytest.raises(ValueError, match="parts"):  # two k-tiles
        frac_whole(x32, operator_parts(torch.zeros(100, 8)), 10, 40, 8, 2)
    with pytest.raises(ValueError, match="parts"):  # three column tiles
        frac_whole(x32, operator_parts(torch.zeros(40, 160)), 10, 40, 8, 2)
    with pytest.raises(TypeError, match="operator_parts"):
        frac_whole(x32, s32, 10, 40, 8, 2)
