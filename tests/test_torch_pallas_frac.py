"""The port's framed-matmul kernel module (r8brain_torch/ops/pallas_frac.py).

On the CPU ``frac_whole`` runs its plain version ``frac_whole_ref``; these
tests hold that against the reference package's Pallas kernel (interpreter
mode, the way tests/test_pallas.py runs it) and against numpy in float64,
and show that the float32 accuracy model -- the kernel's three-slice bf16
split with its lead slices on fixed grids, the big pair in KC-term folds
folded with two_sum -- is exact where it says so (every big-pair fold
sum), unbiased, and holds the -141 dB class on the flagship operator and
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
from r8brain_torch.ops.pallas_frac import (KC, KC_LO, TILE_K, _fold_slices,
                                           _swizzle, adjoint_geometry,
                                           adjoint_parts, frac_whole,
                                           frac_whole_ref, operator_band,
                                           operator_parts, split3,
                                           split_grid, unpack_parts)
from r8brain_torch.ops.dfloat import two_sum
from r8brain_torch.ops.framing import _frames, shifted
from r8brain_torch.ops.stages import (ConvExec, FracWholeExec, HBDownExec,
                                      HBUpExec)

from tools import torch_frac_band, torch_frac_beta

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
    the same data (-151.73 dB at 16 and at 32 terms, its fold sums exact,
    against -144.5; the floating split, whose fold sums rounded, read
    -152.3 / -149.9); a single running float32 sum over D = 1027 terms
    misses the class."""
    ex = flagship_exec
    I, D, O = ex.p_in, ex.D, ex.p_out
    assert (I, D, O) == (294, 1027, 640)
    C, n_win = 4, 60
    rng = np.random.default_rng(3)
    xp = rng.uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    x32 = torch.tensor(xp, dtype=torch.float32)
    ref = frac_whole_ref(torch.from_numpy(xp),
                         operator_parts(ex.op.hi.double()), I, D, O, n_win)
    old = rms_db((_chunked_f32(x32, ex.op.hi, I, D, O, n_win, KC).double()
                  - ref).numpy())
    for kc in (KC_LO, KC):
        y = frac_whole(x32, ex.op.parts, I, D, O, n_win, kc=kc).double()
        db = rms_db((y - ref).numpy())
        assert db < -141.0 and db < old - 3.0, (kc, db, old)
        if kc == KC:
            d = db
    # the same data summed in one running float32 pass misses the class
    xw = x32.unfold(1, D, I)[:, :n_win]
    naive = torch.zeros(C, n_win, O)
    for k in range(D):
        naive += xw[:, :, k : k + 1] * ex.op.hi[k]
    assert rms_db((naive.reshape(C, -1).double() - ref).numpy()) > d + 3.0


def test_rejects_bad_arguments():
    xp = torch.zeros(2, 100)
    skT = torch.zeros(40, 8)
    parts = operator_parts(skT)
    with pytest.raises(ValueError, match="n_win"):
        frac_whole(xp, parts, 10, 40, 8, 0)  # no window
    with pytest.raises(TypeError):
        frac_whole(xp, parts, 10, 40, 8, 2, start=1.5)  # no column
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
    operator against its float64 product.  With every fold sum exact the
    fold length no longer moves the error (-155.16 dB re full scale at
    both, within 0.1 dB of each other), and each reads better than the
    floating split's 16-term fold, whose fold sums rounded (-150.46; at
    32 terms -148.93), and the previous chunked float32 model's 8-term
    fold (-149.85)."""
    ex = frac_stage_exec
    assert ex.op.kc == KC_LO
    D, I, O = ex.D, ex.spec.in_step, ex.spec.out_step
    C, n_win = 2, 300
    xp = np.random.default_rng(7).uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    x32 = torch.tensor(xp, dtype=torch.float32)
    ref = frac_whole_ref(x32.double(), operator_parts(
        ex.op.hi.double(), ex.op.lo.double()), I, D, O, n_win)

    def err_db(k):
        y = frac_whole(x32, ex.op.parts, I, D, O, n_win, kc=k)
        return rms_db((y.double() - ref).numpy())

    d = err_db(kc)
    assert d < -150.46, d
    assert abs(d - err_db(KC_LO + KC - kc)) <= 0.1, d



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


def _group_exponents(skT: torch.Tensor, run: int = KC) -> torch.Tensor:
    """[D, O] float64: F of each entry's (column, run-row group), 2^F above
    the group's largest |entry| (as split_grid takes it)."""
    D, O = skT.shape
    g = torch.nn.functional.pad(skT.abs(), (0, 0, 0, -D % run))
    m = g.reshape(-1, run, O).amax(1)
    F = torch.frexp(m).exponent.clamp(min=-125).double()
    return F.repeat_interleave(run, 0)[:D]


def _on_grids(s0: torch.Tensor, skT: torch.Tensor) -> bool:
    """Whether the lead slice s0 is k 2^(F-8), |k| <= 256, for each entry,
    F its group's (``_group_exponents``)."""
    k = s0.double() / torch.pow(2.0, _group_exponents(skT) - 8)
    return bool(((k == torch.round(k)) & (k.abs() <= 256)).all())


def test_operator_split_on_flagship(flagship_exec):
    """The flagship operator's lead slice lies on one grid for each column
    and 32-row group of D, k 2^(F-8) with |k| <= 256 and 2^F above the
    group's largest |entry|, and its three slices sum to within 2^(F-27)
    of each entry (rounded to nearest); most entries split exactly."""
    skT = flagship_exec.op.hi
    s = unpack_parts(flagship_exec.op.parts, *skT.shape)
    assert _on_grids(s[0], skT)
    err = (s.double().sum(dim=0) - skT.double()).abs()
    assert bool((err <= torch.pow(2.0, _group_exponents(skT) - 27)).all())
    assert float((err == 0).double().mean()) > 0.5


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
    the 8-column tile), zero past D and O, unpacking to the slices (the
    lead one on a grid for each column and KC-row group); tile
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
    want = list(split_grid(skT, dim=0, run=KC))
    assert _on_grids(want[0], skT)
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
    """The model on the packed slices equals, bit for bit, the model on
    the unpadded split followed fold by fold: split_grid's operator slices
    and window slices (one grid a window row and fold; at I = 1 with O <=
    2 one a 16-window group, zeros past the input's end), the big pair and
    the small pairs as one float32 matmul each a fold, two_sum, and the
    Fast2Sum at each TILE_K boundary; and it holds 1e-5 of max |y|
    against float64, at the padded geometries."""
    I, D, O, C = case
    n_win = 7
    xp, skT, skT_lo = _inputs(I, D, O, n_win, C, seed=21, lo=lo)
    x32 = torch.tensor(xp, dtype=torch.float32)
    parts = _parts(skT, skT_lo)
    s = list(split_grid(torch.tensor(skT, dtype=torch.float32), dim=0,
                        run=KC))
    rhs = [s[1] + s[2], s[0] + s[1], s[0]]
    if lo:
        rhs.append(torch.tensor(skT_lo, dtype=torch.float32).to(
            torch.bfloat16).float())
    rows = 16 if I == 1 and O <= 2 else 1
    n = -(-n_win // rows) * rows
    xz = torch.nn.functional.pad(x32[:, :(n_win - 1) * I + D],
                                 (0, (n - n_win) * I))
    for kc in (KC_LO, KC):
        y = frac_whole(x32, parts, I, D, O, n_win, kc=kc)
        hi = lo_ = None
        for d0 in range(0, D, kc):
            d1 = min(D, d0 + kc)
            k = d1 - d0
            fr = _frames(xz[:, d0:], n, I, k).reshape(C, n // rows, rows * k)
            x0, x1, x2 = (v.reshape(C, n, k)[:, :n_win]
                          for v in split_grid(fr, run=rows * k))
            r = slice(d0, d1)
            acc = torch.matmul(x0, s[0][r])
            sm = torch.matmul(torch.cat([x0, x1, x2, x0][:len(rhs)], -1),
                              torch.cat([t[r] for t in rhs]))
            if hi is None:
                hi, lo_ = acc, sm
            else:
                hi, e = two_sum(hi, acc)
                lo_ = (lo_ + sm) + e
            if d1 % TILE_K == 0:
                t = hi + lo_
                hi, lo_ = t, lo_ - (t - hi)
        assert torch.equal(y, (hi + lo_).reshape(C, -1))
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


# (label, I, D, O): adjoint geometries with D % I != 0, O <= 2 (the
# 8-column tile forward, the 8-column tile for O' = I <= 2 backward), D < I
# (K = 1), and a half-band upsampler's shape
ADJ_SHAPES = [("ragged", 7, 51, 12), ("o1", 3, 29, 1), ("o2", 5, 40, 2),
              ("i2", 2, 33, 9), ("d_lt_i", 9, 5, 6), ("hb_up", 128, 150, 256)]


def _adjoint_case(I, D, O, lo, dtype, seed):
    rng = np.random.default_rng(seed)
    C, n_win = 3, 5
    L = (n_win - 1) * I + D + 3
    x = torch.tensor(rng.uniform(-1, 1, (C, L)), dtype=dtype)
    w = torch.tensor(rng.uniform(-1, 1, (C, n_win * O)), dtype=dtype)
    skT = torch.tensor(rng.standard_normal((D, O)), dtype=dtype)
    skT_lo = (torch.tensor(rng.standard_normal((D, O)) * 2.0**-15,
                           dtype=dtype) if lo else None)
    return x, w, operator_parts(skT, skT_lo), n_win


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("kc", [KC_LO, KC])
@pytest.mark.parametrize("shape", ADJ_SHAPES, ids=[s[0] for s in ADJ_SHAPES])
def test_adjoint_model_vs_autograd(shape, kc, lo, dtype):
    """frac_whole's backward (frac_whole_ref on the adjoint geometry
    against the re-blocked operator: the model of the card's adjoint
    launch) against torch autograd through frac_whole_ref, within 2^-21 of
    max |xbar| in float32 (the split sums in another order) and 1e-13 in
    float64; no launch is counted on the CPU."""
    _label, I, D, O = shape
    x, w, parts, n_win = _adjoint_case(I, D, O, lo, dtype, I + D + O + kc)
    xr = x.clone().requires_grad_()
    (frac_whole_ref(xr, parts, I, D, O, n_win, kc) * w).sum().backward()
    xa = x.clone().requires_grad_()
    before = (frac_whole.launches, frac_whole.adjoint_launches)
    (frac_whole(xa, parts, I, D, O, n_win, kc) * w).sum().backward()
    assert (frac_whole.launches, frac_whole.adjoint_launches) == before
    scale = float(xr.grad.abs().max())
    tol = 2.0**-21 if dtype == torch.float32 else 1e-13
    assert float((xa.grad - xr.grad).abs().max()) <= tol * scale


@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("shape", ADJ_SHAPES, ids=[s[0] for s in ADJ_SHAPES])
def test_adjoint_operator_is_a_reblocking(shape, lo):
    """The adjoint's packed operator equals operator_parts of the
    transposed float32 operator T'[(K-1-k)*O + j, i] = T[k*I + i, j], T =
    s0 + s1 + s2 of the forward's slices (exact in float32), and
    bf16(skT_lo) re-blocked as it is, bit for bit: its slices sum to T'
    within 2^(F-27) (F of each (column, KC-row group) of the adjoint), its
    lead slice on the adjoint's own grids.  Built once per operator."""
    _label, I, D, O = shape
    _x, _w, parts, _n = _adjoint_case(I, D, O, lo, torch.float32, 4)
    Ia, Da, Oa, K = adjoint_geometry(I, D, O)
    assert (Ia, Da, Oa) == (O, K * O, I)
    s = unpack_parts(parts, D, O)
    skT = s[0] + s[1] + s[2]
    assert torch.equal(skT.double(), s[:3].double().sum(0))
    skT_lo = s[3] if lo else None
    Tt = torch.zeros((Da, Oa))
    Tt_lo = torch.zeros((Da, Oa))
    for k in range(K):
        for i in range(I):
            if k * I + i < D:
                Tt[(K - 1 - k) * O : (K - k) * O, i] = skT[k * I + i]
                if lo:
                    Tt_lo[(K - 1 - k) * O : (K - k) * O, i] = \
                        skT_lo[k * I + i]
    adj = adjoint_parts(parts, I, D, O)
    assert torch.equal(adj, operator_parts(Tt, Tt_lo if lo else None))
    sa = unpack_parts(adj, Da, Oa)
    assert _on_grids(sa[0], Tt)
    err = (sa[:3].double().sum(0) - Tt.double()).abs()
    assert bool((err <= torch.pow(2.0, _group_exponents(Tt) - 27)).all())
    if lo:
        assert torch.equal(sa[3], Tt_lo)
    assert adjoint_parts(parts, I, D, O) is adj


def _exec_operators():
    """(label, I, D, O, parts, skT64, kc) of the executors' float32
    frac_whole calls: the fused flagship, the toeplitz conv stage, the
    half-band upsampler (44.1k -> 192k) and decimator (192k -> 44.1k) and
    the direct conv stage, "fast", each at its executor's fold; skT64 the
    float64 operator whose function the split approximates."""
    p96 = make_plan(44100, 96000, 2.0, 180.15, 0)
    fu = FusedUpExec(p96, torch.float32)
    tp = ConvExec(p96.stages[0], torch.float32, "fast", engine="toeplitz")
    dr = ConvExec(p96.stages[0], torch.float32, "fast", engine="direct")
    hu = HBUpExec(make_plan(44100, 192000, 2.0, 180.15, 0).stages[-1],
                  torch.float32)
    hd = HBDownExec(make_plan(192000, 44100, 2.0, 180.15, 0).stages[0],
                    torch.float32)
    return [("flagship", fu.p_in, fu.D, fu.p_out, fu.op.parts, fu.op.hi,
             KC),
            ("toeplitz", tp.B_toep * tp.spec.down, *tp.op.hi.shape,
             tp.op.parts, tp.op.hi, tp.op.kc),
            ("hb_up", hu._geometry(1000)[2], hu.op.L_f, hu.op.Kcols,
             hu.op.parts, hu.op.hi, hu.op.kc),
            ("hb_down", hd._geometry(1000)[2], hd.op.L_f, hd.op.Kcols,
             hd.op.parts, hd.op.hi, hd.op.kc),
            ("direct", dr.spec.down, *dr.skT_direct.shape,
             dr.op.parts, dr.skT_direct, KC)]


EXEC_OPS = _exec_operators()
#: windows a call: >= 10^5 outputs of full-mantissa input at each shape
N_WIN = {"flagship": 80, "toeplitz": 100, "hb_up": 200, "hb_down": 400,
         "direct": 25000}


@pytest.mark.parametrize("op", EXEC_OPS, ids=[o[0] for o in EXEC_OPS])
def test_unbiased(op):
    """frac_whole_ref's float32 error against its own float64 function
    (the float32 operator in float64) on 2 channels of uniform
    full-mantissa input has no sign of its own: beta within 0.02 of 0, at
    the executor's fold; its RMS is no worse than the floating split's
    (tools/torch_frac_beta.py's ``floating_split``, its fold sums in
    float32)."""
    label, I, D, O, parts, skT, kc = op
    n_win = N_WIN[label]
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.uniform(-1, 1, (2, (n_win - 1) * I + D)),
                     dtype=torch.float32)
    y64 = frac_whole_ref(x.double(), operator_parts(skT.double()), I, D, O,
                         n_win)
    assert y64.numel() >= 10**5
    y = frac_whole_ref(x, parts, I, D, O, n_win, kc)
    b = torch_frac_beta.beta(y, y64)
    assert abs(b) <= torch_frac_beta.FRAC_BETA_MAX, b
    e = y.double() - y64
    ef = torch_frac_beta.floating_split(x, parts, I, D, O, n_win,
                                        kc).double() - y64
    assert rms_db(e.numpy()) <= rms_db(ef.numpy()), (rms_db(e.numpy()),
                                                    rms_db(ef.numpy()))


def _fold_cases():
    """(label, I, D, O, parts) for the fold-sum check: I = 294 (the
    flagship), 64 (the mini-Toeplitz conv), 1 (the direct conv), a "high"
    operator (the frac stage's, with bf16(skT_lo)) and the flagship's
    adjoint geometry (I' = 640, D' = 2560, O' = 294)."""
    p96 = make_plan(44100, 96000, 2.0, 180.15, 0)
    fu = FusedUpExec(p96, torch.float32)
    pa = ConvExec(p96.stages[0], torch.float32, "fast", engine="pallas")
    dr = ConvExec(p96.stages[0], torch.float32, "fast", engine="direct")
    fr = FracWholeExec(p96.stages[1], torch.float32, "high", engine="im2col")
    Ia, Da, Oa, _K = adjoint_geometry(fu.p_in, fu.D, fu.p_out)
    return [("flagship", fu.p_in, fu.D, fu.p_out, fu.op.parts),
            ("pallas", pa.B_pallas * pa.spec.down, *pa.op.hi.shape,
             pa.op.parts),
            ("direct", 1, *dr.skT_direct.shape, dr.op.parts),
            ("frac_high", fr.spec.in_step, fr.D, fr.spec.out_step,
             fr.op.parts),
            ("adjoint", Ia, Da, Oa,
             adjoint_parts(fu.op.parts, fu.p_in, fu.D, fu.p_out))]


FOLD_CASES = _fold_cases()


@pytest.mark.parametrize("kc", [KC_LO, KC])
@pytest.mark.parametrize("case", FOLD_CASES, ids=[c[0] for c in FOLD_CASES])
def test_big_pair_fold_sums_exact(case, kc):
    """Every big-pair fold sum of the model, x0 of each window row over
    each fold against the operator's lead slice, is exact in float32: its
    products lie on one grid (split_grid), so the tensor cores' sum has
    nothing to round.  Full-mantissa input, each channel at its own scale
    (2^-20 .. 2^20), at least 10^5 sums."""
    label, I, D, O, parts = case
    s = unpack_parts(parts, D, O)
    assert (s.shape[0] == 4) == (label == "frac_high")
    s0 = s[0].double()
    C = 4
    n_win = max(2, -(-10**5 // (C * O * -(-D // kc))))
    rng = np.random.default_rng(kc + D)
    x = rng.uniform(-1, 1, (C, (n_win - 1) * I + D))
    x *= np.exp2(rng.integers(-20, 21, (C, 1)))
    n = 0
    for d0, d1, (x0, _x1, _x2) in _fold_slices(
            torch.tensor(x, dtype=torch.float32), n_win, I, D, O, kc):
        p = x0.double() @ s0[d0:d1]
        assert torch.equal(p.float().double(), p)
        n += p.numel()
    assert n >= 10**5


# (I, O, windows): the flagship's geometry (a grid a window row) and the
# direct stage's (I = 1 on the 8-column tile: a grid a 16-window group)
SPLIT_GEOS = [(294, 640, 8), (1, 2, 64)]


@pytest.mark.parametrize("kc", [KC_LO, KC])
@pytest.mark.parametrize("geo", SPLIT_GEOS, ids=["row", "group16"])
def test_window_split_error_bound(geo, kc):
    """The grid split of the windows trades an exact input for exact fold
    sums: x0 + x1 + x2 is within 2^(E-27) of x, 2^E above the largest |x|
    of the values that share the grid (a window row's over the fold, or a
    16-window group's), on input whose values span 2^-30 .. 1 inside a
    fold; x0 lies on the grid 2^(E-8), |k| <= 256; some values are not
    held exactly (split3 would hold every one)."""
    I, O, n_win = geo
    D, C = 1027, 3
    rows = 16 if I == 1 else 1
    rng = np.random.default_rng(kc + I)
    x = rng.uniform(-1, 1, (C, (n_win - 1) * I + D))
    x *= np.exp2(rng.integers(-30, 1, x.shape))
    x = torch.tensor(x, dtype=torch.float32)
    n_off = 0
    for d0, d1, (x0, x1, x2) in _fold_slices(x, n_win, I, D, O, kc):
        k = d1 - d0
        w = x[:, d0:].unfold(1, k, I)[:, :n_win].double()
        m = w.abs().reshape(C, n_win // rows, rows * k).amax(-1)
        E = torch.frexp(m).exponent.clamp(min=-125).double()
        E = E.repeat_interleave(rows, 1)[..., None]
        err = (w - (x0.double() + x1.double() + x2.double())).abs()
        assert bool((err <= torch.pow(2.0, E - 27)).all()), d0
        q = x0.double() / torch.pow(2.0, E - 8)
        assert bool(((q == torch.round(q)) & (q.abs() <= 256)).all()), d0
        for v in (x0, x1, x2):
            assert torch.equal(v.to(torch.bfloat16).float(), v)
        n_off += int((err > 0).sum())
    assert n_off > 0


def test_jvp_and_vmap_rules():
    """The jvp is frac_whole on the tangent; vmap folds the batch into rows
    (bit-equal to calls one at a time); a batched operator is refused."""
    from torch.func import jvp, vmap

    I, D, O = 7, 51, 12
    x, _w, parts, n_win = _adjoint_case(I, D, O, True, torch.float32, 9)
    dx = torch.flip(x, dims=[1]).contiguous()
    y, dy = jvp(lambda v: frac_whole(v, parts, I, D, O, n_win), (x,), (dx,))
    assert torch.equal(y, frac_whole(x, parts, I, D, O, n_win))
    assert torch.equal(dy, frac_whole(dx, parts, I, D, O, n_win))
    xb = torch.stack([x, dx, -x])
    yb = vmap(lambda v: frac_whole(v, parts, I, D, O, n_win))(xb)
    for b in range(3):
        assert torch.equal(yb[b], frac_whole(xb[b], parts, I, D, O, n_win))
    with pytest.raises(ValueError, match="cannot be batched"):
        vmap(lambda p: frac_whole(x, p, I, D, O, n_win))(
            torch.stack([parts, parts]))


@pytest.mark.parametrize("how", ["backward", "func_grad"])
def test_adjoint_operator_cached_under_transforms(how):
    """The adjoint operator is built once per operator whichever way the
    gradient is taken: torch.func hands the backward a fresh wrapper of
    the operator on every call, and the cache is keyed on the buffer
    itself, so a second gradient reuses the first one's adjoint; the
    cached operator and band are plain tensors with storage (the kernel
    reads their pointers), not wrappers of the transform they were built
    under."""
    from torch.func import grad

    from r8brain_torch.ops.pallas_frac import _ADJOINTS

    I, D, O = 7, 51, 12
    x, w, parts, n_win = _adjoint_case(I, D, O, True, torch.float32, 11)

    def gradient():
        if how == "func_grad":
            return grad(lambda v: (frac_whole(v, parts, I, D, O, n_win)
                                   * w).sum())(x)
        xr = x.clone().requires_grad_()
        (frac_whole(xr, parts, I, D, O, n_win) * w).sum().backward()
        return xr.grad

    g1 = gradient()
    assert parts in _ADJOINTS and len(_ADJOINTS[parts]) == 1
    adj = next(iter(_ADJOINTS[parts].values()))
    g2 = gradient()
    assert len(_ADJOINTS[parts]) == 1
    assert next(iter(_ADJOINTS[parts].values())) is adj
    assert torch.equal(g1, g2)
    ap, band = adj
    for t in (ap, band.steps):
        assert not torch._C._functorch.is_functorch_wrapped_tensor(t)
        assert t.data_ptr() != 0


def test_band_built_under_a_transform_has_storage():
    """An executor built under a torch.func transform (a gradient's twin
    is built inside the backward) holds its operator and band as the
    transform's wrappers; the kernel reads the band's storage through
    ``_operator``, during the transform and after it."""
    from r8brain_torch.ops.pallas_frac import _operator

    built = {}

    def f(v):
        g = torch.Generator().manual_seed(3)
        built["band"] = operator_band(operator_parts(
            torch.randn((100, 40), generator=g)))
        steps = _operator(built["band"].steps)
        assert not torch._C._functorch.is_functorch_wrapped_tensor(steps)
        assert steps.data_ptr() != 0
        return (2 * v).sum()

    torch.func.grad(f)(torch.ones(3))
    assert torch._C._functorch.is_functorch_wrapped_tensor(
        built["band"].steps)
    steps = _operator(built["band"].steps)
    assert steps.data_ptr() != 0
    assert steps.tolist() == [list(ab) for ab in built["band"].host]


def test_beta_tool_cpu_smoke(capsys):
    """tools/torch_frac_beta.py on the plain path (4 channels): one line a
    call, the floating split with truncated fold sums more negative than
    the model at each, the model's beta near 0 on average over them."""
    import re

    from tools.torch_frac_beta import LABELS, main

    assert main(["--device", "cpu", "--channels", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" I=")[0] for ln in lines] == list(LABELS)
    model = []
    for ln in lines:
        b = dict(re.findall(r"(model|truncated) beta ([-+.\d]+)", ln))
        assert float(b["truncated"]) < float(b["model"]) - 0.1, ln
        model.append(float(b["model"]))
    assert abs(np.mean(model)) < 0.02, model


# (call of tools/torch_frac_band.py, folds a row tile walks over its band
# and over all of D, at fold 16 and at fold 32): the fused flagship of
# cd24_44k1_96k, the two toeplitz convs of cd24_44k1_96001, the half-band
# upsampler of 44.1k -> 192k, and the dense direct conv stage
BAND_OPS = [("flagship_fast", {KC_LO: (247, 325), KC: (126, 165)}),
            ("toeplitz_964", {KC_LO: (196, 244), KC: (100, 124)}),
            ("toeplitz_561", {KC_LO: (96, 144), KC: (48, 72)}),
            ("hb_up", {KC_LO: (12, 20), KC: (6, 10)}),
            ("direct", {KC_LO: (45, 45), KC: (23, 23)})]


@pytest.mark.parametrize("kc", [KC_LO, KC])
@pytest.mark.parametrize("op", BAND_OPS, ids=[o[0] for o in BAND_OPS])
def test_operator_band(op, kc):
    """The executor's operator_band of its packed operator: every fold
    that a column tile does not walk is zero in every slice of the tile's
    columns, and the band's edge folds are not; the folds walked (126 of
    165 on the flagship at fold 32, 100 of 124 and 48 of 72 on
    44.1k -> 96001's convs); a dense operator walks all of D; and the
    plain model walking only the band equals the full walk bit for bit."""
    label, want = op
    xp, parts, I, D, O, n_win, _kc, band = torch_frac_band.call(
        label, "cpu", channels=2)
    assert operator_band(parts).host == band.host
    s = unpack_parts(parts, D, O)
    BN, n_f = parts.shape[3], -(-D // kc)
    for t, (a, b) in enumerate(band.host):
        cols = s[:, :, t * BN : (t + 1) * BN]
        walk = band.fold_range(t, kc)
        for f in range(n_f):
            if f not in walk:
                assert not cols[:, f * kc : (f + 1) * kc].any(), (t, f)
        # the band's first and last k16 steps hold a nonzero entry
        assert walk and cols[:, a * 16 : (a + 1) * 16].any() \
            and cols[:, (b - 1) * 16 : b * 16].any()
    assert torch_frac_band.folds(parts, D, kc, band) == want[kc]
    if label == "direct":
        assert band.host == ((0, -(-D // 16)),)
    n = min(n_win, 24)
    y = frac_whole_ref(xp, parts, I, D, O, n, kc, band)
    y_full = frac_whole_ref(xp, parts, I, D, O, n, kc)
    assert torch.equal(y.view(torch.int32), y_full.view(torch.int32))


# (label, dtype, I, D, O, n_win, start, N, storage offset, skT_lo): the
# window origin before x, windows past x's end (the last wholly), inside
# it, every window outside x, a view at a storage offset
OFFSET_CASES = [
    ("before", torch.float32, 7, 51, 12, 9, -23, 90, 0, False),
    ("past_end", torch.float32, 7, 51, 12, 9, 5, 60, 0, True),
    ("inside", torch.float32, 5, 40, 2, 11, 3, 200, 1, False),
    ("outside", torch.float32, 9, 5, 6, 4, 80, 60, 0, False),
    ("view_i1", torch.float32, 1, 33, 2, 40, -20, 50, 3, True),
    ("hb_down", torch.float32, 256, 274, 128, 6, -9, 1300, 0, False),
    ("f64", torch.float64, 7, 51, 12, 9, -23, 70, 2, True),
]


def _offset_case(case, seed):
    _label, dtype, I, D, O, n_win, start, N, off, lo = case
    g = torch.Generator().manual_seed(seed)
    big = torch.rand((3, off + N), generator=g, dtype=dtype) * 2 - 1
    skT = torch.randn((D, O), generator=g, dtype=dtype)
    skT_lo = torch.randn((D, O), generator=g, dtype=dtype) * 2.0**-15
    return (big[:, off:], operator_parts(skT, skT_lo if lo else None),
            (n_win - 1) * I + D)


@pytest.mark.parametrize("kc", [KC_LO, KC])
@pytest.mark.parametrize("case", OFFSET_CASES,
                         ids=[c[0] for c in OFFSET_CASES])
def test_offset_read_is_the_framed_read(case, kc):
    """frac_whole on x in place from a signed window origin, zero outside
    x, is frac_whole on the framing copy shifted(x, start, L) at origin 0,
    bit for bit on the CPU (the plain version frames inside); windows
    wholly outside x give exact zeros."""
    _label, dtype, I, D, O, n_win, start, N, _off, _lo = case
    x, parts, L = _offset_case(case, I + D + kc)
    band = operator_band(parts)
    y = frac_whole(x, parts, I, D, O, n_win, kc, band, start=start)
    xp = shifted(x, start, L, dtype)
    assert xp.shape[1] >= L
    assert torch.equal(y, frac_whole(xp, parts, I, D, O, n_win, kc, band))
    for m in range(n_win):
        if start + m * I >= N or start + m * I + D <= 0:
            assert not y.reshape(3, n_win, O)[:, m].any()


@pytest.mark.parametrize("case", OFFSET_CASES,
                         ids=[c[0] for c in OFFSET_CASES])
def test_gradient_through_offset_read(case):
    """The gradient through the offset read (the adjoint over the windows'
    span, cut to x's columns) equals the gradient through shifted +
    frac_whole (the adjoint on the framing copy, then F.pad's backward)
    bit for bit; so do the jvp and vmap through it."""
    from torch.func import jvp, vmap

    _label, dtype, I, D, O, n_win, start, _N, _off, _lo = case
    x, parts, L = _offset_case(case, 2 * I + D)
    g = torch.Generator().manual_seed(D)
    w = torch.rand((3, n_win * O), generator=g, dtype=dtype)
    xa = x.clone().requires_grad_()
    (frac_whole(xa, parts, I, D, O, n_win, start=start) * w).sum().backward()
    xb = x.clone().requires_grad_()
    (frac_whole(shifted(xb, start, L, dtype), parts, I, D, O, n_win)
     * w).sum().backward()
    assert xa.grad.shape == x.shape and torch.equal(xa.grad, xb.grad)
    dx = torch.flip(x, dims=[1]).contiguous()
    f = lambda v: frac_whole(v, parts, I, D, O, n_win, start=start)  # noqa
    _y, dy = jvp(f, (x,), (dx,))
    assert torch.equal(dy, f(dx))
    yb = vmap(f)(torch.stack([x, dx]))
    assert torch.equal(yb[1], f(dx))


@pytest.mark.parametrize("ldx,off,start,I,D,O,want", [
    (1024, 0, -9, 256, 274, 128, 3),    # 16-byte copies: 3 rows back
    (1024, 0, -12, 256, 274, 128, 0),   # already aligned
    (1024, 1, -9, 256, 274, 128, 0),    # x off 16 bytes: 8-byte, aligned
    (1024, 2, -9, 256, 274, 128, 1),    # x off 16 bytes: 8-byte, 1 back
    (1024, 0, -359, 294, 1027, 640, 1),  # I = 2 mod 4: 8-byte copies
    (1026, 0, -11, 256, 278, 128, 1),   # row stride 2 mod 4: 8-byte
    (1025, 0, -9, 256, 274, 128, 0),    # odd row stride: no shift helps
    (1024, 0, -9, 147, 171, 160, 0),    # odd I: no shift helps
    (1024, 0, -9, 256, 62, 128, 1),     # 3 would add a k-tile; 1 does not
    (1024, 0, -9, 256, 64, 128, 0),     # any shift adds a k-tile
    (1024, 0, -9, 1, 709, 2, 0),        # stretches: a float a copy
    (1024, 0, -9, 100, 331, 1, 3),      # rows of the 8-column tile
])
def test_lead_rows(ldx, off, start, I, D, O, want):
    """The leading zero rows a float32 launch gives the operator: those
    that put the window origin on 16-byte copies, else on 8-byte copies
    on every row, never adding a k-tile of D; none in float64."""
    from r8brain_torch.ops.pallas_frac import lead_rows

    x = torch.zeros((2, ldx))[:, off:]
    assert x.data_ptr() % 16 == 4 * off
    assert lead_rows(x, start, I, D, O) == want
    assert lead_rows(x.double(), start, I, D, O) == 0


@pytest.mark.parametrize("ldx,off,origin,I,O,want", [
    (1024, 0, -12, 256, 128, 16),  # x, origin, I, row stride on 16 bytes
    (1024, 0, -10, 256, 128, 8),   # origin on 8 bytes only
    (1024, 0, -9, 256, 128, 4),    # odd origin
    (1024, 1, -9, 256, 128, 8),    # x off 16 bytes, origin on 8
    (1024, 2, -10, 256, 128, 8),   # x off 16 bytes, origin on 16
    (1026, 0, -12, 256, 128, 8),   # row stride 2 mod 4
    (1025, 0, -12, 256, 128, 4),   # odd row stride
    (1024, 0, -360, 294, 640, 8),  # I = 2 mod 4
    (1024, 0, -12, 1, 2, 4),       # stretches: a float a copy
    (1024, 0, -12, 100, 1, 16),    # rows of the 8-column tile
])
def test_copy_width(ldx, off, origin, I, O, want):
    """The copy width a float32 launch hands the kernel for its window
    staging, from x's address, its row stride, I and the origin; float64
    copies a float at a time."""
    from r8brain_torch.ops.pallas_frac import copy_width

    x = torch.zeros((2, ldx))[:, off:]
    assert x.data_ptr() % 16 == 4 * off
    assert copy_width(x, origin, I, O) == want
    assert copy_width(x.double(), origin, I, O) == 4


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
def test_lead_operator(s, lo):
    """The operator with s leading zero rows: operator_parts of the
    float32 operator the forward computes with (s0 + s1 + s2) and
    bf16(skT_lo), each with s zero rows on top, split anew on its own
    grids, with its band; built once per operator and s.  From origin
    start - s it computes the same products: within 2^-21 of max |y| of
    the operator from start (its folds group the terms otherwise)."""
    from r8brain_torch.ops.pallas_frac import _LEADS, _lead_operator

    I, D, O, n_win, start = 256, 274, 128, 7, -9
    x, parts, _L = _offset_case(("", torch.float32, I, D, O, n_win, start,
                                 2000, 0, lo), 17 + s)
    ap, band = _lead_operator(parts, D, O, s)
    assert _lead_operator(parts, D, O, s)[0] is ap
    assert len(_LEADS[parts]) == 1
    sl = unpack_parts(parts, D, O)
    ops = [sl[0] + sl[1] + sl[2]] + ([sl[3]] if lo else [])
    pad = [torch.nn.functional.pad(t, (0, 0, s, 0)) for t in ops]
    assert torch.equal(ap, operator_parts(*pad))
    assert torch.equal(band.steps, operator_band(ap).steps)
    y = frac_whole(x, ap, I, D + s, O, n_win, band=band, start=start - s)
    ref = frac_whole(x, parts, I, D, O, n_win, band=operator_band(parts),
                     start=start)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 2.0**-21 * scale
