"""The folded conv kernel's operand packing and work order
(r8brain_torch/ops/pallas_symconv.py), on the CPU.

The CUDA kernel reads the folded operators as ``sym_parts`` packs them
(per phase, 32-column tile and 64-row k-tile the P bfloat16 slices of Te,
then of To, each K-major and 128-byte swizzled; under "high" a fourth
slice holding bf16 of the residual rows at their offsets) and computes,
per phase and column tile, k-tile by k-tile, folds of ``KC`` rows: the
big pair's 16-row steps summed fresh (exactly: the lead slices lie on
fixed grids, ``split_grid``) and added into a partial, folded with
two_sum, the small pairs into lo; then the epilogue's two_sum of the
halves.  These
tests hold the packing to the executors' operators bit for bit, refuse a
packing of another tiling, and hold a plain model of that work order (from
the packed operator) to ``sym_conv_ref`` bit for bit.  The kernel itself
is held to ``sym_conv_ref`` on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops.dfloat import two_sum
from r8brain_torch.ops.framing import _frames
from r8brain_torch.ops.pallas_frac import (KC, TILE_K, _swizzle,
                                           operator_parts, split3)
from r8brain_torch.ops.pallas_symconv import (BH, TILE_N, split_grid,
                                              sym_conv, sym_conv_ref,
                                              sym_parts, unpack_sym)
from r8brain_torch.ops.stages import ConvExec

# the first conv stage of each (src, dst, trans_band, atten): the folded
# engine's specs (tests/test_torch_toeplitz.py's CONFIGS)
CFGS = [(44100, 96001, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
        (44100, 96000, 2.0, 180.15), (96000, 44100, 5.0, 136.45)]
IDS = ["44k1-96k001", "96k-44k1", "44k1-96k", "96k-44k1-tb5"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def execs():
    """The float32 folded executors of every spec, fast and high."""
    return {(cfg, prec): ConvExec(make_plan(*cfg, 0).stages[0],
                                  torch.float32, prec, engine="toeplitz_sym")
            for cfg in CFGS for prec in ("fast", "high")}


def _expected_slices(ex):
    """[up, 2, P, Hp, 128] float64: split_grid of the executor's Te, To
    along their rows, and under "high" bf16 of its residual rows at their
    offsets."""
    s = [t.double() for t in split_grid(ex.sym_ops, dim=2)]
    if ex.sym_lo is not None:
        s3 = torch.zeros_like(s[0])
        for j, ph in enumerate(ex.sym_lo_rows):
            for i, (r0, n) in enumerate(ph):
                s3[j, i, r0 : r0 + n] = ex.sym_lo[j, i, :n].to(
                    torch.bfloat16).double()
        s.append(s3)
    return torch.stack(s, dim=2)


@pytest.mark.parametrize("prec", ["fast", "high"])
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_packing_unpacks_to_the_slices(cfg, prec, execs):
    """Every packed element is the slice entry its (phase, column tile,
    k-tile, operator, slice, column, swizzled k) names, bit for bit; rows
    past Hp are zero; the executor's buffer is sym_parts of its operators
    and unpack_sym inverts it."""
    ex = execs[(cfg, prec)]
    parts = ex.sym_parts
    want = _expected_slices(ex)
    up, _, P, Hp, _ = want.shape
    Kt = -(-Hp // TILE_K)
    assert parts.dtype == torch.bfloat16
    assert tuple(parts.shape) == (up, BH // TILE_N, Kt, 2, P, TILE_N, TILE_K)
    assert P == (4 if prec == "high" else 3)
    assert torch.equal(parts, sym_parts(ex.sym_ops, ex.sym_lo,
                                        ex.sym_lo_rows))
    pad = torch.zeros((up, 2, P, Kt * TILE_K, BH), dtype=torch.float64)
    pad[:, :, :, :Hp] = want
    # element (j, n, t, o, p, c, kk): 16-byte chunk kk // 8 of row c holds
    # logical chunk (kk // 8) ^ (c % 8)
    j, n, t, o, p, c, kk = np.meshgrid(*[np.arange(d) for d in parts.shape],
                                       indexing="ij")
    k = ((kk // 8) ^ (c % 8)) * 8 + kk % 8
    ref = pad.numpy()[j, o, p, t * TILE_K + k, n * TILE_N + c]
    assert np.array_equal(parts.double().numpy(), ref)
    assert torch.equal(unpack_sym(parts).double(), pad)
    if prec == "high":  # the residual slice: its rows and nothing else
        for jj, ph in enumerate(ex.sym_lo_rows):
            for i, (r0, nr) in enumerate(ph):
                s3 = pad[jj, i, 3]
                assert not s3[:r0].any() and not s3[r0 + nr :].any()


def test_packing_for_another_tiling_is_refused(execs):
    """sym_conv takes only sym_parts' tiling: 64-column tiles, 32-row
    k-tiles, two slices, frac_whole's operator_parts, an unpacked float32
    operator and too few k-tiles are refused."""
    ex = execs[(CFGS[2], "fast")]
    parts = ex.sym_parts
    up, nt, Kt, _o, P, tn, tk = parts.shape
    nb, hop = 3, 256
    xp = torch.zeros((2, (nb - 1) * hop + max(ex.sym_Lf)))
    args = (ex.sym_Lf, nb, hop)
    sym_conv(xp, parts, *args)
    for bad in (parts.reshape(up, nt // 2, Kt, 2, P, 2 * tn, tk),
                parts.reshape(up, nt, 2 * Kt, 2, P, tn, tk // 2),
                parts[:, :, :, :, :2].contiguous(),
                operator_parts(ex.sym_ops[0, 0])):
        with pytest.raises(ValueError, match="another tiling"):
            sym_conv(xp, bad, *args)
    with pytest.raises(TypeError, match="packed bfloat16"):
        sym_conv(xp, parts.float(), *args)
    with pytest.raises(ValueError, match="operator rows"):
        sym_conv(xp, parts[:, :, : Kt - 2].contiguous(), *args)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as the tensor cores round an
    inexact sum."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def test_truncation_model():
    """_rz rounds float64 to float32 toward zero: never above |x|, and the
    next float32 away from zero is above |x| (or x is one).  The big
    pair's 16-row step sums of split_grid's lead slices are exact, so the
    tensor cores' truncation leaves every one as it is; of those of the
    floating lead slices (split3) it moves many (13 % here)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(10000)
                     * 2.0 ** rng.integers(-30, 30, 10000))
    y = _rz(x)
    assert y.dtype == torch.float32
    assert bool((y.double().abs() <= x.abs()).all())
    up = torch.nextafter(y, torch.where(x < 0, -np.inf, np.inf).float())
    assert bool(((up.double().abs() > x.abs()) | (y.double() == x)).all())
    assert torch.equal(_rz(torch.tensor([1.0, -2.5, 0.0])),
                       torch.tensor([1.0, -2.5, 0.0]))
    v = torch.tensor(rng.uniform(-1, 1, (200, 256)), dtype=torch.float32)
    S = torch.tensor(rng.standard_normal((256, 32))
                     * 2.0 ** rng.integers(-20, 0, (16, 1, 32)).repeat(
                         16, 0).reshape(256, 32), dtype=torch.float32)
    for split, exact in ((split_grid, True), (split3, False)):
        v0 = split(v)[0].double().reshape(200, 16, 1, 16)
        s0 = (split(S, dim=0) if split is split_grid
              else split(S))[0].double().reshape(16, 16, 32)
        p = (v0 @ s0).squeeze(2)  # [200, 16 steps, 32]
        moved = (_rz(p).double() != p).double().mean().item()
        assert (moved == 0.0) if exact else moved > 0.1, (split, moved)


def _tiles(parts):
    """[up, n_tiles, Kt, 2, P, TILE_K, TILE_N] float64: the packed tiles as
    [k, n] blocks (the swizzle undone)."""
    return _swizzle(parts).double().transpose(-1, -2)


def kernel_model(xp, parts, L_fs, nb, hop):
    """Plain model of the kernel's work order: per phase and 32-column
    tile, k-tile by k-tile from the packed blocks, folds of KC rows (the
    folds that start past Hp skipped); in each fold the big pair by 16-row
    steps (each sum exact in float32, the steps added in float32), the
    small pairs and "high" terms summed exactly and rounded once into lo,
    then the two_sum fold; at the end of the tile the halves combined and
    written to both mirrored columns of the interleaved output."""
    T = _tiles(parts)
    up, n_tiles, Kt, _, P, _, _ = T.shape
    C = xp.shape[0]
    y = torch.empty((C, nb, 2 * BH, up))
    for j, L_f in enumerate(L_fs):
        Hp = (L_f + 1) // 2
        fr = _frames(xp, nb, hop, L_f)
        a, r = fr[..., :Hp], fr.flip(-1)[..., :Hp]
        z, ez = two_sum(a, r)
        w, ew = two_sum(a, -r)
        pad = (0, Kt * TILE_K - Hp)
        A = {}
        for o, (v, e) in enumerate(((z, ez), (w, ew))):
            v0, v1, v2 = (torch.nn.functional.pad(s, pad).double()
                          for s in split_grid(v))
            A[o] = (v0, v1, v2, torch.nn.functional.pad(
                e.to(torch.bfloat16).double(), pad))
        for n in range(n_tiles):
            cols = slice(n * TILE_N, (n + 1) * TILE_N)
            hl = {}
            for t in range(-(-Hp // TILE_K)):
                for f in range(TILE_K // KC):
                    l0 = t * TILE_K + f * KC
                    if l0 >= Hp:
                        break
                    for o in range(2):
                        v0, v1, v2, e0 = A[o]
                        B = T[j, n, t, o]  # [P, TILE_K, TILE_N]
                        acc = None
                        for s0 in range(f * KC, (f + 1) * KC, 16):
                            k = slice(s0, s0 + 16)
                            g = slice(t * TILE_K + s0, t * TILE_K + s0 + 16)
                            p64 = v0[..., g] @ B[0, k]
                            p = p64.float()
                            assert torch.equal(p.double(), p64)
                            acc = p if acc is None else acc + p
                        c = slice(f * KC, (f + 1) * KC)
                        g = slice(l0, l0 + KC)
                        small = (v0[..., g] @ (B[1, c] + B[2, c])
                                 + v1[..., g] @ (B[0, c] + B[1, c])
                                 + v2[..., g] @ B[0, c])
                        if P == 4:
                            small = small + (e0[..., g] @ B[0, c]
                                             + v0[..., g] @ B[3, c])
                        small = small.float()
                        if o not in hl:
                            hl[o] = (acc, small)
                        else:
                            hi, lo = hl[o]
                            hi, err = two_sum(hi, acc)
                            hl[o] = (hi, (lo + small) + err)
            (he, le), (ho, lo) = hl[0], hl[1]
            s, e = two_sum(he, ho)
            y[:, :, cols, j] = s + (e + (le + lo))
            s, e = two_sum(he, -ho)
            y[:, :, 2 * BH - 1 - n * TILE_N - torch.arange(TILE_N), j] = \
                s + (e + (le - lo))
    return y.reshape(C, -1)


@pytest.mark.parametrize("prec", ["fast", "high"])
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_work_order_model_bit_equal_to_ref(cfg, prec, execs):
    """The kernel's order (phases, column tiles, k-tiles, folds inside
    k-tiles, 16-row steps, the epilogue) leaves the output bit-equal to
    sym_conv_ref, on full-mantissa input of three channels of very
    different scale, at a frame count that fits no tile."""
    ex = execs[(cfg, prec)]
    nb = 5
    hop = 256 * ex.spec.down
    L = (nb - 1) * hop + max(ex.sym_Lf)
    rng = np.random.default_rng(11)
    xp = torch.tensor(rng.uniform(-1, 1, (3, L))
                      * np.array([[1.0], [3e-3], [700.0]]),
                      dtype=torch.float32)
    y = kernel_model(xp, ex.sym_parts, ex.sym_Lf, nb, hop)
    r = sym_conv_ref(xp, ex.sym_parts, ex.sym_Lf, nb, hop)
    assert torch.equal(y, r)
