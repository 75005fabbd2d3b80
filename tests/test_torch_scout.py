"""The scouting GEMM (r8brain_torch/ops/scout.py ``dense_gemm``, the
counterpart of the reference's TPU scouting GEMMs
tools/exp_pallas_gemm.py and tools/exp_framed_kernel.py) on the CPU: its
plain version, the wrapper's checks, the packing of B, and a model of the
kernel's split arithmetic against the float64 product and the reference's
HIGHEST dot.  The kernel itself runs on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from r8brain_torch.ops.pallas_frac import TILE_K, split3, unpack_parts
from r8brain_torch.ops.scout import (FOLD, M_TILES, PACK_N, _check_packed,
                                     dense_gemm, dense_gemm_ref, pack_b)


@pytest.mark.parametrize("hop", [None, 256])
@pytest.mark.parametrize("mt", M_TILES)
def test_plain_version_is_the_float64_product(mt, hop):
    rng = np.random.default_rng(mt)
    A = rng.standard_normal((301, 700)).astype(np.float32)
    B = rng.standard_normal((700, 130)).astype(np.float32)
    want = A.astype(np.float64) @ B.astype(np.float64)
    r = dense_gemm_ref(torch.from_numpy(A), torch.from_numpy(B), mt, hop)
    assert r.dtype == torch.float64
    assert np.abs(r.numpy() - want).max() < 1e-12 * np.abs(want).max()
    before = dense_gemm.launches
    c = dense_gemm(torch.from_numpy(A), torch.from_numpy(B), mt, hop)
    assert c.dtype == torch.float32 and dense_gemm.launches == before
    assert torch.equal(c, r.float())


def test_argument_checks():
    A, B = torch.zeros((10, 32)), torch.zeros((32, 8))
    with pytest.raises(ValueError, match="mt"):
        dense_gemm(A, B, mt=256)
    with pytest.raises(ValueError, match="hop"):
        dense_gemm(A, B, hop=100)
    with pytest.raises(ValueError, match="A .M, K."):
        dense_gemm(A, torch.zeros((31, 8)))
    with pytest.raises(TypeError, match="float32"):
        dense_gemm(A.double(), B.double())
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        dense_gemm(A.to("meta"), B.to("meta"))


# -- the split form the kernel runs on the tensor cores ---------------------

DENSE_REL_TOL = 1e-5  # of max |C|, against the float64 product
# the kernel's pairs (p, q) of A's and B's slices, in its MMA order
PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
# ragged shapes: K no multiple of 16 (or of 4), N no multiple of 128
SHAPES = [(301, 700, 130), (64, 701, 257), (130, 64, 1)]


def _trunc32(x):
    """float64 -> float32 rounded toward zero, as the tensor cores round
    their float32 sums."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


def split_model(A, B, hop=None, trunc=True):
    """The kernel's arithmetic on the CPU: A and B split into three bf16
    slices (split3), per k16 step the 6 slice products with p+q <= 2 added
    one by one into a float32 accumulator (each product sum exact, each
    add rounded toward zero, or to nearest with trunc=False), which starts
    afresh every FOLD k-values (every hop under SEG) and is added into the
    total with a float32 add."""
    a, b = split3(A), split3(B)
    fold = hop or FOLD
    K = A.shape[1]
    tot = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32)
    acc = None
    for k0 in range(0, K, 16):
        step = slice(k0, k0 + 16)
        for p, q in PAIRS:
            prod = a[p][:, step].double() @ b[q][step].double()
            s = prod if acc is None else acc.double() + prod
            acc = _trunc32(s) if trunc else s.float()
        if (k0 + 16) % fold == 0 or k0 + 16 >= K:
            tot = tot + acc
            acc = None
    return tot


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_pack_b_rebuilds_B_exactly(shape):
    """pack_b's three slices, unpacked, sum to B exactly (and the padding
    of the tiles is zero)."""
    _, K, N = shape
    rng = np.random.default_rng(K)
    B = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    packed = pack_b(B)
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (-(-N // PACK_N), -(-K // TILE_K), 3,
                                   PACK_N, TILE_K)
    s = unpack_parts(packed, K, N)
    assert torch.equal(s.double().sum(dim=0), B.double())
    full = unpack_parts(packed, packed.shape[1] * TILE_K,
                        packed.shape[0] * PACK_N)
    assert full[:, K:].abs().sum() == 0 and full[:, :, N:].abs().sum() == 0


def test_packed_b_of_another_tiling_is_refused():
    B = torch.ones((700, 130))
    _check_packed(pack_b(B), 700, 130)  # its own shape passes
    for K, N in ((764, 130), (700, 258), (640, 130)):
        with pytest.raises(ValueError, match="another tiling"):
            _check_packed(pack_b(B), K, N)
    with pytest.raises(ValueError, match="another tiling"):
        _check_packed(pack_b(B).float(), 700, 130)
    with pytest.raises(TypeError, match="float32"):
        pack_b(B.double())


@pytest.mark.parametrize("trunc", [True, False])
@pytest.mark.parametrize("hop", [None, 256, 48])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_split_model_vs_float64_and_jax_highest(shape, hop, trunc):
    """The CPU model of the kernel's split arithmetic against the plain
    version (the float64 product) and against the reference's
    ``jnp.dot(..., precision=HIGHEST)`` on the CPU, within DENSE_REL_TOL of
    max |C|: with truncating adds (the tensor cores') and with rounding
    ones, in one K loop and in segments, one that folds mid k-tile."""
    import jax
    import jax.numpy as jnp

    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    c = split_model(torch.from_numpy(A), torch.from_numpy(B), hop, trunc)
    ref = dense_gemm_ref(torch.from_numpy(A), torch.from_numpy(B), 512, hop)
    scale = ref.abs().max()
    assert (c.double() - ref).abs().max() <= DENSE_REL_TOL * scale
    hi = np.asarray(jnp.dot(jnp.asarray(A), jnp.asarray(B),
                            precision=jax.lax.Precision.HIGHEST), np.float64)
    assert np.abs(c.double().numpy() - hi).max() <= DENSE_REL_TOL * scale


def test_split_model_truncation_stays_far_inside_the_tolerance():
    """At K = 704 (the conv shape's depth) the truncating model stays
    within a tenth of DENSE_REL_TOL: the fresh accumulator every 64
    k-values is what keeps it there; one accumulator over all of K (fold
    = K) drifts 4x further."""
    rng = np.random.default_rng(704)
    A = torch.from_numpy(rng.standard_normal((96, 704)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((704, 64)).astype(np.float32))
    ref = dense_gemm_ref(A, B)
    scale = ref.abs().max()
    err = (split_model(A, B).double() - ref).abs().max() / scale
    err_one = (split_model(A, B, hop=704).double() - ref).abs().max() / scale
    assert err <= 0.1 * DENSE_REL_TOL
    assert err_one > 4 * err
