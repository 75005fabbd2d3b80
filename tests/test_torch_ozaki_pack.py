"""The ozaki kernel's operand packing and work order
(r8brain_torch/ops/pallas_ozaki.py), on the CPU.

The CUDA kernel reads the operator as ``pack_operator`` packs it (per
32-column tile and 64-deep k-tile the four slices stacked, each K-major
and 128-byte swizzled; per column tile the range of k-tiles that hold
nonzeros) and computes the 10 slice pairs of each 256-deep chunk as four
products a k16 step, A_p x [s0|...|s_(3-p)], skipping all-zero k-tiles.
These tests hold the packing to the executors' slices bit for bit, a
plain model of that work order (from the packed operator) to
``ozaki_framed_ref`` bit for bit, and the lemma probes' operands to the
float64 lemma.  The kernel itself is held to ``ozaki_framed_ref`` on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.ops import ozaki
from r8brain_torch.ops.dfloat import two_sum
from r8brain_torch.ops.framing import _frames
from r8brain_torch.ops.pallas_frac import TILE_K, unpack_parts
from r8brain_torch.ops.pallas_ozaki import (TILE_N, lemma_operands,
                                            ozaki_framed, ozaki_framed_ref,
                                            pack_operator)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain_parts():
    """The guarantee chain's conv (964 x 512) and frac (170 x 160)
    operator slices, with the executors' packing."""
    rs = Resampler(44100, 96000, 2.0, 180.15, precision="high",
                   conv_engine="ozaki", frac_engine="ozaki", device="cpu")
    return {k: (ex.op.parts, (ex.op.tiles, ex.op.bands))
            for k, ex in zip(("conv", "frac"), rs.execs)}


def _sinc_parts(seed, L_f, Kcols, band=None):
    """Slices of a random sinc operator, optionally zero outside a
    diagonal band of ``band`` rows (column k nonzero on rows near
    k * L_f / Kcols)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L_f)[:, None] - L_f / 2
    T = np.sinc((t - rng.standard_normal((1, Kcols)) * 4) / 8)
    if band is not None:
        centre = np.arange(Kcols)[None, :] * (L_f - band) / Kcols + band / 2
        T = np.where(np.abs(np.arange(L_f)[:, None] - centre) < band / 2,
                     T, 0.0)
    return ozaki.split_operator_host(T)[0]


def _parts(label, chain_parts):
    if label in chain_parts:
        return chain_parts[label][0]
    return _sinc_parts(1, 599, 100, band=None if label == "odd" else 200)


GEOS = ["conv", "frac", "odd", "odd_banded"]


@pytest.mark.parametrize("label", GEOS)
def test_packing_unpacks_to_the_slices(label, chain_parts):
    """pack_operator's tiles unpack to the slices bit for bit (Kcols and
    L_f padded to whole tiles with zeros), the executors' buffers are that
    packing, and every nonzero entry lies in its column tile's band, whose
    first and last k-tiles hold nonzeros."""
    parts = _parts(label, chain_parts)
    _P, L_f, Kcols = parts.shape
    tiles, bands = pack_operator(parts)
    n_kt, n_ct = -(-L_f // TILE_K), -(-Kcols // TILE_N)
    assert tiles.shape == (n_ct, n_kt, 4, TILE_N, TILE_K)
    assert tiles.dtype == torch.bfloat16 and bands.dtype == torch.int32
    assert torch.equal(unpack_parts(tiles, L_f, Kcols), parts.float())
    full = unpack_parts(tiles, n_kt * TILE_K, n_ct * TILE_N)
    assert not full[:, L_f:].any() and not full[:, :, Kcols:].any()
    if label in chain_parts:
        packed = chain_parts[label][1]
        assert torch.equal(packed[0], tiles) and torch.equal(packed[1], bands)
    nz = (full != 0).any(dim=0).reshape(n_kt, TILE_K, n_ct, TILE_N)
    nz = nz.any(dim=3).any(dim=1).T  # [n_ct, n_kt]
    for ct in range(n_ct):
        kb, ke = bands[ct].tolist()
        hit = torch.nonzero(nz[ct]).flatten().tolist()
        assert (kb, ke) == ((hit[0], hit[-1] + 1) if hit else (0, 0))
    if label != "odd":
        assert (bands[:, 1] - bands[:, 0]).sum() < n_ct * n_kt  # skips


def test_packing_for_another_tiling_is_refused(chain_parts):
    parts, (tiles, bands) = chain_parts["frac"]
    L_f, Kcols = parts.shape[1:]
    xp = torch.zeros((2, 3 * 147 + L_f))
    sx = torch.ones((2, 1))
    args = (xp, sx, parts, L_f, 147, Kcols, 4)
    ozaki_framed(*args, packed=(tiles, bands))
    other = pack_operator(parts[:, :, : Kcols - 32])
    for bad in (other, (tiles[:, :2].contiguous(), bands),
                (tiles, bands[:-1].contiguous()), (tiles.float(), bands),
                (tiles, bands.long())):
        with pytest.raises(ValueError, match="another tiling"):
            ozaki_framed(*args, packed=bad)


def _unpacked_tiles(tiles):
    """[n_ct, n_kt, 4, TILE_K, TILE_N] float32: the packed slice tiles as
    [k, n] blocks (the swizzle undone)."""
    n_ct, n_kt = tiles.shape[:2]
    s = unpack_parts(tiles, n_kt * TILE_K, n_ct * TILE_N)  # [4, K, N]
    return s.reshape(4, n_kt, TILE_K, n_ct, TILE_N).permute(3, 1, 0, 2, 4)


def kernel_model(xp, sx, packed, L_f, hop, Kcols, n_blocks,
                 emit_pair=False):
    """Plain model of the kernel's work order: per 32-column tile only
    the k-tiles of its band; per k-tile and pass p one product of the
    k-tile's slice-p windows with the stacked slices [s0|...|s_(3-p)],
    added into the chunk's pair values (exact partial sums); at the end of
    each 256-deep chunk visited, the fold in the reference's order."""
    tiles, bands = packed
    B = _unpacked_tiles(tiles)
    C = xp.shape[0]
    span = (n_blocks - 1) * hop + L_f
    n_kt = tiles.shape[1]
    r = xp[:, :span] * (1.0 / sx)
    xs = []
    for p in range(4):
        q = torch.round(r * float(256 ** (p + 1))) * 2.0 ** (-8 * (p + 1))
        xs.append(torch.nn.functional.pad(q.to(torch.bfloat16).float(),
                                          (0, n_kt * TILE_K)))
        r = r - q
    out = []
    for ct in range(tiles.shape[0]):
        kb, ke = bands[ct].tolist()
        z = torch.zeros((C, n_blocks, TILE_N))
        hi, lo, rest = z.clone(), z.clone(), z.clone()
        acc = None
        for t in range(kb, ke):
            fr = [_frames(xs[p][:, t * TILE_K :], n_blocks, hop, TILE_K)
                  for p in range(4)]
            part = [fr[p] @ torch.cat(list(B[ct, t, : 4 - p]), dim=1)
                    for p in range(4)]
            acc = part if acc is None else [a + b for a, b in zip(acc, part)]
            if (t + 1) % (ozaki.K0 // TILE_K) == 0 or t + 1 == ke:
                for p in range(4):
                    for q in range(4 - p):
                        o = acc[p][..., q * TILE_N : (q + 1) * TILE_N]
                        if p + q == 0:
                            hi, e = two_sum(hi, o)
                            lo = lo + e
                        else:
                            rest = rest + o
                acc = None
        out.append((hi, lo, rest))
    hi, lo, rest = (torch.cat([o[i] for o in out], dim=2)[..., :Kcols]
                    for i in range(3))
    s = sx[:, :, None]
    if not emit_pair:
        return ((hi + (lo + rest)) * s).reshape(C, -1)
    H, L = two_sum(hi * s, (lo + rest) * s)
    return H.reshape(C, -1), L.to(torch.bfloat16).reshape(C, -1)


@pytest.mark.parametrize("emit_pair", [False, True], ids=["plain", "pair"])
@pytest.mark.parametrize("label,hop,n_blocks", [
    ("frac", 147, 9), ("odd", 301, 4), ("odd_banded", 301, 4),
    ("conv", 256, 3)], ids=["frac_1chunk", "odd_3chunk",
                            "banded_3chunk", "conv_4chunk"])
def test_work_order_model_bit_equal_to_ref(label, hop, n_blocks, emit_pair,
                                           chain_parts):
    """The kernel's pass order, k-tile partial sums and banded skip leave
    the output bit-equal to ozaki_framed_ref, at one chunk (the frac
    operator), three (599 deep, dense and banded) and four (the conv
    operator)."""
    parts = _parts(label, chain_parts)
    _P, L_f, Kcols = parts.shape
    rng = np.random.default_rng(5)
    C = 3
    xp = torch.tensor(rng.uniform(-1, 1, (C, (n_blocks - 1) * hop + L_f))
                      * np.array([[1.0], [3e-3], [700.0]]),
                      dtype=torch.float32)
    sx = ozaki.channel_scale(xp)
    packed = pack_operator(parts)
    y = kernel_model(xp, sx, packed, L_f, hop, Kcols, n_blocks, emit_pair)
    r = ozaki_framed_ref(xp, sx, parts, L_f, hop, Kcols, n_blocks,
                         emit_pair=emit_pair)
    ys, rs = (y, r) if emit_pair else ((y,), (r,))
    assert all(torch.equal(a, b) for a, b in zip(ys, rs))


@pytest.mark.parametrize("pq", [(p, q) for p in range(4) for q in range(4 - p)],
                         ids=lambda pq: f"p{pq[0]}q{pq[1]}")
def test_lemma_operands_hold_the_lemma(pq):
    """Every operand kind of the card's lemma probes: 256-deep float32
    accumulation of the bf16 slice products equals the float64 product;
    the worst case reaches exactly 2^24 units a row, and the mixed
    magnitude set has its 2^16 product among products of 1."""
    p, q = pq
    kinds = lemma_operands(0, p, q)
    assert set(kinds) == {"worst case", "random units", "gaussian split",
                          "mixed magnitude"}
    unit = 2.0 ** (-8 * (p + q + 2))
    for kind, (a, b) in kinds.items():
        assert a.shape == (64, ozaki.K0) and b.shape == (ozaki.K0, TILE_N)
        assert a.dtype == b.dtype == torch.bfloat16
        want = a.double() @ b.double()
        assert torch.equal(torch.matmul(a.float(), b.float()).double(),
                           want), kind
        if kind == "gaussian split":  # the operator carries column scales
            continue
        prods = a.double()[:, :, None] * b.double()[None]
        units = prods / unit
        assert torch.equal(units, units.round()), kind  # a common grid
        assert units.abs().max() <= 2.0**16, kind
        if kind == "worst case":
            assert torch.equal(want.abs() / unit,
                               torch.full_like(want, 2.0**24))
        if kind == "mixed magnitude":
            diag = units[torch.arange(TILE_N), :, torch.arange(TILE_N)]
            assert torch.equal(diag.abs().amax(dim=1),
                               torch.full((TILE_N,), 2.0**16))
            assert ((diag.abs() == 1).sum(dim=1) >= ozaki.K0 - 3).all()
