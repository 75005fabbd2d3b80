"""The port's CUDA kernels on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA device.  The file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from r8brain_torch import Resampler
from r8brain_torch.ops import ozaki
from r8brain_torch.ops.framing import _framed_matmul
from r8brain_torch.ops.pallas_frac import frac_whole, frac_whole_ref
from r8brain_torch.ops.pallas_ozaki import (mma_dot, ozaki_framed,
                                            ozaki_framed_ref)

# (label, I, D, O): tests/test_pallas.py's two shapes and the flagship's
SHAPES = [("aligned", 64, 772, 128), ("unaligned", 147, 171, 160),
          ("flagship", 294, 1027, 640)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rms_db(d) -> float:
    return float(10.0 * np.log10(np.mean(np.square(d)) + 1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain(cuda_device, shape, dtype):
    """The kernel against frac_whole_ref in float64, with skT_lo, C = 13
    (no multiple of 8) and a row-strided view of xp."""
    _label, I, D, O = shape
    C, n_win = 13, 37
    rng = np.random.default_rng(5)
    xp = rng.standard_normal((C, (n_win - 1) * I + D))
    skT = rng.standard_normal((D, O))
    skT_lo = rng.standard_normal((D, O)) * 2.0**-24
    ref = frac_whole_ref(torch.from_numpy(xp), torch.from_numpy(skT), I, D,
                         O, n_win, skT_lo=torch.from_numpy(skT_lo)).numpy()
    dev = dict(dtype=dtype, device=cuda_device)
    big = torch.zeros((C, xp.shape[1] + 3), **dev)
    big[:, 3:] = torch.from_numpy(xp)
    before = frac_whole.launches
    y = frac_whole(big[:, 3:], torch.tensor(skT, **dev), I, D, O, n_win,
                   skT_lo=torch.tensor(skT_lo, **dev))
    torch.cuda.synchronize()
    assert frac_whole.launches == before + 1
    err = np.abs(y.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < (1e-5 if dtype == torch.float32 else 1e-12), err


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "high"])
def test_resampler_on_card_holds_class(cuda_device, precision):
    """oneshot on the card through the kernel (one launch) against the
    port's float64 CPU path, at the -141 dB class."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1.0, 1.0, (3, 20000))
    rs = Resampler(44100, 96000, 2.0, 180.15, precision=precision,
                   device=cuda_device)
    before = frac_whole.launches
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert frac_whole.launches == before + 1
    assert y.device.type == "cuda" and y.shape == (3, rs.default_out_len(20000))
    x32 = x.astype(np.float32).astype(np.float64)
    ref = Resampler(44100, 96000, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x32).numpy()
    assert _rms_db(y.cpu().double().numpy() - ref) < -141.0


# (label, C, L_f, hop, Kcols, n_blocks): the guarantee chain's conv and frac
# geometries at a few blocks, and an odd one (C and Kcols no multiple of 8
# or 32, L_f no multiple of 16 and three K0 chunks, hop odd)
OZ_SHAPES = [("conv", 13, 964, 256, 512, 5), ("frac", 13, 170, 147, 160, 40),
             ("odd", 13, 599, 301, 100, 9)]
OZ_CHAIN = dict(precision="high", conv_engine="ozaki", frac_engine="ozaki")


@pytest.mark.cuda
@pytest.mark.parametrize("has_lo,emit_pair", [(False, False), (False, True),
                                              (True, False), (True, True)],
                         ids=["plain", "pair", "lo", "lo_pair"])
@pytest.mark.parametrize("shape", OZ_SHAPES, ids=[s[0] for s in OZ_SHAPES])
def test_ozaki_kernel_matches_plain(cuda_device, shape, has_lo, emit_pair):
    """Every variant of the split-operand kernel against ozaki_framed_ref
    on the card: bit-equal without x_lo; with x_lo the bf16 residual pass
    (~2^-24 of y) sums in another order, within 2^-22 of max |y| for the
    collapsed output (one ulp) and, for the pair, within 2^-28 (one ulp of
    the small term (lo + rest)*s + cheap, below 2^-5 of max |y|), which a
    dropped x_lo pass fails.  Each is also held to the float64 product of
    xp (+ x_lo) at -150 dB, which a dropped or misplaced x_lo pass
    (~-144 dB) fails."""
    _label, C, L_f, hop, Kcols, n_blocks = shape
    rng = np.random.default_rng(9)
    L = (n_blocks - 1) * hop + L_f
    xp = torch.tensor(rng.uniform(-1, 1, (C, L + 3)), dtype=torch.float32,
                      device=cuda_device)[:, 3:]  # a row-strided view
    parts, _ = ozaki.split_operator_host(rng.standard_normal((L_f, Kcols)))
    parts = parts.to(cuda_device)
    sx = ozaki.channel_scale(xp)
    x_lo = None
    if has_lo:
        x_lo = torch.tensor(rng.uniform(-1, 1, (C, L)) * 2.0**-24,
                            device=cuda_device).bfloat16()
    args = (xp, sx, parts, L_f, hop, Kcols, n_blocks)
    before = ozaki_framed.launches_by[(hop, L_f, Kcols, has_lo, emit_pair)]
    y = ozaki_framed(*args, x_lo=x_lo, emit_pair=emit_pair)
    r = ozaki_framed_ref(*args, x_lo=x_lo, emit_pair=emit_pair)
    torch.cuda.synchronize()
    assert ozaki_framed.launches_by[
        (hop, L_f, Kcols, has_lo, emit_pair)] == before + 1
    ys, rs = (y, r) if emit_pair else ((y,), (r,))
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(ys, rs))
    yc = sum(t.double() for t in ys)
    rc = sum(t.double() for t in rs)
    if not has_lo:
        assert all(torch.equal(a, b) for a, b in zip(ys, rs))
    else:
        tol = 2.0**-28 if emit_pair else 2.0**-22
        assert (yc - rc).abs().max() <= tol * rc.abs().max()
    T64 = parts.double().sum(dim=0)
    x64 = xp.double() + (x_lo.double() if has_lo else 0.0)
    ref = _framed_matmul(x64, T64, n_blocks, hop).reshape(C, -1)
    assert _rms_db((yc - ref).cpu().numpy()) \
        - _rms_db(ref.cpu().numpy()) <= -150.0


@pytest.mark.cuda
def test_ozaki_lemma_on_tensor_cores(cuda_device):
    """A 256-deep mma.sync float32 accumulation of the bf16 slices equals
    the float64 product bit for bit, for every kept slice pair, on the
    split of random data and on worst-case slices (all +256 units)."""
    rng = np.random.default_rng(10)
    K = ozaki.K0
    xparts, _ = ozaki.split_input(torch.from_numpy(rng.standard_normal((48, K))))
    tparts, _ = ozaki.split_operator_host(rng.standard_normal((K, 40)))
    for p in range(ozaki.N_PARTS):
        for q in range(ozaki.N_DIAG - p):
            full = (torch.full((48, K), 2.0**(-8 * p)).bfloat16(),
                    torch.full((K, 40), 2.0**(-8 * q)).bfloat16())
            for a, b in ((xparts[p], tparts[q]), full):
                got = mma_dot(a.to(cuda_device), b.to(cuda_device))
                assert torch.equal(got.double().cpu(),
                                   a.double() @ b.double()), (p, q)


@pytest.mark.cuda
def test_channel_scale_on_card_matches_cpu(cuda_device):
    """The card's log2/exp2 give the CPU's scales, exact powers of two,
    at, just above and half again above 2^k for k in [-60, 60]."""
    p = np.exp2(np.arange(-60, 61)).astype(np.float32)
    v = np.concatenate([p, np.nextafter(p, np.float32(np.inf)), p * 1.5])
    x = torch.from_numpy(v[:, None].astype(np.float32))
    s = ozaki.channel_scale(x.to(cuda_device)).cpu()
    assert torch.equal(s, ozaki.channel_scale(x))
    s64 = s.double().numpy()
    assert np.array_equal(s64, np.exp2(np.round(np.log2(s64))))


# tests/test_ozaki.py's guarantee configurations: (src, dst, atten)
OZ_CONFIGS = [(44100, 96000, 180.15), (44100, 48000, 180.15),
              (96000, 44100, 180.15), (44100, 96000, 206.91)]


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["1", "0"], ids=["carry", "no_carry"])
@pytest.mark.parametrize("cfg", OZ_CONFIGS,
                         ids=["44k_96k", "44k_48k", "96k_44k", "preset_def"])
def test_guarantee_chain_on_card(cuda_device, cfg, carry, monkeypatch):
    """The guarantee chain on the card launches the kernel once per stage
    and agrees with the same chain's plain CPU run and with the port's
    float64 path (-150 dB with the df32 carry, -141 dB without)."""
    src, dst, atten = cfg
    monkeypatch.setenv("R8BT_DF_CARRY", carry)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.0, 1.0, (3, 20000)).astype(np.float32)
    rs = Resampler(src, dst, 2.0, atten, **OZ_CHAIN, device=cuda_device)
    assert rs.df_carry == (carry == "1")
    before = ozaki_framed.launches
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert ozaki_framed.launches == before + 2
    y = y.cpu().double().numpy()
    y_cpu = Resampler(src, dst, 2.0, atten, **OZ_CHAIN,
                      device="cpu").oneshot(x).double().numpy()
    ref = Resampler(src, dst, 2.0, atten, dtype=torch.float64,
                    device="cpu").oneshot(x.astype(np.float64)).numpy()
    assert _rms_db(y - y_cpu) - _rms_db(y_cpu) < -150.0
    assert _rms_db(y - ref) - _rms_db(ref) < (-150.0 if carry == "1"
                                              else -141.0)
