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
from r8brain_torch.ops.pallas_dfft import (SMEM_MAX_N, DfFFTPlan,
                                           df_fft_conv, df_fft_conv_ref)
from r8brain_torch.ops.pallas_frac import (KC, KC_LO, frac_whole,
                                           frac_whole_ref, operator_parts,
                                           split3)
from r8brain_torch.ops.pallas_ozaki import (lemma_operands, mma_dot,
                                            ozaki_framed, ozaki_framed_ref,
                                            pack_operator, wgmma_dot)
from r8brain_torch.ops.pallas_symconv import (sym_conv, sym_conv_ref,
                                               sym_ops_high, sym_parts)
from r8brain_torch.ops.scout import M_TILES, dense_gemm, dense_gemm_ref

from tools import torch_fuzz
from tools.torch_sym_beta import truncation_model

from .helpers import lcg_uniform, load_golden, load_manifest, rms_db

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
    ref = frac_whole_ref(torch.from_numpy(xp), operator_parts(
        torch.from_numpy(skT), torch.from_numpy(skT_lo)), I, D, O,
        n_win).numpy()
    dev = dict(dtype=dtype, device=cuda_device)
    big = torch.zeros((C, xp.shape[1] + 3), **dev)
    big[:, 3:] = torch.from_numpy(xp)
    before = frac_whole.launches
    y = frac_whole(big[:, 3:], operator_parts(torch.tensor(skT, **dev),
                                              torch.tensor(skT_lo, **dev)),
                   I, D, O, n_win)
    torch.cuda.synchronize()
    assert frac_whole.launches == before + 1
    err = np.abs(y.cpu().double().numpy() - ref).max() / np.abs(ref).max()
    assert err < (1e-5 if dtype == torch.float32 else 1e-12), err


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [KC_LO, KC])
def test_kernel_fold_lengths_match_plain(cuda_device, kc):
    """Both fold lengths of the float32 kernel with skT_lo, at the
    guarantee chains' frac-stage shape, against the float64 plain version
    and against the float32 model of the same fold."""
    I, D, O, C, n_win = 147, 170, 160, 13, 41
    rng = np.random.default_rng(14)
    xp = rng.uniform(-1.0, 1.0, (C, (n_win - 1) * I + D))
    skT = rng.standard_normal((D, O))
    skT_lo = rng.standard_normal((D, O)) * 2.0**-24
    ref = frac_whole_ref(torch.from_numpy(xp), operator_parts(
        torch.from_numpy(skT), torch.from_numpy(skT_lo)), I, D, O,
        n_win).numpy()
    x32 = torch.tensor(xp, dtype=torch.float32)
    parts = operator_parts(*(torch.tensor(a, dtype=torch.float32)
                             for a in (skT, skT_lo)))
    model = frac_whole_ref(x32, parts, I, D, O, n_win,
                           kc=kc).double().numpy()
    y = frac_whole(x32.to(cuda_device), parts.to(cuda_device), I, D, O,
                   n_win, kc=kc)
    y = y.cpu().double().numpy()
    scale = np.abs(ref).max()
    assert np.abs(y - ref).max() / scale < 1e-5
    assert np.abs(y - model).max() / scale < 2.0**-21


# (label, I, D, O): SHAPES and the float32 chains' other frac_whole calls:
# the toeplitz conv stage, the direct conv stage (O = 2: the 8-column tile
# with the side-by-side slices, staged as stretches) and the interpolator
# of the frac stage; a narrow one staged by row (I > 64, O = 1); and the
# half-band stages' and the cascade's (44.1k -> 192k's upsampler, 192k ->
# 44.1k's decimator, the five upsamplers of 44.1k -> 2.8224M: O = 4096)
MODEL_SHAPES = SHAPES + [("toeplitz", 256, 964, 512), ("direct", 1, 709, 2),
                         ("frac", 147, 170, 160), ("narrow", 100, 331, 1),
                         ("hb_up", 128, 150, 256), ("hb_down", 256, 298, 128),
                         ("cascade", 128, 157, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("kc", [KC_LO, KC])
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=[s[0] for s in MODEL_SHAPES])
def test_split_kernel_matches_model(cuda_device, shape, kc, lo):
    """The tensor-core kernel against its plain model (the same split and
    folds, summed in another order) within 2^-21 of max |y|, and against
    the float64 product within 1e-5, at every geometry the chains give it,
    both folds, with and without skT_lo, C = 67 (no multiple of 64) on a
    row-strided view of xp; each call is one counted launch.  skT_lo is
    drawn at 2^-15 of skT, so that its slice moves the model by more than
    8 times the tolerance: a kernel that drops or misplaces it fails (the
    real residual, ~2^-25 of y, hides inside the tolerance)."""
    _label, I, D, O = shape
    C, n_win = 67, 23
    rng = np.random.default_rng(D + O + kc)
    L = (n_win - 1) * I + D
    big = torch.tensor(rng.uniform(-1, 1, (C, L + 3)), dtype=torch.float32,
                       device=cuda_device)
    xp = big[:, 3:]
    skT = torch.tensor(rng.standard_normal((D, O)), dtype=torch.float32,
                       device=cuda_device)
    skT_lo = (torch.tensor(rng.standard_normal((D, O)) * 2.0**-15,
                           dtype=torch.float32, device=cuda_device)
              if lo else None)
    parts = operator_parts(skT, skT_lo)
    before = frac_whole.launches
    y = frac_whole(xp, parts, I, D, O, n_win, kc=kc)
    torch.cuda.synchronize()
    assert frac_whole.launches == before + 1
    model = frac_whole_ref(xp, parts, I, D, O, n_win, kc=kc).double()
    ref = frac_whole_ref(xp.double(), operator_parts(
        skT.double(), skT_lo.double() if lo else None), I, D, O, n_win)
    scale = ref.abs().max().item()
    assert (y.double() - model).abs().max().item() <= 2.0**-21 * scale
    assert (y.double() - ref).abs().max().item() <= 1e-5 * scale
    if lo:
        bare = frac_whole_ref(xp, operator_parts(skT), I, D, O, n_win, kc=kc)
        moved = (model - bare.double()).abs().max().item()
        assert moved >= 8 * 2.0**-21 * scale, moved / scale


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [16, 32])
def test_tensor_core_accumulation_pin(cuda_device, terms):
    """16- and 32-term bf16 x bf16 -> float32 accumulations through the
    kernel's own wgmma chain (bf16-exact input and operator, so only the
    big pair is nonzero and y is one fold's partial) on the slices of the
    flagship operator and uniform input: every output within the error
    bound of a recursive float32 sum that truncates, (terms - 1) * 2^-23 *
    sum |products|."""
    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.fused import FusedUpExec

    skT = FusedUpExec(make_plan(44100, 96000, 2.0, 180.15, 0),
                      torch.float32).skT
    s0 = split3(skT)[0]
    rng = np.random.default_rng(17)
    C, n_win = 8, 64
    x0 = split3(torch.tensor(rng.uniform(-1, 1, (C, n_win * terms)),
                             dtype=torch.float32))[0].to(cuda_device)
    for d0 in range(0, skT.shape[0] - terms, 8 * terms):
        op = s0[d0 : d0 + terms].to(cuda_device)
        y = frac_whole(x0, operator_parts(op), terms, terms, op.shape[1],
                       n_win, kc=terms)
        xw = x0.double().reshape(C, n_win, terms)
        exact = (xw @ op.double()).reshape(C, -1)
        mag = (xw.abs() @ op.double().abs()).reshape(C, -1)
        err = (y.double() - exact).abs()
        assert bool((err <= (terms - 1) * 2.0**-23 * mag).all()), d0


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
# geometries at a few blocks, an odd one (C and Kcols no multiple of 8 or
# 32, L_f no multiple of 16 and three K0 chunks, hop odd) and a ragged one
# (rows, Kcols and L_f short of one tile: 21 rows, 40 columns, 70 deep);
# and the half-band geometries (44.1k -> 192k's upsampler, 192k -> 44.1k's
# decimator)
OZ_SHAPES = [("conv", 13, 964, 256, 512, 5), ("frac", 13, 170, 147, 160, 40),
             ("odd", 13, 599, 301, 100, 9), ("ragged", 3, 70, 33, 40, 7),
             ("hb_up", 13, 150, 128, 256, 30),
             ("hb_down", 13, 298, 256, 128, 30)]
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
@pytest.mark.parametrize("probe", ["wgmma", "mma_sync"])
def test_ozaki_lemma_on_tensor_cores(cuda_device, probe):
    """A 256-deep float32 tensor-core accumulation of the bf16 slices
    equals the float64 product bit for bit, for every kept slice pair and
    every operand kind of lemma_operands (worst case, random units,
    Gaussian split, mixed magnitude): on the kernel's own wgmma path (16
    k16 steps chained into one accumulator) and on mma.sync."""
    for p in range(ozaki.N_PARTS):
        for q in range(ozaki.N_DIAG - p):
            for kind, (a, b) in lemma_operands(10, p, q).items():
                want = a.double() @ b.double()
                if probe == "wgmma":
                    # b as slice q of a packed operator (the others zero)
                    parts = torch.zeros((ozaki.N_PARTS, *b.shape),
                                        dtype=torch.bfloat16)
                    parts[q] = b
                    got = wgmma_dot(a.to(cuda_device),
                                    parts.to(cuda_device))[q]
                else:
                    got = mma_dot(a.to(cuda_device), b.to(cuda_device))
                assert torch.equal(got.double().cpu(), want), (p, q, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [True, False], ids=["pair", "plain"])
def test_ozaki_kernel_on_chain_operators(cuda_device, carry):
    """The guarantee chain's own banded conv and frac operators (whose
    packing skips the all-zero k-tiles of each column tile) through the
    executors' packed buffers: bit-equal to ozaki_framed_ref."""
    rs = Resampler(44100, 96000, 2.0, 180.15, **OZ_CHAIN, device=cuda_device)
    rng = np.random.default_rng(12)
    for ex in rs.execs:
        L_f, hop, Kcols, nb = ex.geometry(7 * ex.geometry(1)[2])
        xp = torch.tensor(rng.uniform(-1, 1, (5, (nb - 1) * hop + L_f)),
                          dtype=torch.float32, device=cuda_device)
        sx = ozaki.channel_scale(xp)
        args = (xp, sx, ex.oz_parts, L_f, hop, Kcols, nb)
        y = ozaki_framed(*args, emit_pair=carry, packed=ex.oz_packed)
        r = ozaki_framed_ref(*args, emit_pair=carry)
        ys, rs_ = (y, r) if carry else ((y,), (r,))
        assert all(torch.equal(a, b) for a, b in zip(ys, rs_))


@pytest.mark.cuda
def test_ozaki_kernel_refuses_other_tiling(cuda_device):
    parts, _ = ozaki.split_operator_host(
        np.random.default_rng(13).standard_normal((100, 64)))
    parts = parts.to(cuda_device)
    xp = torch.zeros((2, 400), device=cuda_device)
    sx = torch.ones((2, 1), device=cuda_device)
    tiles, bands = pack_operator(parts)
    with pytest.raises(ValueError, match="another tiling"):
        ozaki_framed(xp, sx, parts, 100, 50, 64, 3,
                     packed=(tiles[:, :1].contiguous(), bands))


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


# (mode, n, head, C, n_frames): every mode of df_fft_conv, one-CTA and
# four-step sizes; C * n_frames is odd in frames and framed mode, so the
# last transform packs one frame
FFT_CASES = ([("frames", n, 0, 5, 3) for n in (512, 1024, 8192, 16384, 65536)]
             + [("framed", n, n // 4, 3, 5) for n in (4096, 8192)]
             + [("poly", n, n // 4, 3, 4) for n in (4096, 8192, 16384)])


def fft_case(rng, mode, n, head, C, n_frames, K=701):
    """Input u [C, L] (float64 values exact in float32; L ends inside the
    last frame, so the kernel zero-fills past it), the kernel k, the plan,
    and the float64 direct convolution of every frame (circular: the
    frame's periodic extension against k)."""
    K = min(K, n // 2)
    hop = n - head
    L = (n_frames - 1) * hop + n - 7
    u = rng.uniform(-1.0, 1.0, (C, L)).astype(np.float32).astype(np.float64)
    k = rng.standard_normal(K)
    poly = mode == "poly"
    ks = (k[0::2], k[1::2]) if poly else (k,)
    plan = DfFFTPlan(n, *[np.fft.fft(kk, n) / n for kk in ks])
    up = np.zeros((C, (n_frames - 1) * hop + n))
    up[:, :L] = u
    outs = []
    for kk in ks:
        o = np.zeros((C, n_frames, hop))
        for c in range(C):
            for f in range(n_frames):
                fr = up[c, f * hop : f * hop + n]
                o[c, f] = np.convolve(np.concatenate([fr, fr]),
                                      kk)[n + head : 2 * n]
        outs.append(o.reshape(C, -1))
    ref = np.stack(outs, -1).reshape(C, -1) if poly else outs[0]
    return u, plan, ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", FFT_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in FFT_CASES])
def test_df_fft_conv_matches_plain(cuda_device, case):
    """The FP64 FFT-convolution kernel in every mode against
    df_fft_conv_ref (complex128 torch.fft, rounded to float32) on the
    card: both round the same float64 convolution once, so they differ by
    at most one float32 ulp, within 2^-22 of max |y|; and against the
    float64 direct convolution at -150 dB relative (the float32 rounding
    of the output alone is about -152 dB).  The input is a row-strided
    view."""
    mode, n, head, C, n_frames = case
    rng = np.random.default_rng(n + head)
    u, plan, ref = fft_case(rng, mode, n, head, C, n_frames)
    plan = plan.to(cuda_device)
    big = torch.zeros((C, u.shape[1] + 3), dtype=torch.float32,
                      device=cuda_device)
    big[:, 3:] = torch.from_numpy(u)
    ut = big[:, 3:]
    before = df_fft_conv.launches_by[(mode, n)]
    y = df_fft_conv(ut, plan, n_frames, head)
    r = df_fft_conv_ref(ut, plan, n_frames, head)
    torch.cuda.synchronize()
    # one kernel, or the four-step's three in one chunk of transforms
    assert df_fft_conv.launches_by[(mode, n)] == \
        before + (1 if n <= SMEM_MAX_N else 3)
    assert y.shape == r.shape == ref.shape and y.dtype == torch.float32
    y = y.cpu().double().numpy()
    r = r.cpu().double().numpy()
    assert np.abs(y - r).max() <= 2.0**-22 * np.abs(r).max()
    assert _rms_db(y - ref) - _rms_db(ref) <= -150.0


# every mode at every size of the register-resident kernel (128 .. 8192)
REG_CASES = [(mode, 1 << b, 0 if mode == "frames" else (1 << b) // 4,
              *((3, 4) if mode == "poly" else (5, 3)))
             for b in range(7, 14) for mode in ("frames", "framed", "poly")]


# with FFT_CASES, every mode at every four-step size (16384 .. 65536)
FOUR_STEP_CASES = ([("framed", n, n // 4, 3, 3) for n in (16384, 32768, 65536)]
                   + [("frames", 32768, 0, 3, 3)]
                   + [("poly", n, n // 4, 3, 2) for n in (32768, 65536)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", REG_CASES + FOUR_STEP_CASES,
                         ids=[f"{c[0]}-{c[1]}"
                              for c in REG_CASES + FOUR_STEP_CASES])
def test_df_fft_conv_every_size_and_mode(cuda_device, case):
    """The register-resident radix-16 kernel at every n from 128 to 8192
    in every mode (one radix-2, -4 or -8 pass before the radix-16 ones,
    several transforms a CTA below 2048, persistent CTAs over more
    transforms than fit at once), and the four-step path in the modes and
    sizes FFT_CASES leaves out, against the plain version (within 2^-22
    of max |y|) and the float64 direct convolution (-150 dB)."""
    mode, n, head, C, n_frames = case
    rng = np.random.default_rng(3 * n + len(mode))
    u, plan, ref = fft_case(rng, mode, n, head, C, n_frames)
    plan = plan.to(cuda_device)
    ut = torch.tensor(u, dtype=torch.float32, device=cuda_device)
    before = df_fft_conv.launches_by[(mode, n)]
    y = df_fft_conv(ut, plan, n_frames, head)
    r = df_fft_conv_ref(ut, plan, n_frames, head)
    torch.cuda.synchronize()
    assert df_fft_conv.launches_by[(mode, n)] == \
        before + (1 if n <= SMEM_MAX_N else 3)
    y = y.cpu().double().numpy()
    r = r.cpu().double().numpy()
    assert np.abs(y - r).max() <= 2.0**-22 * np.abs(r).max()
    assert _rms_db(y - ref) - _rms_db(ref) <= -150.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["frames", "poly"])
def test_df_fft_conv_four_step_in_chunks(cuda_device, mode, monkeypatch):
    """Above 8192 points the wrapper runs the transforms in chunks that fit
    its float64 scratch; with the scratch cut to three transforms, n =
    16384 takes several chunks (transform offsets g0 > 0) and still
    matches the plain version."""
    from r8brain_torch.ops import pallas_dfft

    n = 16384
    monkeypatch.setattr(pallas_dfft, "SCRATCH_BYTES", 3 * 16 * n)
    head = 0 if mode == "frames" else n // 4
    u, plan, ref = fft_case(np.random.default_rng(13), mode, n, head, 3, 3)
    plan = plan.to(cuda_device)
    ut = torch.tensor(u, dtype=torch.float32, device=cuda_device)
    before = df_fft_conv.launches
    y = df_fft_conv(ut, plan, 3, head)
    r = df_fft_conv_ref(ut, plan, 3, head)
    torch.cuda.synchronize()
    # 9 frames: 5 packed transforms (2 chunks) or 9 poly ones (3 chunks),
    # three kernels a chunk
    assert df_fft_conv.launches == before + 3 * (2 if mode == "frames" else 3)
    y = y.cpu().double().numpy()
    r = r.cpu().double().numpy()
    assert np.abs(y - r).max() <= 2.0**-22 * np.abs(r).max()
    assert _rms_db(y - ref) - _rms_db(ref) <= -150.0


FFT_ENGINES = ["pallas_fft5", "pallas_fft4", "pallas_fft", "fft"]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", FFT_ENGINES)
def test_fft_chain_on_card(cuda_device, engine):
    """The df32-FFT guarantee chain on the card (conv stage on df_fft_conv
    for every engine; frac stage on frac_whole) against the port's float64
    CPU path at the -141 dB class."""
    rng = np.random.default_rng(12)
    x = rng.uniform(-1.0, 1.0, (3, 20000)).astype(np.float32)
    rs = Resampler(44100, 96000, 2.0, 180.15, precision="high", fused=False,
                   conv_engine=engine, device=cuda_device)
    before = (df_fft_conv.launches, frac_whole.launches)
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert frac_whole.launches == before[1] + 1
    assert df_fft_conv.launches == before[0] + 1
    ref = Resampler(44100, 96000, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x.astype(np.float64)).numpy()
    assert _rms_db(y.cpu().double().numpy() - ref) < -141.0


# the conv stages of the folded engine's specs: (src, dst, trans_band,
# atten) of tests/test_torch_toeplitz.py's CONFIGS (their first conv stage)
SYM_CFGS = [(44100, 96001, 2.0, 180.15), (96000, 44100, 2.0, 180.15),
            (44100, 96000, 2.0, 180.15), (96000, 44100, 5.0, 136.45)]
# sym_conv's beta from its truncation model's at 1024 channels: the
# largest distance on the H100 was 0.0041 (44.1k -> 96k "high": kernel
# -0.0093, model -0.0134), sym_conv_ref's 0.0084
SYM_BETA_TOL = 0.006
# (dtype, precision, tolerance against the plain version in ulps of max
# |y|): float32, the big pair's step sums are exact on the tensor cores
# and in the model, but the small pairs and lo add in their own order;
# float64, the FMA kernel and the model's matmuls add the terms in their
# own order
SYM_VARIANTS = [(torch.float32, "fast", 4), (torch.float32, "high", 4),
                (torch.float64, "fast", 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SYM_VARIANTS,
                         ids=["f32_fast", "f32_high", "f64"])
@pytest.mark.parametrize("cfg", SYM_CFGS, ids=lambda c: "{}-{}-tb{:g}".format(
    *c[:3]))
def test_sym_conv_matches_plain(cuda_device, cfg, variant):
    """sym_conv against sym_conv_ref on the card, C = 13 and 37 frames (no
    multiple of any tile), on a row-strided view of the input; a packing
    of another tiling refused."""
    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.stages import ConvExec

    dtype, precision, ulps = variant
    st = make_plan(*cfg, 0).stages[0]
    ex = ConvExec(st, dtype, precision, engine="toeplitz_sym").to(cuda_device)
    C, nb, hop = 13, 37, 256 * st.down
    L = (nb - 1) * hop + max(ex.sym_Lf)
    rng = np.random.default_rng(15)
    big = torch.tensor(rng.uniform(-1, 1, (C, L + 3)), dtype=dtype,
                       device=cuda_device)
    args = (big[:, 3:], ex.sym_parts, ex.sym_Lf, nb, hop)
    before = sym_conv.launches
    y = sym_conv(*args)
    r = sym_conv_ref(*args)
    torch.cuda.synchronize()
    assert sym_conv.launches == before + 1
    m = r.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(m)) - (23 if dtype == torch.float32
                                          else 52))
    assert (y.double() - r.double()).abs().max().item() <= ulps * ulp
    if ex.sym_lo is not None:
        # "high" moves y by about an ulp: hold its gain, the drop of the
        # RMS error against the float64 function of "high" from the fast
        # output (the operators packed without the residual) to the high
        # one, within 0.1 dB of the model's
        want = sym_conv_ref(args[0].double(), sym_ops_high(
            ex.sym_ops, ex.sym_lo, ex.sym_lo_rows), ex.sym_Lf, nb, hop)
        fast = sym_parts(ex.sym_ops)
        gain = {fn: _rms_db((fn(args[0], fast, *args[2:]).double()
                             - want).cpu().numpy())
                - _rms_db((fn(*args).double() - want).cpu().numpy())
                for fn in (sym_conv, sym_conv_ref)}
        assert gain[sym_conv_ref] >= 0.3
        assert abs(gain[sym_conv] - gain[sym_conv_ref]) <= 0.1, gain
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="another tiling"):
            sym_conv(args[0], ex.sym_parts[:, :2].contiguous(), *args[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("cfg", SYM_CFGS, ids=lambda c: "{}-{}-tb{:g}".format(
    *c[:3]))
def test_sym_conv_unbiased(cuda_device, cfg, precision):
    """sym_conv's float32 error against its own float64 function (the fast
    operators as float64, or sym_ops_high under "high") on 1024 channels
    of full-mantissa input has no sign of its own: beta = mean(e *
    sign(y64)) / rms(e) within 0.02 of 0 (a kernel whose tensor cores
    truncated its big-pair step sums read -0.21 to -0.30).  What is left
    is the kernel's rounding of its small pairs, which the tensor cores
    add into lo truncated: the truncation model
    (tools/torch_sym_beta.py) has the kernel's beta within SYM_BETA_TOL,
    and more of its bits than sym_conv_ref (which rounds them once, to
    nearest); prints the three betas."""
    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.stages import ConvExec

    st = make_plan(*cfg, 0).stages[0]
    ex = ConvExec(st, torch.float32, "high",
                  engine="toeplitz_sym").to(cuda_device)
    C, nb, hop = 1024, 8, 256 * st.down
    L = (nb - 1) * hop + max(ex.sym_Lf)
    rng = np.random.default_rng(16)
    x = torch.tensor(rng.uniform(-1, 1, (C, L)), dtype=torch.float32,
                     device=cuda_device)
    ops, lo, rows = ex.sym_ops, ex.sym_lo, ex.sym_lo_rows
    if precision == "fast":
        parts, ops64 = sym_parts(ops), ops.double()
    else:
        parts, ops64 = ex.sym_parts, sym_ops_high(ops, lo, rows)
    args = (ex.sym_Lf, nb, hop)
    y64 = sym_conv_ref(x.double(), ops64, *args)
    ys = {fn.__name__: fn(x, parts, *args)
          for fn in (sym_conv, sym_conv_ref, truncation_model)}
    betas = {}
    for k, y in ys.items():
        e = y.double() - y64
        betas[k] = ((e * torch.sign(y64)).mean()
                    / e.square().mean().sqrt()).item()
    equal = {k: (ys[k] == ys["sym_conv"]).double().mean().item()
             for k in ("sym_conv_ref", "truncation_model")}
    print(f"sym_conv {cfg} {precision}: beta kernel "
          f"{betas['sym_conv']:+.4f}, plain {betas['sym_conv_ref']:+.4f}, "
          f"truncation model {betas['truncation_model']:+.4f}; bit-equal "
          f"to the kernel: plain {equal['sym_conv_ref']:.4f}, truncation "
          f"model {equal['truncation_model']:.4f}")
    assert abs(betas["sym_conv"]) <= 0.02, betas
    assert abs(betas["sym_conv"] - betas["truncation_model"]) <= \
        SYM_BETA_TOL, betas
    assert equal["truncation_model"] > equal["sym_conv_ref"], equal


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [None, 256])
@pytest.mark.parametrize("mt", M_TILES)
def test_dense_gemm_matches_plain(cuda_device, mt, hop):
    """The scouting GEMM at a ragged shape (M, K, N no multiple of the
    tiles) against the float64 product: within 1e-5 of max |C|."""
    rng = np.random.default_rng(mt)
    A = torch.tensor(rng.standard_normal((1000, 700)), dtype=torch.float32,
                     device=cuda_device)
    B = torch.tensor(rng.standard_normal((700, 130)), dtype=torch.float32,
                     device=cuda_device)
    before = dense_gemm.launches
    c = dense_gemm(A, B, mt, hop)
    r = dense_gemm_ref(A, B, mt, hop)
    torch.cuda.synchronize()
    assert dense_gemm.launches == before + 1
    assert ((c.double() - r).abs().max() / r.abs().max()).item() < 1e-5


@pytest.mark.cuda
def test_dense_gemm_does_not_depend_on_mt(cuda_device):
    """mt is the reference's M tile: the kernel's tile is its own, so both
    values give the same bits, in one K loop and in segments, one of
    which (48) folds mid k-tile."""
    rng = np.random.default_rng(11)
    A = torch.tensor(rng.standard_normal((777, 700)), dtype=torch.float32,
                     device=cuda_device)
    B = torch.tensor(rng.standard_normal((700, 300)), dtype=torch.float32,
                     device=cuda_device)
    for hop in (None, 256, 48):
        c = [dense_gemm(A, B, mt, hop) for mt in M_TILES]
        assert torch.equal(c[0], c[1])
        r = dense_gemm_ref(A, B, 512, hop)
        assert ((c[0].double() - r).abs().max() / r.abs().max()).item() \
            < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["K=701", "misaligned"])
def test_dense_gemm_copies_what_tma_cannot_read(cuda_device, layout):
    """A K no multiple of 4, or an A whose start is not 16-byte aligned,
    is copied by the wrapper before the TMA copies read it: the result
    still holds the tolerance."""
    rng = np.random.default_rng(12)
    K = 701 if layout == "K=701" else 700
    B = torch.tensor(rng.standard_normal((K, 130)), dtype=torch.float32,
                     device=cuda_device)
    flat = torch.tensor(rng.standard_normal(300 * K + 1), dtype=torch.float32,
                        device=cuda_device)
    A = (flat[1:] if layout == "misaligned" else flat[:-1]).view(300, K)
    c = dense_gemm(A, B)
    r = dense_gemm_ref(A, B)
    torch.cuda.synchronize()
    assert ((c.double() - r).abs().max() / r.abs().max()).item() < 1e-5


# (conv_engine, frac_whole launches, sym_conv launches) of one oneshot
MATMUL_CHAINS = [("auto", 2, 0), ("toeplitz_sym", 1, 1), ("pallas", 2, 0),
                 ("direct", 2, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("chain", MATMUL_CHAINS, ids=[c[0] for c in
                                                      MATMUL_CHAINS])
def test_matmul_chain_on_card(cuda_device, chain, precision):
    """The float32 stage chain (fused=False) on the card through its
    kernels, against the port's float64 CPU path: under "fast" the -141
    dB class (-140 dB for "direct", which the reference's chain misses
    too); under "high" -143 dB, between the fast chains (-142.24 to
    -142.39 dB on this input through the CPU path) and the high ones
    (-143.59 to -146.36), so dropped residual terms fail."""
    engine, n_fw, n_sym = chain
    rng = np.random.default_rng(16)
    x = rng.uniform(-1.0, 1.0, (3, 20000)).astype(np.float32)
    rs = Resampler(44100, 96000, 2.0, 180.15, precision=precision,
                   fused=False, conv_engine=engine, device=cuda_device)
    before = (frac_whole.launches, sym_conv.launches)
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert (frac_whole.launches - before[0],
            sym_conv.launches - before[1]) == (n_fw, n_sym)
    ref = Resampler(44100, 96000, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x.astype(np.float64)).numpy()
    bound = (-143.0 if precision == "high" else
             -140.0 if engine == "direct" else -141.0)
    assert _rms_db(y.cpu().double().numpy() - ref) < bound


# the half-band, cascade and polynomial plans: (src, dst, input samples,
# frac_whole launches of one oneshot)
STAGE_CHAINS = [(44100, 192000, 20000, 3), (192000, 44100, 40000, 2),
                (44100, 2822400, 20000, 2), (2822400, 96000, 360000, 4),
                (44100, 96001, 20000, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("chain", STAGE_CHAINS,
                         ids=[f"{s}-{d}" for s, d, _n, _l in STAGE_CHAINS])
def test_stage_chain_on_card(cuda_device, chain, precision):
    """The default float32 chains of the half-band, cascade and
    polynomial plans on the card, through their kernels, against the
    port's float64 CPU path: -141 dB under "fast", -143 dB under "high"
    (the CPU path reads -143.6 to -146.5 dB on these plans)."""
    src, dst, n, launches = chain
    rng = np.random.default_rng(17)
    x = rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32)
    rs = Resampler(src, dst, 2.0, 180.15, precision=precision,
                   device=cuda_device)
    before = frac_whole.launches
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert frac_whole.launches - before == launches
    ref = Resampler(src, dst, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x.astype(np.float64)).numpy()
    skip = int(0.025 * dst)
    d = y.cpu().double().numpy()[:, skip:-skip] - ref[:, skip:-skip]
    assert _rms_db(d) < (-143.0 if precision == "high" else -141.0)


@pytest.mark.cuda
def test_poly_chain_holds_class_under_tf32(cuda_device):
    """With TF32 switched on for the whole process the polynomial chain
    still holds -141 dB: its stage runs its products in IEEE float32 (and
    gives the same output as with TF32 off)."""
    rng = np.random.default_rng(18)
    x = rng.uniform(-1.0, 1.0, (3, 20000)).astype(np.float32)
    rs = Resampler(44100, 96001, 2.0, 180.15, device=cuda_device)
    y_off = rs.oneshot(x)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = rs.oneshot(x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(y, y_off)
    ref = Resampler(44100, 96001, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x.astype(np.float64)).numpy()
    skip = int(0.025 * 96001)
    d = y.cpu().double().numpy()[:, skip:-skip] - ref[:, skip:-skip]
    assert _rms_db(d) < -141.0


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["1", "0"], ids=["carry", "no_carry"])
@pytest.mark.parametrize("rates", [(44100, 192000), (192000, 44100),
                                   (44100, 96001)],
                         ids=["44k_192k", "192k_44k", "44k_96001"])
def test_stage_guarantee_chain_on_card(cuda_device, rates, carry,
                                       monkeypatch):
    """The guarantee chains of the half-band and polynomial plans on the
    card: one ozaki_framed launch a conv or half-band stage, within -150
    dB of the same chain's CPU run, and -150 dB (carry) or -141 dB (no
    carry) from the port's float64 path."""
    src, dst = rates
    monkeypatch.setenv("R8BT_DF_CARRY", carry)
    rng = np.random.default_rng(19)
    x = rng.uniform(-1.0, 1.0, (3, 30000)).astype(np.float32)
    rs = Resampler(src, dst, 2.0, 180.15, **OZ_CHAIN, device=cuda_device)
    before = ozaki_framed.launches
    y = rs.oneshot(x)
    torch.cuda.synchronize()
    assert ozaki_framed.launches - before == sum(
        type(e).__name__ != "FracPolyExec" for e in rs.execs)
    y = y.cpu().double().numpy()
    y_cpu = Resampler(src, dst, 2.0, 180.15, **OZ_CHAIN,
                      device="cpu").oneshot(x).double().numpy()
    ref = Resampler(src, dst, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x.astype(np.float64)).numpy()
    assert _rms_db(y - y_cpu) - _rms_db(y_cpu) < -150.0
    assert _rms_db(y - ref) - _rms_db(ref) < (-150.0 if carry == "1"
                                              else -141.0)


@pytest.mark.cuda
def test_cascade_f64_on_card(cuda_device):
    """The float64 cascade on the card (frac_whole's float64 kernel and
    the edge matrices) equals the per-stage float64 stencils to 1e-12 of
    max |y|, from inputs inside the edge region to long ones."""
    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops.hb_cascade import HBUpCascadeExec
    from r8brain_torch.ops.stages import HBUpExec

    specs = [s for s in make_plan(44100, 2822400, 2.0, 180.15, 0).stages
             if s.kind == "hb_up"]
    ex = HBUpCascadeExec(specs, torch.float64).to(cuda_device)
    rng = np.random.default_rng(20)
    for n in (3, 8, 40, 3000):
        x = torch.from_numpy(rng.standard_normal((2, n)))
        y = ex.apply(x.to(cuda_device)).cpu()
        for sp in specs:
            x = HBUpExec(sp, torch.float64).apply(x)
        assert y.shape == x.shape
        if y.numel():
            assert (y - x).abs().max() <= 1e-12 * x.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(precision="fast"),
                                dict(precision="high"),
                                dict(precision="high", oz_products=True)],
                         ids=["fast", "high", "oz_products"])
def test_poly_operators_on_card_equal_cpu(cuda_device, kw):
    """The polynomial stage's operators placed (and split) on the card
    from the host float64 filter values are the CPU's bit for bit, chunk
    by chunk, and the stage on the card holds the CPU's output within a
    few float32 ulps (the batched matmuls sum in their own order)."""
    from r8brain_torch.models.plan import make_plan
    from r8brain_torch.ops import stages

    spec = next(s for s in make_plan(44100, 96001, 2.0, 180.15, 0).stages
                if s.kind == "frac" and not s.is_whole)
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, 30000)).astype(
        np.float32))
    cpu = stages.FracPolyExec(spec, torch.float32, **kw)
    card = stages.FracPolyExec(spec, torch.float32, **kw).to(cuda_device)
    y_cpu, y_card = cpu.apply(x), card.apply(x.to(cuda_device)).cpu()
    (c_cpu, *_), = cpu._state.values()
    (c_card, *_), = card._state.values()
    assert len(c_cpu) == len(c_card)
    for (A, n, ops), (A2, n2, ops2) in zip(c_cpu, c_card):
        assert (A, n) == (A2, n2) and set(ops) == set(ops2)
        for k, v in ops.items():
            assert (v is None) == (ops2[k] is None)
            if v is not None:
                assert torch.equal(v, ops2[k].cpu()), k
    assert (y_cpu - y_card).abs().max() <= 2.0**-20 * y_cpu.abs().max()


# (label, src, dst, Resampler keywords, bound dB): the stream on the card
# against the port's float64 CPU path, re full scale ("fast", "high") or
# relative to the output (the guarantee chain)
STREAM_CASES = [("fast", 44100, 96000, {}, -141.0),
                ("guarantee", 44100, 96000, OZ_CHAIN, -150.0),
                ("poly", 44100, 96001, {}, -141.0),
                ("poly_high", 44100, 96001, dict(precision="high"), -143.0),
                ("poly_hb", 44100, 352800.3, {}, -141.0),
                ("poly_hb_high", 44100, 352800.3, dict(precision="high"),
                 -143.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_CASES,
                         ids=[c[0] for c in STREAM_CASES])
def test_stream_on_card(cuda_device, case):
    """The push-mode stream on the card: k-block calls against per-block
    calls (bit-equal on rational plans), the stream against the port's
    float64 CPU oneshot at the class bound, a checkpoint resumed bit for
    bit, and the kernels launched for the blocks (the interpolator has
    none of its own)."""
    from r8brain_torch import StreamResampler

    label, src, dst, kw, bound = case
    rs = Resampler(src, dst, 2.0, 180.15, device=cuda_device, **kw)
    st_1, st_k = StreamResampler(rs, 4096), StreamResampler(rs, 4096)
    L, k = st_1.block, 4
    n = 3 * k * L
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, n)).astype(
        np.float32)).to(cuda_device)
    before = frac_whole.launches + ozaki_framed.launches
    y1 = torch.cat([st_1.process_block_device(x[:, i : i + L])
                    for i in range(0, n, L)], dim=1)
    torch.cuda.synchronize()
    assert frac_whole.launches + ozaki_framed.launches > before
    yk = [st_k.process_blocks_device(x[:, : k * L])]
    ckpt = st_k.get_state()
    yk += [st_k.process_blocks_device(x[:, i : i + k * L])
           for i in range(k * L, n, k * L)]
    st_r = StreamResampler(rs, 4096)
    st_r.set_state(ckpt)
    yr = [st_r.process_blocks_device(x[:, i : i + k * L])
          for i in range(k * L, n, k * L)]
    assert all(torch.equal(a, b) for a, b in zip(yk[1:], yr))
    yk = torch.cat(yk, dim=1)
    assert yk.shape == y1.shape
    if label in ("fast", "guarantee"):
        assert torch.equal(yk, y1)
    ref = Resampler(src, dst, 2.0, 180.15, dtype=torch.float64,
                    device="cpu").oneshot(x.cpu().double()).numpy()
    m = y1.shape[1]
    skip = int(0.05 * dst)
    for y in (y1, yk):
        d = y.cpu().double().numpy()[:, skip:m] - ref[:, skip:m]
        db = _rms_db(d)
        if label == "guarantee":
            db -= _rms_db(ref[:, skip:m])
        assert db < bound, (label, db)


# (label, I, D, O): the forward call shapes whose adjoint the functional
# transform's gradient runs (the adjoint is frac_whole at I' = O, D' =
# ceil(D/I)*O, O' = I): the fused flagship, the toeplitz conv stage, the
# half-band upsampler, the direct conv stage (O' = 1: the 8-column tile)
# and the PCM -> DSD64 cascade (D' = 8192 on an operator mostly zeros)
ADJOINT_SHAPES = [("flagship", 294, 1027, 640), ("toeplitz", 256, 964, 512),
                  ("hb_up", 128, 150, 256), ("direct", 1, 709, 2),
                  ("cascade", 128, 157, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("lo", [False, True], ids=["main", "skT_lo"])
@pytest.mark.parametrize("shape", ADJOINT_SHAPES,
                         ids=[s[0] for s in ADJOINT_SHAPES])
def test_adjoint_kernel_matches_model(cuda_device, shape, lo):
    """frac_whole's gradient on the card: one adjoint launch (counted apart
    too), against the same Function on the CPU (the adjoint's plain model:
    frac_whole_ref on the adjoint geometry) within 2^-21 of max |xbar| and
    against the float64 transpose within 1e-5; and the float64 kernel's
    adjoint within 1e-12."""
    _label, I, D, O = shape
    C, n_win = 13, 9
    rng = np.random.default_rng(I + D + O)
    L = (n_win - 1) * I + D + 5
    x = rng.uniform(-1, 1, (C, L))
    w = rng.uniform(-1, 1, (C, n_win * O))
    skT = rng.standard_normal((D, O))
    skT_lo = rng.standard_normal((D, O)) * 2.0**-15 if lo else None
    t64 = [torch.from_numpy(a) for a in (skT, skT_lo) if a is not None]
    xr = torch.from_numpy(x).requires_grad_()
    (frac_whole_ref(xr, operator_parts(*t64), I, D, O, n_win)
     * torch.from_numpy(w)).sum().backward()
    ref = xr.grad.numpy()
    scale = np.abs(ref).max()
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        grads = {}
        for dev in ("cpu", cuda_device):
            parts = operator_parts(*(t.to(dev, dtype) for t in t64))
            xt = torch.tensor(x, dtype=dtype, device=dev,
                              requires_grad=True)
            before = (frac_whole.launches, frac_whole.adjoint_launches)
            y = frac_whole(xt, parts, I, D, O, n_win)
            y.backward(torch.tensor(w, dtype=dtype, device=dev))
            if dev != "cpu":
                torch.cuda.synchronize()
                assert frac_whole.launches == before[0] + 2
                assert frac_whole.adjoint_launches == before[1] + 1
            grads[dev] = xt.grad.cpu().double().numpy()
        g = grads[cuda_device]
        assert np.abs(g - ref).max() / scale < tol
        if dtype == torch.float32:
            assert np.abs(g - grads["cpu"]).max() / scale < 2.0**-21


GOLDENS = load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("cfg", GOLDENS, ids=[c["label"] for c in GOLDENS])
def test_goldens_on_card(cuda_device, cfg, precision):
    """Every C++ golden through the default float32 chain on the card
    within the -141 dB golden-equality class, as tests/
    test_torch_resampler.py::test_goldens holds the CPU model; prints the
    card's dB, the CPU model's and the card's distance from the model."""
    x = lcg_uniform(cfg["seed"], cfg["inlen"])
    ref = load_golden(cfg["file"])[2]
    args = (cfg["src"], cfg["dst"], cfg["tb"], cfg["atten"], cfg["phase"])
    ys = [Resampler(*args, precision=precision, device=dev).oneshot(
        x, cfg["outlen"]).cpu().double().numpy()
        for dev in (cuda_device, "cpu")]
    db, db_cpu = (rms_db(y - ref) for y in ys)
    print(f"golden {cfg['label']} {precision}: card {db:.2f} dB vs the C++ "
          f"golden, CPU model {db_cpu:.2f}, card - CPU model "
          f"{rms_db(ys[0] - ys[1]):.2f} dB re full scale")
    assert db < -141.0, (cfg["label"], precision, db)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(precision="high", conv_engine="ozaki",
                                         frac_engine="ozaki")],
                         ids=["default", "ozaki_twin"])
def test_functional_on_card(cuda_device, kw):
    """resample_fn on the card: forward bit-equal to oneshot, vmap over a
    leading batch equal to one call a batch within 2^-21 of max |y| (the
    batch folds into frac_whole's rows; the stream-start correction's
    float64 product may sum in another order), and the gradient (frac_whole's adjoint; the ozaki
    chain's through its default-engine twin) against the CPU model's
    within 2^-19 of max |g|, with adjoint launches counted."""
    from r8brain_torch import resample_fn

    n, C = 4410, 3
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (C, n)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        rs = Resampler(44100, 96000, 2.0, 180.15, device=dev, **kw)
        f = resample_fn(rs, n)
        xt = torch.from_numpy(x).to(dev)
        w = torch.from_numpy(rng.uniform(-1, 1, (C, rs.default_out_len(n)))
                             .astype(np.float32)).to(dev) if dev == "cpu" \
            else w.to(dev)
        assert torch.equal(f(xt), rs.oneshot(xt))
        before = frac_whole.adjoint_launches
        grads[dev] = torch.func.grad(lambda v: (w * f(v)).sum())(xt)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert frac_whole.adjoint_launches > before
            xb = torch.stack([xt, -xt])
            yb = torch.func.vmap(f)(xb)
            for b, y in enumerate((f(xt), f(-xt))):
                assert float((yb[b] - y).abs().max()) <= 2.0**-21 * float(
                    y.abs().max())
    g_cpu, g = grads["cpu"], grads[cuda_device].cpu()
    assert float((g - g_cpu).abs().max()) <= 2.0**-19 * float(
        g_cpu.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("pin", torch_fuzz.PINS,
                         ids=[p[0] for p in torch_fuzz.PINS])
def test_fuzzer_pins_on_card(cuda_device, pin):
    """tools/torch_fuzz.py's pins (the reference fuzzer's thinnest margins
    and the faults the port's sweeps found) on the card, each at its bound
    against the port's float64 oracle, relative."""
    from tools import torch_fuzz

    y, ref = torch_fuzz.run_pin(pin, cuda_device)
    d = torch_fuzz.rel_db(y, ref)
    print(f"pin {pin[0]} {pin[1]} {pin[2]}: {d:.2f} dB relative, "
          f"{rms_db(y - ref):.2f} re full scale")
    assert d < pin[3], (pin[0], d)


@pytest.mark.cuda
@pytest.mark.parametrize("pin", torch_fuzz.CLASS_PINS,
                         ids=[p[0] for p in torch_fuzz.CLASS_PINS])
def test_class_fault_pins_on_card(cuda_device, pin):
    """The faults the port's sweep found on the card at the sold class
    (tools/torch_fuzz.py CLASS_PINS): each within -141 dB re full scale
    of the float64 oracle; prints the CPU model's dB beside the card's."""
    y, ref = torch_fuzz.run_pin(pin, cuda_device)
    y_cpu, _ = torch_fuzz.run_pin(pin, "cpu")
    d = rms_db(y - ref)
    print(f"class pin {pin[0]} {pin[1]} {pin[2]}: card {d:.2f} dB re full "
          f"scale, CPU model {rms_db(y_cpu - ref):.2f}")
    assert d < pin[3], (pin[0], d)


@pytest.mark.cuda
def test_fuzzer_32_draws_on_card(cuda_device):
    """The differential fuzzer's first 32 draws with every executor on
    the card (orc, f32, oz, stm, nat, high, fft, sym): every pair within
    its bound, and no float32 executor (the default, "high", guarantee,
    df32-FFT and toeplitz_sym chains, the stream) above -141 dB re full
    scale."""
    import shutil

    ex = [e for e in torch_fuzz.BASE + torch_fuzz.CARD
          if e != "nat" or shutil.which("g++") is not None]
    summary, fails = torch_fuzz.sweep(32, 0, ex, cuda_device)
    print(summary)
    assert not fails, fails
    over = summary["re_fs_over_141"]
    assert all(n == 0 for n in over.values()), summary
