"""The port's split-operand (ozaki) modules (r8brain_torch/ops/ozaki.py,
ops/pallas_ozaki.py) against the reference package's.

On the CPU ``ozaki_framed`` runs its plain version ``ozaki_framed_ref``;
these tests hold it against the reference's four Pallas kernels in
interpreter mode (the way tests/test_ozaki.py runs them), against the XLA
composition ``framed_matmul_ozaki`` and against the float64 product.  The
CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.models.plan import make_plan as ref_make_plan
from r8brain_tpu.ops import ozaki as ref_oz
from r8brain_tpu.ops.pallas_ozaki import (HAVE_PALLAS,
                                          _ozaki_matmul_pallas_var,
                                          ozaki_dense_pallas,
                                          ozaki_dense_pallas_pair,
                                          ozaki_matmul_pallas)
from r8brain_tpu.ops.stages import ConvExec as RefConvExec
from r8brain_tpu.ops.stages import FracWholeExec as RefFracWholeExec
from r8brain_torch.models.plan import make_plan
from r8brain_torch.ops import ozaki
from r8brain_torch.ops.pallas_ozaki import ozaki_framed, ozaki_framed_ref
from r8brain_torch.ops.stages import ConvExec, FracWholeExec

from .helpers import rms_db

OZ_CONFIGS = [("up_44k_96k", 44100, 96000, 180.15),
              ("up_44k_48k", 44100, 48000, 180.15),
              ("down_96k_44k", 96000, 44100, 180.15),
              ("preset_def", 44100, 96000, 206.91)]
IDS = [c[0] for c in OZ_CONFIGS]
pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="no pallas")


def _np(t):
    return np.asarray(t, dtype=np.float64)


def _sinc_operator(rng, L_f, G, width=8):
    t = np.arange(L_f)[:, None] - L_f / 2
    return np.sinc((t - rng.standard_normal((1, G)) * 4) / width) \
        * np.hanning(L_f)[:, None]


def _case(seed, C, n_blocks, hop, L_f, G, extra=0, lo=False):
    """Signal (float32), optional seam residual (float32, ~1e-7) and
    float64 operator of one framed product, as numpy arrays."""
    rng = np.random.default_rng(seed)
    N = (n_blocks - 1) * hop + L_f + extra
    xp = (rng.standard_normal((C, N)) * 1.7).astype(np.float32)
    T = _sinc_operator(rng, L_f, G)
    xl = (rng.standard_normal((C, N)) * 1e-7).astype(np.float32) \
        if lo else None
    return xp, xl, T


def _f64_product(v, T, n_blocks, hop):
    L_f = T.shape[0]
    fr = np.stack([v[:, b * hop : b * hop + L_f] for b in range(n_blocks)],
                  axis=1)
    return (fr @ T).reshape(v.shape[0], -1)


# -- operator split and scales ---------------------------------------------


@pytest.mark.parametrize("cfg", OZ_CONFIGS, ids=IDS)
def test_operator_slices_bit_equal_to_reference(cfg):
    """The conv and frac operators' bf16 slices and column scales, built by
    the port's executors, are bit-equal to the reference executors'."""
    _label, src, dst, atten = cfg
    conv, frac = make_plan(src, dst, 2.0, atten, 0).stages
    rconv, rfrac = ref_make_plan(src, dst, 2.0, atten, 0).stages
    ce = ConvExec(conv, torch.float32, "high", engine="ozaki")
    rce = RefConvExec(rconv, jnp.float32, precision="high", engine="ozaki")
    assert (ce.D_direct, ce.B_toep, ce.op.L_f, ce.s_min) == \
        (rce.D_direct, rce.B_toep, rce.oz_Lf, rce.s_min)
    assert np.array_equal(_np(ce.op.parts.double()), _np(rce.oz_parts))
    assert np.array_equal(ce.op.scale, rce.oz_scale)
    fe = FracWholeExec(frac, torch.float32, "high", engine="ozaki")
    rfe = RefFracWholeExec(rfrac, jnp.float32, precision="high",
                           engine="ozaki")
    assert (fe.a0, fe.D) == (rfe.a0, rfe.D)
    rparts, rscale = ref_oz.split_operator_host(rfe._sk64_t)
    assert np.array_equal(_np(fe.op.parts.double()), _np(rparts))
    assert np.array_equal(fe.op.scale, rscale)


def test_split_operator_exact_and_reconstructs():
    rng = np.random.default_rng(0)
    T = _sinc_operator(rng, 700, 256)
    parts, scale = ozaki.split_operator_host(T)
    assert parts.shape == (ozaki.N_PARTS, 700, 256)
    assert parts.dtype == torch.bfloat16
    assert np.array_equal(scale, np.exp2(np.round(np.log2(scale))))
    rec = parts.double().sum(dim=0).numpy()
    assert np.abs(rec - T).max() <= np.abs(T).max() * 2.0**-32
    rparts, rscale = ref_oz.split_operator_host(T)
    assert np.array_equal(parts.double().numpy(), _np(rparts))
    assert np.array_equal(scale, rscale)


def _edge_amplitudes(ks, kinds):
    vals = []
    for k in ks:
        p = np.float32(2.0**k)
        for kind in kinds:
            vals.append({"pow2": p, "below": np.nextafter(p, np.float32(0)),
                         "above": np.nextafter(p, np.float32(np.inf)),
                         "mid": p * np.float32(1.5)}[kind])
    return np.asarray(vals, np.float32)[:, None]


def test_channel_scale_bit_equal_to_reference():
    """Amplitudes at, just below and half again above 2^k (scales 2^-12
    to 2^12),
    and random audio blocks: the scales equal the reference's bit for
    bit.  (Beyond |k| = 12 the reference's float32 exp2 on the CPU is
    not exact and its scales are not powers of two; ROADMAP.md section
    3.)"""
    v = _edge_amplitudes(range(-12, 12), ("pow2", "below", "mid"))
    rng = np.random.default_rng(1)
    audio = (rng.uniform(-1, 1, (64, 300))
             * rng.uniform(1e-3, 4.0, (64, 1))).astype(np.float32)
    for x in (v, -v, audio, np.zeros((2, 5), np.float32)):
        s = ozaki.channel_scale(torch.from_numpy(x)).numpy()
        s_ref = np.asarray(ref_oz.channel_scale(jnp.asarray(x)))
        assert s.dtype == np.float32 and s.shape == (x.shape[0], 1)
        assert np.array_equal(s, s_ref)


def test_channel_scale_just_above_a_power_of_two():
    """Just above 2^k the float32 log2 rounds down to k for most k, in
    the port as in the reference: s = 2^k < amax (ROADMAP.md section 3).
    The scale is still an exact power of two, the leading slice holds
    256 units, and the split stays exact."""
    ks = range(-30, 31)
    v = _edge_amplitudes(ks, ("above",))
    s = ozaki.channel_scale(torch.from_numpy(v)).numpy()[:, 0]
    assert np.array_equal(s, np.exp2(np.round(np.log2(s.astype(np.float64)))))
    low = s < v[:, 0]
    assert low.sum() >= 40  # the reference's formula, kept as it is
    assert np.all(v[:, 0] <= s.astype(np.float64) * (1 + 2.0**-22))
    parts, _ = ozaki.split_input(torch.from_numpy(v))
    rec = parts.double().sum(dim=0).numpy() * s[:, None]
    assert np.array_equal(rec, v.astype(np.float64))
    assert np.abs(parts[0].double().numpy() * 256).max() <= 256


def test_split_input_bit_equal_to_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 500)) * 7.3).astype(np.float32)
    parts, s = ozaki.split_input(torch.from_numpy(x))
    rparts, rs = ref_oz.split_input(jnp.asarray(x))
    assert np.array_equal(parts.double().numpy(), _np(rparts))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    rec = parts.double().sum(dim=0).numpy() * s.numpy()
    assert np.abs(rec - x).max() <= s.max() * 2.0**-32


def test_accumulation_exactness_lemma():
    """A K0-deep float32 matmul of bf16 slice-pair products equals the
    float64 product exactly, for every kept pair (tests/test_ozaki.py:51
    in torch)."""
    rng = np.random.default_rng(3)
    xparts, _ = ozaki.split_input(
        torch.from_numpy(rng.standard_normal((4, ozaki.K0))))
    tparts, _ = ozaki.split_operator_host(
        rng.standard_normal((ozaki.K0, 128)))
    for p in range(ozaki.N_PARTS):
        for q in range(ozaki.N_DIAG - p):
            a, b = xparts[p], tparts[q]
            got = torch.matmul(a.float(), b.float()).double()
            assert torch.equal(got, a.double() @ b.double()), (p, q)


# -- the kernel's plain version against the reference's kernels -----------


@pallas
def test_ref_matches_ozaki_matmul_pallas():
    C, n_blocks, hop, L_f, G = 8, 3, 256, 700, 256
    xp, _, T = _case(4, C, n_blocks, hop, L_f, G, extra=68)  # S - L_f, S = 768
    Tp, _ = ref_oz.split_operator_host(T)
    sx = ref_oz.channel_scale(jnp.asarray(xp))
    y_ref = ozaki_matmul_pallas(jnp.asarray(xp), sx, jnp.asarray(Tp), L_f,
                                hop, G, CT=8, interpret=True)
    parts, _ = ozaki.split_operator_host(T)
    y = ozaki_framed(torch.from_numpy(xp), torch.from_numpy(np.array(sx)),
                     parts, L_f, hop, G, n_blocks)
    assert y.shape == (C, n_blocks * G) and y.dtype == torch.float32
    assert np.array_equal(y.numpy(), np.asarray(y_ref))


@pallas
@pytest.mark.parametrize("has_lo,emit_pair", [(False, True), (True, False),
                                              (True, True)],
                         ids=["emit", "consume", "consume_emit"])
def test_ref_matches_ozaki_matmul_pallas_var(has_lo, emit_pair):
    """The df32-carry variants.  The exact part agrees bit for bit; the
    x_lo pass is an inexact float32 sum (~2^-24 of the output) whose
    order may differ from the interpreter's, so outputs with x_lo may
    differ in their last bit: max |diff| <= 2^-22 max |y|, and the
    collapsed pair holds -150 dB against the float64 product."""
    C, n_blocks, hop, L_f, G = 8, 3, 256, 700, 256
    xp, xl, T = _case(6, C, n_blocks, hop, L_f, G, extra=68, lo=has_lo)
    Tp, _ = ref_oz.split_operator_host(T)
    sx = ref_oz.channel_scale(jnp.asarray(xp))
    xl_b = None if xl is None else jnp.asarray(xl).astype(jnp.bfloat16)
    res = _ozaki_matmul_pallas_var(jnp.asarray(xp), xl_b, sx,
                                   jnp.asarray(Tp), L_f, hop, G, CT=8,
                                   emit_pair=emit_pair, interpret=True)
    parts, _ = ozaki.split_operator_host(T)
    x_lo = None if xl is None else torch.from_numpy(xl).to(torch.bfloat16)
    out = ozaki_framed(torch.from_numpy(xp),
                       torch.from_numpy(np.array(sx)), parts, L_f, hop, G,
                       n_blocks, x_lo=x_lo, emit_pair=emit_pair)
    if emit_pair:
        (yh, yl), (rh, rl) = out, res
        assert yl.dtype == torch.bfloat16
        y, r = yh.double().numpy() + yl.double().numpy(), _np(rh) + _np(rl)
    else:
        y, r = out.double().numpy(), _np(res)
    if not has_lo:
        assert np.array_equal(yh.numpy(), np.asarray(rh))
        assert np.array_equal(yl.double().numpy(), _np(rl))
    else:
        assert np.abs(y - r).max() <= np.abs(r).max() * 2.0**-22
    v = xp.astype(np.float64)
    if xl is not None:
        v = v + _np(xl_b)
    ref = _f64_product(v, T, n_blocks, hop)
    assert rms_db(y - ref) - rms_db(ref) < -150.0


def _dense_case(seed, C, n_win, I, D, G):
    """The frac-stage form: windows at stride I read straight from the
    signal (port) or pre-framed rows with per-row scales (reference)."""
    xp, _, T = _case(seed, C, n_win, I, D, G, extra=5)
    Kpad = -(-D // 128) * 128
    RT = 256
    fr = np.stack([xp[:, m * I : m * I + D] for m in range(n_win)],
                  axis=1).reshape(C * n_win, D)
    R = fr.shape[0]
    R_pad = -(-R // RT) * RT
    frp = np.zeros((R_pad, Kpad), np.float32)
    frp[:R, :D] = fr
    sxc = np.array(ref_oz.channel_scale(jnp.asarray(xp)))
    sxr = np.ones((R_pad, 1), np.float32)
    sxr[:R] = np.repeat(sxc, n_win, axis=0)
    Tp, _ = ref_oz.split_operator_host(T)
    pp = np.zeros((Tp.shape[0], Kpad, G), dtype=Tp.dtype)
    pp[:, :D, :] = Tp
    ref_args = (jnp.asarray(frp), jnp.asarray(sxr), jnp.asarray(pp), D, G)
    return xp, sxc, T, R, ref_args


@pallas
@pytest.mark.parametrize("emit_pair", [False, True], ids=["dense", "pair"])
@pytest.mark.parametrize("D", [170, 341], ids=["D170", "D341"])
def test_ref_matches_ozaki_dense_pallas(D, emit_pair):
    """ozaki_dense_pallas(_pair) on pre-framed rows against the port's
    windows read straight from the signal with per-channel scales: bit
    for bit, at one and at two K0-chunks of D."""
    C, n_win, I, G = 7, 40, 147, 160
    xp, sxc, T, R, ref_args = _dense_case(7, C, n_win, I, D, G)
    parts, _ = ozaki.split_operator_host(T)
    out = ozaki_framed(torch.from_numpy(xp), torch.from_numpy(sxc), parts,
                       D, I, G, n_win, emit_pair=emit_pair)
    if emit_pair:
        rh, rl = ozaki_dense_pallas_pair(*ref_args, RT=256, interpret=True)
        yh, yl = out
        assert np.array_equal(yh.numpy().reshape(R, G), np.asarray(rh)[:R])
        assert np.array_equal(yl.double().numpy().reshape(R, G),
                              _np(rl)[:R])
    else:
        r = ozaki_dense_pallas(*ref_args, RT=256, interpret=True)
        assert np.array_equal(out.numpy().reshape(R, G), np.asarray(r)[:R])


# -- the plain version against the compositions and float64 --------------


@pytest.mark.parametrize("lo,pair", [(False, False), (True, False),
                                     (False, True), (True, True)],
                         ids=["plain", "lo", "pair", "lo_pair"])
def test_ref_against_compositions_and_f64(lo, pair):
    """C not a multiple of 8, L_f not a multiple of 16 and crossing two
    K0 chunks, an odd hop: against the port's and the reference's XLA
    composition and the float64 product, at -150 dB."""
    C, n_blocks, hop, L_f, G = 5, 9, 301, 599, 96
    xp, xl, T = _case(8, C, n_blocks, hop, L_f, G, extra=37, lo=lo)
    parts, _ = ozaki.split_operator_host(T)
    xt = torch.from_numpy(xp)
    sx = ozaki.channel_scale(xt[:, : (n_blocks - 1) * hop + L_f])
    x_lo = None if xl is None else torch.from_numpy(xl).to(torch.bfloat16)
    out = ozaki_framed_ref(xt, sx, parts, L_f, hop, G, n_blocks, x_lo=x_lo,
                           emit_pair=pair)
    y = (out[0].double() + out[1].double() if pair else out.double()).numpy()
    v = xp.astype(np.float64)
    if x_lo is not None:
        v = v + x_lo.double().numpy()
    ref = _f64_product(v, T, n_blocks, hop)
    assert rms_db(y - ref) - rms_db(ref) < -150.0
    comp = ozaki.framed_matmul_ozaki(xt, parts, n_blocks, hop, x_lo=x_lo,
                                     pair=pair)
    rcomp = ref_oz.framed_matmul_ozaki(
        jnp.asarray(xp), jnp.asarray(np.asarray(parts.float()),
                                     jnp.bfloat16), n_blocks, hop,
        x_lo=None if xl is None else jnp.asarray(xl), pair=pair)
    if pair:
        c = comp[0].double() + comp[1].double()
        rc = _np(rcomp[0]) + _np(rcomp[1])
    else:
        c, rc = comp.double(), _np(rcomp)
    c = c.reshape(C, -1).numpy()
    rc = rc.reshape(C, -1)
    assert rms_db(y - c) - rms_db(c) < -150.0
    assert rms_db(c - rc) - rms_db(rc) < -150.0
    if not lo:
        # the same float32 operations in the same order
        assert np.array_equal(c, rc)


def test_framed_cheap_matches_reference():
    rng = np.random.default_rng(9)
    C, n_blocks, hop, L_f, G = 3, 11, 147, 170, 160
    xl = (rng.standard_normal((C, n_blocks * hop + L_f)) * 1e-7)
    T0 = _sinc_operator(rng, L_f, G)
    t0 = torch.from_numpy(T0).to(torch.bfloat16)
    y = ozaki.framed_cheap(torch.from_numpy(xl).float(), t0, n_blocks, hop)
    r = ref_oz.framed_cheap(jnp.asarray(xl, jnp.float32),
                            jnp.asarray(np.asarray(t0.float()), jnp.bfloat16),
                            n_blocks, hop)
    assert y.shape == (C, n_blocks, G)
    # float32 sums of L_f inexact products in another order: within the
    # summation bound L_f * 2^-24 * sum |x_lo| |T0| of each output
    mag = ozaki.framed_cheap(torch.from_numpy(np.abs(xl)).float(), t0.abs(),
                             n_blocks, hop).double().numpy()
    assert np.all(np.abs(y.double().numpy() - _np(r))
                  <= L_f * 2.0**-24 * mag)


def test_rejects_bad_arguments():
    xp = torch.zeros(2, 100)
    sx = torch.ones(2, 1)
    parts = torch.zeros(4, 40, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="windows"):
        ozaki_framed(xp, sx, parts, 40, 10, 8, 8)  # needs 110 samples
    with pytest.raises(TypeError):
        ozaki_framed(xp.double(), sx, parts, 40, 10, 8, 2)
    with pytest.raises(ValueError, match="T_parts"):
        ozaki_framed(xp, sx, parts.float(), 40, 10, 8, 2)
    with pytest.raises(ValueError, match="sx"):
        ozaki_framed(xp, torch.ones(2), parts, 40, 10, 8, 2)
    with pytest.raises(ValueError, match="x_lo"):
        ozaki_framed(xp, sx, parts, 40, 10, 8, 2, x_lo=xp)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ozaki_framed(xp.to("meta"), sx.to("meta"), parts.to("meta"), 40, 10,
                     8, 2)


def test_cpu_tensor_runs_plain_version_uncounted():
    before = ozaki_framed.launches
    xp, _, T = _case(10, 2, 3, 147, 170, 160)
    parts, _ = ozaki.split_operator_host(T)
    xt = torch.from_numpy(xp)
    sx = ozaki.channel_scale(xt)
    y = ozaki_framed(xt, sx, parts, 170, 147, 160, 3)
    assert torch.equal(y, ozaki_framed_ref(xt, sx, parts, 170, 147, 160, 3))
    assert ozaki_framed.launches == before
