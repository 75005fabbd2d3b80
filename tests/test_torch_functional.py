"""The port's functional transform (r8brain_torch/functional.py) against the
reference package's (r8brain_tpu/functional.py), on the CPU: every test of
tests/test_functional.py but the pjit one (channel sharding is a later
slice), with torch.func in place of jax transforms, plus the gradient
held against jax.grad of the reference closure and the twin path of the
chains whose kernels have no gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vjp, vmap

import r8brain_tpu as r8b
from r8brain_tpu.functional import resample_fn as ref_resample_fn
from r8brain_torch import Resampler, resample_fn
from r8brain_torch.functional import _needs_twin
from r8brain_torch.models.resampler import run_chain

from .helpers import rms_db

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's small tensor ops on one thread (see
    tests/test_torch_stage_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sig(c, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((c, n)).astype(np.float32) * 0.5


def _rel_db(a, b) -> float:
    return rms_db(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        - rms_db(np.asarray(b, np.float64))


def _vdot_grad(f, w):
    """x -> grad_x <w, f(x)>."""
    return grad(lambda x: (w * f(x)).sum())


@pytest.mark.parametrize("src,dst", [(44100, 96000), (96000, 44100),
                                     (44100, 96001)])
def test_matches_oneshot(src, dst):
    """Bit-equal to the port's oneshot; within the class of the reference
    package's resample_fn on the same input."""
    rs = Resampler(src, dst, atten=136.45, **CPU)
    x = _sig(3, src // 4)
    f = resample_fn(rs, x.shape[1])
    y = f(x)
    y_os = rs.oneshot(x)
    assert y.shape == y_os.shape
    assert torch.equal(y, y_os)
    y_ref = np.asarray(ref_resample_fn(r8b.Resampler(src, dst, atten=136.45),
                                       x.shape[1])(x))
    assert rms_db(y.double().numpy() - y_ref) < -125.0


def test_composes_inside_a_user_function():
    rs = Resampler(44100, 48000, atten=109.56, **CPU)
    x = torch.from_numpy(_sig(2, 8000))
    f = resample_fn(rs, 8000)

    def program(x, g):
        return f(x * g) + 1.0

    y = program(x, 2.0)
    ref = rs.oneshot(x * 2.0) + 1.0
    assert rms_db((y - ref).double().numpy()) < -130.0


def test_vmap_over_leading_batch():
    rs = Resampler(44100, 96000, atten=109.56, **CPU)
    xb = torch.from_numpy(np.stack([_sig(2, 4410, seed=s)
                                    for s in range(4)]))  # [B, C, N]
    f = resample_fn(rs, 4410)
    yb = vmap(f)(xb)
    for b in range(4):
        ref = rs.oneshot(xb[b])
        assert rms_db((yb[b] - ref).double().numpy()) < -120.0


def test_linearity_jvp_exact():
    # The chain is linear: jvp at any point equals f applied to the tangent.
    rs = Resampler(44100, 96000, atten=136.45, **CPU)
    f = resample_fn(rs, 4410)
    x, dx = (torch.from_numpy(_sig(2, 4410, s)) for s in (1, 2))
    y, dy = jvp(f, (x,), (dx,))
    assert torch.equal(y, f(x))
    np.testing.assert_allclose(dy.numpy(), f(dx).numpy(), rtol=0, atol=1e-5)


def test_grad_is_transpose():
    # grad_x <w, f(x)> = f^T w: <w, f(x)> must equal <g, x> for linear f.
    rs = Resampler(44100, 48000, atten=109.56, **CPU)
    n = 2048
    f = resample_fn(rs, n)
    x = torch.from_numpy(_sig(1, n, 3))
    w = torch.from_numpy(_sig(1, rs.default_out_len(n), 4))
    g = _vdot_grad(f, w)(x)
    assert g.shape == x.shape and torch.isfinite(g).all()
    lhs = float((w.double() * f(x).double()).sum())
    rhs = float((g.double() * x.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))


GRAD_CASES = [("44.1k->96k", 44100, 96000, "fast"),
              ("44.1k->48k high", 44100, 48000, "high"),
              ("44.1k->192k", 44100, 192000, "fast"),
              ("44.1k->96001", 44100, 96001, "fast")]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grad_matches_reference(case):
    """The port's gradient (frac_whole's adjoint model, the polynomial
    stage's torch products) against jax.grad of the reference closure on
    the same input and weights, within -120 dB relative; torch.func.vjp
    and loss.backward() give the same gradient."""
    _label, src, dst, precision = case
    n = 3000
    rs = Resampler(src, dst, atten=136.45, precision=precision, **CPU)
    ref = r8b.Resampler(src, dst, atten=136.45, precision=precision)
    x = _sig(2, n, 11)
    w = _sig(2, rs.default_out_len(n), 12)
    f = resample_fn(rs, n)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    g = _vdot_grad(f, wt)(xt)
    f_ref = ref_resample_fn(ref, n)
    g_ref = np.asarray(jax.grad(lambda v: jnp.vdot(w, f_ref(v)))(x))
    assert _rel_db(g.numpy(), g_ref) < -120.0
    _, pull = vjp(f, xt)
    assert torch.equal(pull(wt)[0], g)
    xr = xt.clone().requires_grad_()
    (wt * f(xr)).sum().backward()
    assert torch.equal(xr.grad, g)


def test_vmap_of_grad():
    rs = Resampler(44100, 96000, atten=136.45, **CPU)
    f = resample_fn(rs, 2000)
    xb = torch.from_numpy(np.stack([_sig(2, 2000, s) for s in (1, 2)]))
    w = torch.from_numpy(_sig(2, rs.default_out_len(2000), 3))
    gb = vmap(_vdot_grad(f, w))(xb)
    g = _vdot_grad(f, w)(xb[0])
    assert torch.equal(gb[0], gb[1]) and torch.equal(gb[0], g)


def test_passthrough_and_length_checks():
    rs = Resampler(48000, 48000, **CPU)
    f = resample_fn(rs, 100)
    x = torch.from_numpy(_sig(2, 100))
    assert torch.equal(f(x), x)
    with pytest.raises(ValueError):
        f(torch.from_numpy(_sig(2, 101)))
    with pytest.raises(ValueError):
        resample_fn(rs, 0)
    with pytest.raises(ValueError):
        resample_fn(rs, 100, out_len=-1)
    y = resample_fn(rs, 100, out_len=150)(x)
    assert y.shape == (2, 150) and float(y[:, 100:].abs().max()) == 0.0


def test_1d_input():
    rs = Resampler(44100, 96000, atten=109.56, **CPU)
    x = _sig(1, 4410)[0]
    y = resample_fn(rs, 4410)(x)
    assert y.ndim == 1
    ref = rs.oneshot(x)
    assert rms_db((y - ref).double().numpy()) < -120.0


def test_grad_through_poly_mode():
    # The polynomial interpolator (irrational ratio) differentiates too:
    # its operators are constants, its products torch operations.
    rs = Resampler(44100, 96001, atten=109.56, **CPU)
    n = 2048
    f = resample_fn(rs, n)
    x = torch.from_numpy(_sig(1, n, 7))
    w = torch.from_numpy(_sig(1, rs.default_out_len(n), 8))
    g = _vdot_grad(f, w)(x)
    assert g.shape == x.shape and torch.isfinite(g).all()
    lhs = float((w.double() * f(x).double()).sum())
    rhs = float((g.double() * x.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))


TWIN_CASES = [("ozaki", dict(precision="high", conv_engine="ozaki",
                             frac_engine="ozaki")),
              ("toeplitz_sym", dict(fused=False,
                                    conv_engine="toeplitz_sym")),
              ("pallas_fft5", dict(precision="high", fused=False,
                                   conv_engine="pallas_fft5"))]


@pytest.mark.parametrize("case", TWIN_CASES, ids=[c[0] for c in TWIN_CASES])
def test_twin_path(case):
    """A chain on a kernel without a gradient: the forward is that chain
    (bit-equal to its oneshot, the df32 carry included), the gradient the
    twin's (the default chain of the same plan and precision), within
    -120 dB relative of the default chain's own, under torch.func.grad,
    vmap and backward(); jvp is the chain on the tangent."""
    _label, kw = case
    n = 3000
    rs = Resampler(44100, 96000, atten=136.45, **kw, **CPU)
    rs_def = Resampler(44100, 96000, atten=136.45,
                       precision=kw["precision"] if "precision" in kw
                       else "fast", **CPU)
    assert _needs_twin(rs.execs) and not _needs_twin(rs_def.execs)
    f, f_def = resample_fn(rs, n), resample_fn(rs_def, n)
    x = torch.from_numpy(_sig(2, n, 5))
    w = torch.from_numpy(_sig(2, rs.default_out_len(n), 6))
    assert torch.equal(f(x), rs.oneshot(x))
    g = _vdot_grad(f, w)(x)
    g_def = _vdot_grad(f_def, w)(x)
    assert _rel_db(g.numpy(), g_def.numpy()) < -120.0
    xb = torch.stack([x, -x])
    gb = vmap(_vdot_grad(f, w))(xb)
    assert torch.equal(gb[0], gb[1]) and torch.equal(gb[0], g)
    assert torch.equal(vmap(f)(xb)[1], f(-x))
    xr = x.clone().requires_grad_()
    (w * f(xr)).sum().backward()
    assert torch.equal(xr.grad, g)
    _y, dy = jvp(f, (x,), (x,))
    assert torch.equal(dy, f(x))


def test_twin_detection():
    """The counterpart of the reference's _has_pallas: the chains whose
    kernels have no gradient."""
    assert not _needs_twin(Resampler(44100, 96000, atten=136.45,
                                     **CPU).execs)
    for kw in (dict(precision="high", fused=False, conv_engine="fft"),
               dict(precision="high", frac_engine="ozaki")):
        assert _needs_twin(Resampler(44100, 96001 if "frac_engine" in kw
                                     else 96000, atten=136.45, **kw,
                                     **CPU).execs)
    assert not _needs_twin(Resampler(44100, 96000, atten=136.45, fused=False,
                                     conv_engine="fft", **CPU).execs)


@pytest.mark.parametrize("case", TWIN_CASES, ids=[c[0] for c in TWIN_CASES])
@pytest.mark.parametrize("how", ["backward", "grad", "jvp"])
def test_kernels_without_gradient_refuse_tracking(case, how):
    """ozaki_framed, sym_conv and df_fft_conv have no gradient: a chain on
    one of them that autograd or torch.func tracks outside resample_fn's
    twin raises, rather than dropping that kernel's share of the
    gradient."""
    _label, kw = case
    rs = Resampler(44100, 96000, atten=136.45, **kw, **CPU)
    x = torch.from_numpy(_sig(1, 2000, 7))

    def chain(v):
        return run_chain(rs.execs, v, rs.df_carry)

    with pytest.raises(RuntimeError, match="has no gradient"):
        if how == "backward":
            chain(x.clone().requires_grad_()).sum().backward()
        elif how == "grad":
            grad(lambda v: chain(v).sum())(x)
        else:
            jvp(chain, (x,), (x,))
