"""The port's FFT-convolution module (r8brain_torch/ops/pallas_dfft.py)
against the reference package's df32-FFT kernels and ops.

On the CPU ``df_fft_conv`` runs its plain version ``df_fft_conv_ref``
(complex128 ``torch.fft``, rounded once to float32).  These tests hold it
against the reference's radix-4 and radix-2 Pallas kernels in interpreter
mode (as tests/test_dfft4.py and tests/test_pallas.py run them), against
the XLA df32 composition ``df_ols_convolve``, and, for the three
four-step ``pallas_dfft5`` kernels, whose bodies XLA:CPU cannot compile in
reasonable time, against their wrappers with the body replaced by the
exact numpy model of tests/test_dfft5.py.  The CUDA kernel itself is held
to the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.ops import dfft as ref_dfft
from r8brain_tpu.ops import pallas_dfft5 as ref5
from r8brain_tpu.ops.pallas_dfft import (HAVE_PALLAS, DfFFTConvPlan,
                                         df_ols_convolve_pallas)
from r8brain_tpu.ops.pallas_dfft4 import (DfFFTConvPlan4,
                                          df_ols_convolve_pallas4)
from r8brain_torch.ops.pallas_dfft import (DfFFTPlan, df_fft_conv,
                                           framed_supported, supported_n)

from .helpers import rms_db
from .test_dfft5 import (_host_convolve5, _host_convolve5_framed,
                         _host_convolve5_framed_poly)

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="no pallas")


def _rel_db(y, ref):
    return rms_db(y - ref) - rms_db(ref)


def _frames_port(frames, plan):
    """df_fft_conv in frames mode over a [R, F, n] frame tensor viewed as
    one signal per row."""
    R, F, n = frames.shape
    u = torch.from_numpy(np.ascontiguousarray(frames).reshape(R, F * n))
    return df_fft_conv(u, plan, F, 0).double().numpy().reshape(R, F, n)


def _max_rel(y, ref):
    return np.abs(y - ref).max() / np.abs(ref).max()


# -- frames mode against the radix-4 and radix-2 Pallas kernels ----------


@pallas
@pytest.mark.parametrize("n", [256, 512])
def test_frames_mode_vs_pallas4_and_pallas(n):
    """df_ols_convolve_pallas4 (T2=2) and df_ols_convolve_pallas (packed,
    T=2) in interpreter mode return the hi word of their df32 result:
    within 2^-22 of max |y| of the port's correctly rounded float32
    (5.1e-8 measured at n = 512).  Odd frame counts exercise the packing
    of one frame alone."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal(n // 4)
    H = np.fft.fft(k, n) / n
    frames = rng.standard_normal((2, 5, n)).astype(np.float32)
    y = _frames_port(frames, DfFFTPlan(n, H))
    r4 = np.asarray(df_ols_convolve_pallas4(
        jnp.asarray(frames), DfFFTConvPlan4(n, H), T2=2, interpret=True),
        np.float64)
    r2 = np.asarray(df_ols_convolve_pallas(
        jnp.asarray(frames), DfFFTConvPlan(n, H), T=2, interpret=True,
        pack=True), np.float64)
    for r in (r4, r2):
        assert _max_rel(y, r) <= 2.0**-22


def test_frames_mode_vs_xla_df32():
    """The reference's XLA df32 convolution (the ``fft`` engine under
    "high") at n = 8192 is the float64 convolution rounded to float32:
    within 2^-23 of max |y| of the port (bit-equal measured)."""
    n = 8192
    rng = np.random.default_rng(2)
    k = rng.standard_normal(1417)
    H = np.fft.fft(k, n) / n
    frames = rng.uniform(-1, 1, (2, 3, n)).astype(np.float32)
    y = _frames_port(frames, DfFFTPlan(n, H))
    r = np.asarray(ref_dfft.df_ols_convolve(
        jnp.asarray(frames), np.ascontiguousarray(H.real),
        np.ascontiguousarray(H.imag), ref_dfft.DfFFT(n)), np.float64)
    assert _max_rel(y, r) <= 2.0**-23


# -- the three pallas_dfft5 kernels through their wrappers -----------------


def _patch5(monkeypatch):
    monkeypatch.setattr(ref5, "_convolve5", _host_convolve5)
    monkeypatch.setattr(ref5, "_convolve5_framed", _host_convolve5_framed)
    monkeypatch.setattr(ref5, "_convolve5_framed_poly",
                        _host_convolve5_framed_poly)


def test_pallas5_frames_wrapper(monkeypatch):
    """df_ols_convolve_pallas5's packing and padding (body: the exact
    numpy model) against frames mode, and both against the float64
    circular convolution at -135 dB (the bound of tests/test_dfft5.py)."""
    _patch5(monkeypatch)
    rng = np.random.default_rng(4)
    n = 1024
    k = rng.standard_normal(192)
    H = np.fft.fft(k, n) / n
    frames = rng.standard_normal((2, 3, n)).astype(np.float32)
    y = _frames_port(frames, DfFFTPlan(n, H))
    r = np.asarray(ref5.df_ols_convolve_pallas5(
        jnp.asarray(frames), ref5.DfFFTConvPlan5(n, H)), np.float64)
    exact = np.fft.ifft(np.fft.fft(frames.astype(np.float64), axis=-1)
                        * H * n, axis=-1).real
    assert _max_rel(y, r) <= 2.0**-22
    assert _rel_db(y, exact) < -135.0 and _rel_db(r, exact) < -135.0


def test_pallas5_framed_wrapper(monkeypatch):
    """df_ols_convolve_pallas5_framed (hop 3n/4, head n/4) against the
    framed mode at head n/4, and against np.convolve of the signal."""
    _patch5(monkeypatch)
    rng = np.random.default_rng(5)
    n, K, N = 4096, 700, 9000
    k = rng.standard_normal(K)
    H = np.fft.fft(k, n) / n
    plan5 = ref5.DfFFTConvPlan5(n, H)
    sig = rng.standard_normal((2, N))
    u_p = np.pad(sig, ((0, 0), (plan5.p_pad, 0))).astype(np.float32)
    n_frames = -(-N // plan5.hop)
    y = df_fft_conv(torch.from_numpy(u_p), DfFFTPlan(n, H), n_frames,
                    n // 4).double().numpy()
    r = np.asarray(ref5.df_ols_convolve_pallas5_framed(
        jnp.asarray(u_p), plan5, n_frames), np.float64)
    assert y.shape == (2, n_frames * plan5.hop)
    assert _max_rel(y, r[:, : y.shape[1]]) <= 2.0**-22
    m = N - K
    ref = np.stack([np.convolve(u_p[c, plan5.p_pad :].astype(np.float64),
                                k)[:m] for c in range(2)])
    assert _rel_db(y[:, :m], ref) < -135.0


def test_pallas5_framed_poly_wrapper(monkeypatch):
    """df_ols_convolve_pallas5_framed_poly's [C, 2, S] against the poly
    mode's interleaved output, and against np.convolve of the zero-stuffed
    signal with the whole kernel."""
    _patch5(monkeypatch)
    rng = np.random.default_rng(6)
    n, K, N = 4096, 1500, 7000
    k = rng.standard_normal(K)
    He, Ho = (np.fft.fft(k[p::2], n) / n for p in (0, 1))
    plan5 = ref5.DfFFTConvPlan5(n, He, Ho)
    sig = rng.standard_normal((2, N))
    x_p = np.pad(sig, ((0, 0), (plan5.p_pad, 0))).astype(np.float32)
    n_frames = -(-N // plan5.hop)
    y = df_fft_conv(torch.from_numpy(x_p), DfFFTPlan(n, He, Ho), n_frames,
                    n // 4).double().numpy()
    wp = np.asarray(ref5.df_ols_convolve_pallas5_framed_poly(
        jnp.asarray(x_p), plan5, n_frames), np.float64)
    r = np.swapaxes(wp, 1, 2).reshape(2, -1)
    assert y.shape == (2, 2 * n_frames * plan5.hop)
    assert _max_rel(y, r[:, : y.shape[1]]) <= 2.0**-22
    u = np.zeros((2, 2 * N))
    u[:, ::2] = x_p[:, plan5.p_pad :]
    m = 2 * N - K
    ref = np.stack([np.convolve(u[c], k)[:m] for c in range(2)])
    assert _rel_db(y[:, :m], ref) < -135.0


@pytest.mark.parametrize("n", [16384, 65536])
def test_four_step_sizes_vs_direct(n):
    """The sizes the card runs as a four-step split, in framed mode with
    the stage framing's head P, against np.convolve (-135 dB)."""
    rng = np.random.default_rng(n)
    K = n // 8 + 1
    k = rng.standard_normal(K)
    P = K - 1
    hop = n - P
    N = 2 * hop + 100
    u_p = np.pad(rng.uniform(-1, 1, (1, N)), ((0, 0), (P, 0))
                 ).astype(np.float32)
    y = df_fft_conv(torch.from_numpy(u_p), DfFFTPlan(n, np.fft.fft(k, n) / n),
                    3, P).double().numpy()
    ref = np.convolve(u_p[0, P:].astype(np.float64), k)[:N]
    assert _rel_db(y[0, :N], ref) < -135.0


# -- the plan and the wrapper ----------------------------------------------


def test_geometry_rules_match_reference():
    for b in range(7, 17):
        n = 1 << b
        assert supported_n(n) == ref5.supported_n(n)
        assert framed_supported(n) == ref5.framed_supported(n)


def test_plan_and_wrapper_checks():
    H = np.ones(256, complex)
    for bad in (64, 384, 131072):
        with pytest.raises(ValueError):
            DfFFTPlan(bad, np.ones(bad, complex))
    plan = DfFFTPlan(256, H)
    assert plan.G.dtype == torch.complex128 and plan.tw.shape == (256,)
    assert (plan.mode(0), plan.mode(64)) == ("frames", "framed")
    assert DfFFTPlan(256, H, H).mode(64) == "poly"
    u = torch.zeros((2, 600))
    for args in ((0, 0), (1, 256), (1, -1)):
        with pytest.raises(ValueError):
            df_fft_conv(u, plan, *args)
    with pytest.raises(TypeError):
        df_fft_conv(u.double(), plan, 1)
    before = df_fft_conv.launches
    # the identity kernel (G = 1/n, the inverse's scale folded in) returns
    # each frame; past u's end the frames read zeros
    y = df_fft_conv(u + 1.0, DfFFTPlan(256, np.full(256, 1 / 256, complex)),
                    3, 0)
    assert df_fft_conv.launches == before  # the CPU runs the plain version
    assert y.shape == (2, 768)
    assert torch.equal(y[:, :600], torch.ones((2, 600)))
    assert y[:, 600:].abs().max() < 1e-12
