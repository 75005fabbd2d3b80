"""The pass structure of df_fft_conv's register-resident kernel (n <=
8192, r8brain_torch/csrc/df_fft_conv.cu) on the CPU: a torch model of its
radix-16 passes and digit order, held against torch.fft and against the
reference package's df32 convolution, and the plan's permuted spectrum.

The model runs the kernel's passes as it orders them: forward decimation
in frequency over ``pass_radices(n)`` (radix R0 first, then 16), the
product by ``DfFFTPlan.Gk`` in the order the forward transform leaves the
points in, the inverse decimation in time with conjugate twiddles before
each butterfly, in reverse order.  The CUDA kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from r8brain_tpu.ops import dfft as ref_dfft
from r8brain_torch.ops.pallas_dfft import (RADIX, SMEM_MAX_N, DfFFTPlan,
                                           df_fft_conv, digit_order,
                                           pass_radices)

SIZES = [1 << b for b in range(7, 14)]  # 128 .. 8192
# the model against torch.fft, relative to the largest magnitude
MODEL_REL_TOL = 1e-13


def _w(L, e):
    """exp(-2*pi*i*e/L), complex128."""
    return torch.exp(-2j * np.pi * torch.as_tensor(e, dtype=torch.float64)
                     / L)


def _dft_matrix(r, inverse):
    m = torch.arange(r, dtype=torch.float64)
    W = _w(r, m[:, None] * m[None, :])
    return W.conj() if inverse else W


def forward_passes(x):
    """The kernel's forward transform of x [..., n]: decimation in
    frequency, each pass over sub-problems of L points at stride s = L/r:
    the r-point DFT of x[b + j + s*m], outputs times W_L^(jk) to b + j +
    s*k.  Position p then holds X[digit_order(n)[p]]."""
    n = x.shape[-1]
    L = n
    for r in pass_radices(n):
        s = L // r
        t = x.reshape(*x.shape[:-1], n // L, r, s)       # [.., b, m, j]
        y = torch.einsum("km,...mj->...kj", _dft_matrix(r, False), t)
        k = torch.arange(r, dtype=torch.float64)[:, None]
        j = torch.arange(s, dtype=torch.float64)[None, :]
        x = (y * _w(L, k * j)).reshape(x.shape)
        L = s
    return x


def inverse_passes(y):
    """The kernel's inverse transform of y [..., n] in digit order:
    decimation in time, the forward's passes in reverse, each the
    conjugate twiddles on the inputs, then the inverse r-point DFT;
    unscaled (n * ifft), natural order out."""
    n = y.shape[-1]
    lens, L = [], n
    for r in pass_radices(n):
        lens.append((r, L))
        L //= r
    for r, L in reversed(lens):
        s = L // r
        t = y.reshape(*y.shape[:-1], n // L, r, s)       # [.., b, k, j]
        k = torch.arange(r, dtype=torch.float64)[:, None]
        j = torch.arange(s, dtype=torch.float64)[None, :]
        t = t * _w(L, k * j).conj()
        y = torch.einsum("mk,...kj->...mj", _dft_matrix(r, True),
                         t).reshape(y.shape)
    return y


def conv_model(frames, plan):
    """The kernel's convolution of complex frames [..., n]: forward
    passes, the product by plan.Gk read as the kernel reads it (thread tau
    register m holds position 16*tau + m), inverse passes."""
    n = plan.n
    G_pos = plan.Gk.T.reshape(n)  # position 16*tau + m
    return inverse_passes(forward_passes(frames) * G_pos)


def _max_rel(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n", SIZES)
def test_pass_radices_and_digit_order(n):
    radices = pass_radices(n)
    assert int(np.prod(radices)) == n
    assert all(r == RADIX for r in radices[1:]) and radices[0] <= RADIX
    order = digit_order(n)
    assert sorted(order.tolist()) == list(range(n))  # a permutation


def test_pass_radices_of_the_main_path_sizes():
    assert pass_radices(4096) == (16, 16, 16)
    assert pass_radices(8192) == (2, 16, 16, 16)
    assert pass_radices(2048) == (8, 16, 16)


@pytest.mark.parametrize("poly", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_permuted_spectrum_unpermutes_bit_for_bit(n, poly):
    rng = np.random.default_rng(n)
    H = np.fft.fft(rng.standard_normal(n // 3), n) / n
    H2 = np.fft.fft(rng.standard_normal(n // 3), n) / n if poly else None
    plan = DfFFTPlan(n, H, H2)
    assert plan.Gk.shape == (RADIX, n // RADIX) and plan.Gk.is_contiguous()
    back = torch.empty_like(plan.G)
    back[torch.from_numpy(digit_order(n))] = plan.Gk.T.reshape(n)
    assert torch.equal(back, plan.G)


def test_no_permuted_spectrum_above_the_register_sizes():
    n = 2 * SMEM_MAX_N
    assert not hasattr(DfFFTPlan(n, np.ones(n, complex)), "Gk")


@pytest.mark.parametrize("n", SIZES)
def test_pass_model_vs_torch_fft(n):
    """Forward passes in digit order against torch.fft.fft, inverse passes
    against n * ifft, each within 1e-13 of the largest magnitude."""
    rng = np.random.default_rng(n + 1)
    x = torch.from_numpy(rng.standard_normal((3, n))
                         + 1j * rng.standard_normal((3, n)))
    X = torch.fft.fft(x)
    Xp = forward_passes(x)
    assert _max_rel(Xp, X[:, torch.from_numpy(digit_order(n))]) \
        <= MODEL_REL_TOL
    back = inverse_passes(Xp)
    assert _max_rel(back, n * x) <= MODEL_REL_TOL


@pytest.mark.parametrize("poly", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_conv_model_vs_torch_fft(n, poly):
    """The whole convolution of the model (two real frames a transform, or
    one with the polyphase spectrum H_e + i H_o) against the plain
    version's torch.fft route, within 1e-13 of max |y|."""
    rng = np.random.default_rng(n + 2)
    k = rng.standard_normal(min(701, n // 2))
    ks = (k[0::2], k[1::2]) if poly else (k,)
    plan = DfFFTPlan(n, *[np.fft.fft(kk, n) / n for kk in ks])
    a, b = (torch.from_numpy(rng.uniform(-1, 1, (4, n))) for _ in range(2))
    frames = a.to(torch.complex128) if poly else a + 1j * b
    y = conv_model(frames, plan)
    ref = torch.fft.ifft(torch.fft.fft(frames) * plan.G, norm="forward")
    assert _max_rel(y, ref) <= MODEL_REL_TOL


@pytest.mark.parametrize("n", [256, 8192])
def test_conv_model_vs_xla_df32(n):
    """The model's frames-mode convolution, rounded to float32, against the
    reference package's XLA df32 convolution (``df_ols_convolve``): both
    are the float64 convolution rounded once, within 2^-23 of max |y|;
    and against df_fft_conv's plain version, within one float32 rounding
    (2^-24 of max |y|)."""
    rng = np.random.default_rng(n + 3)
    k = rng.standard_normal(min(1417, n // 2))
    H = np.fft.fft(k, n) / n
    frames = rng.uniform(-1, 1, (2, 4, n)).astype(np.float32)
    plan = DfFFTPlan(n, H)
    f = torch.from_numpy(frames).double()
    w = conv_model(f[:, 0::2] + 1j * f[:, 1::2], plan)
    y = torch.stack([w.real, w.imag], dim=2).reshape(2, 4, n).float()
    r = np.asarray(ref_dfft.df_ols_convolve(
        jnp.asarray(frames), np.ascontiguousarray(H.real),
        np.ascontiguousarray(H.imag), ref_dfft.DfFFT(n)), np.float64)
    assert _max_rel(y.double(), torch.from_numpy(r)) <= 2.0**-23
    port = df_fft_conv(torch.from_numpy(frames.reshape(2, 4 * n)), plan, 4,
                       0).reshape(2, 4, n)
    assert _max_rel(y.double(), port.double()) <= 2.0**-24
