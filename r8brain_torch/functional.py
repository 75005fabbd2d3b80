"""The resampler as a linear, differentiable function of its input.

Counterpart of the reference package's ``functional.py``.  The stage
chain is a pure function of the input block (``run_chain``), so
``resample_fn`` exposes it as a closure that composes with a user's own
PyTorch program: ``torch.func.vmap`` over leading axes,
``torch.func.grad`` / ``vjp`` / ``jvp``, and plain ``loss.backward()``.
The chain is linear, so its gradient is its transpose, exact to the
chain's rounding: data augmentation and differentiable-DSP pipelines can
put sample-rate conversion in the middle.

How each chain differentiates:

* Every kernel of the default engines has a gradient: ``frac_whole``'s
  backward is ``frac_whole`` itself on the adjoint geometry
  (ops/pallas_frac.py), so the fused pair, the toeplitz conv stage, the
  whole-frac stage, the half-band matmul engines and the cascade
  differentiate on the card through torch autograd, and the polynomial
  stage's products and the float64 engines are torch operations.
* ``ozaki_framed``, ``sym_conv`` and ``df_fft_conv`` have none (engines
  "ozaki", "toeplitz_sym", "pallas_fft*", and "fft" under "high").  A
  chain on one of them runs forward as chosen and differentiates through
  a twin built on first use: the same plan, dtype and precision class on
  the default engines, the same linear map within the class.  One
  ``torch.autograd.Function`` is the counterpart of the reference's
  ``jax.custom_vjp``: its backward is the twin's vjp, its jvp the chain
  on the tangent, and its vmap rule folds leading batch dimensions into
  channels, so the executors never see a batched tensor.

Example::

    import torch
    from r8brain_torch import Resampler24, resample_fn

    rs = Resampler24(44100, 96000)
    f = resample_fn(rs, n_in=44100)          # [C, 44100] -> [C, 96000]
    yb = torch.func.vmap(f)(batch)           # [B, C, 44100] -> [B, C, 96000]
    g = torch.func.grad(lambda x: (w * f(x)).sum())(x)
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .models.resampler import Resampler, run_chain

__all__ = ["resample_fn"]


def _core(execs, df_carry: bool, n_in: int, T: int,
          out_len: int) -> Callable:
    """[C, n_in] -> [C, out_len]: zero-flush pad, the stage chain, slice
    (``Resampler.oneshot``'s steps)."""

    def run(x):
        if T > n_in:
            x = F.pad(x, (0, T - n_in))
        return run_chain(execs, x, df_carry)[:, :out_len]

    return run


def _needs_twin(execs) -> bool:
    """True when an executor runs a kernel without a gradient:
    ``ozaki_framed`` (engine "ozaki", the split products), ``sym_conv``
    ("toeplitz_sym") or ``df_fft_conv`` (the FFT engines' plan).  Those
    three raise when handed a tensor that autograd or torch.func tracks
    (``ops/_cuda.no_gradient``), so a chain that reaches one some other
    way fails loudly instead of dropping part of its gradient."""
    return any(getattr(e, "engine", None) in ("ozaki", "toeplitz_sym")
               or getattr(e, "oz_products", False)
               or getattr(e, "dfft_plan", None) is not None
               for e in execs)


class _TwinChain(torch.autograd.Function):
    """A chain whose kernels have no gradient: forward the chain, backward
    the vjp of its default-engine twin (linear, so taken at zero)."""

    @staticmethod
    def forward(x, run, twin):
        return run(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, run, twin = inputs
        ctx.run, ctx.twin, ctx.in_shape = run, twin, tuple(x.shape)

    @staticmethod
    def backward(ctx, gy):
        x0 = gy.new_zeros(ctx.in_shape)
        return torch.func.vjp(ctx.twin(), x0)[1](gy)[0], None, None

    @staticmethod
    def jvp(ctx, gx, *_rest):
        return None if gx is None else ctx.run(gx)

    @staticmethod
    def vmap(info, in_dims, x, run, twin):
        if in_dims[0] is None:
            return _TwinChain.apply(x, run, twin), None
        xb = x.movedim(in_dims[0], 0)
        B, C = xb.shape[0], xb.shape[1]
        y = _TwinChain.apply(xb.reshape(B * C, xb.shape[2]), run, twin)
        return y.reshape(B, C, y.shape[1]), 0


def resample_fn(rs: Resampler, n_in: int,
                out_len: Optional[int] = None) -> Callable:
    """A function ``f(x) -> y`` for a fixed input length.

    ``x``: [channels, n_in] (or [n_in]), a tensor or an array, moved to the
    resampler's device and dtype; ``y``: [channels, out_len] with
    ``Resampler.oneshot``'s zero-flush semantics (the input right-padded
    with the zeros whose outputs cover ``out_len``; CDSPResampler.h:
    592-651), bit-equal to ``rs.oneshot(x, out_len)``.

    Lengths are resolved on the host now, so the function has no
    data-dependent shapes; it composes with ``torch.func.vmap`` (leading
    axes), ``grad``, ``vjp``, ``jvp`` and ``loss.backward()``, and can be
    called inside a user's own function.  Chains on kernels without a
    gradient differentiate through a twin (see the module docstring)."""
    n_in = int(n_in)
    if n_in < 1:
        raise ValueError(f"n_in must be >= 1, got {n_in}")
    out_len = (int(math.floor(n_in * rs.plan.dst_rate / rs.plan.src_rate))
               if out_len is None else int(out_len))
    if out_len < 0:
        raise ValueError(f"out_len must be >= 0, got {out_len}")
    passthrough = not rs.plan.stages
    T = n_in if passthrough else max(n_in, rs.in_len_for_out(out_len))
    core = None
    if not passthrough:
        core = _core(rs.execs, rs.df_carry, n_in, T, out_len)
        if _needs_twin(rs.execs):
            fwd, twin = core, []

            def twin_core():
                if not twin:
                    t_rs = Resampler(rs.plan.src_rate, rs.plan.dst_rate,
                                     plan=rs.plan, dtype=rs.dtype,
                                     precision=rs.precision,
                                     device=rs.device)
                    twin.append(_core(t_rs.execs, False, n_in, T, out_len))
                return twin[0]

            def core(x):
                return _TwinChain.apply(x, fwd, twin_core)

    def f(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.to(device=rs.device, dtype=rs.dtype)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None, :]
        if x.shape[-1] != n_in:
            raise ValueError(
                f"resample_fn built for n_in={n_in}, got input with "
                f"{x.shape[-1]} samples (build a new function per length)")
        if passthrough:
            y = x[:, :out_len]
            if out_len > n_in:
                y = F.pad(y, (0, out_len - n_in))
        else:
            y = core(x)
        return y[0] if squeeze else y

    return f
