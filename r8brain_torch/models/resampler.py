"""Batched resampler front-end on PyTorch.

Counterpart of the CDSPResampler public API (CDSPResampler.h:406-651) and
of the reference package's ``models/resampler.py``: plans the stage chain
on the host (models/plan.py), builds the device executors (ops/fused.py),
and exposes an offline ``oneshot`` over a [channels, samples] batch.

The zero-flush semantics of the reference's oneshot (CDSPResampler.h:
592-651) are reproduced by right-padding the input with the exact number
of zeros whose outputs cover ``out_len`` (models/lengths.py inverse
emission algebra).

Ported: every plan the planner makes.  With the default engines each
[conv(up), whole-frac] pair of the plan runs fused (e.g. 44.1k -> 96k,
44.1k -> 48k) and each run of two or more float32 half-band upsamplers
runs as one cascade (e.g. 44.1k -> 2.8224M), the other stages one by one:
lone conv stages, half-band stages, polynomial interpolators (e.g.
44.1k -> 96001).  ``fused=False`` or any other engine runs the stages one
by one: the float32 matmul conv engines (``"toeplitz"``, the unfused
float32 default, ``"toeplitz_sym"``, ``"pallas"``, ``"direct"``), the
ozaki chain (``conv_engine="ozaki"`` + ``frac_engine="ozaki"``: conv,
half-band and interpolator stages in the split form, with the df32
inter-stage carry under ``precision="high"``) and the df32-FFT conv
engines (``"fft"``, ``"pallas_fft"``, ``"pallas_fft4"``,
``"pallas_fft5"``), before the ``im2col``, ``pallas``, ``conv`` or
``ozaki`` interpolator.  ``fused="poly"`` and streaming
(``oneshot(max_chunk=...)`` beyond one chunk) raise NotImplementedError
naming the ROADMAP.md item that ports them; nothing falls back to another
path.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.fused import fuse_stage_list
from ..ops.stages import build_exec
from ..utils.trace import trace_plan
from .lengths import chain_in_for_out, chain_max_out_len, chain_out_len
from .plan import Plan, make_plan

__all__ = ["Resampler", "Resampler16", "Resampler16IR", "Resampler24"]

def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and CUDA is
    not available (the port never carries on quietly on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for the "
                           "plain PyTorch path")
    return device


class Resampler(nn.Module):
    def __init__(self, src_rate: float, dst_rate: float,
                 trans_band: float = 2.0, atten: float = 206.91,
                 phase: int = 0, dtype=torch.float32,
                 plan: Optional[Plan] = None, precision: str = "fast",
                 fused="auto", conv_engine: str = "auto",
                 frac_engine: str = "auto", device="cuda"):
        """precision: "fast" runs everything in ``dtype``; "high" (float32
        only) adds the kernel-representation residual dot to the fused
        contraction so the output meets the reference's -141 dB
        golden-equality class by design.

        plan: a plan of this package (``make_plan``), or one converted from
        the reference package with ``convert.plan_from_reference``.

        fused: "auto" composes each [conv(up), whole-frac] pair of the
        plan into one operator (ops/fused.py) and, in float32, each run of
        two or more half-band upsamplers (ops/hb_cascade.py), when both
        engines are "auto", and runs the other stages one by one; False
        runs every stage one by one.

        conv_engine: "auto" (fused; unfused, "toeplitz" in float32 and
        "fft" in float64); the float32 matmul engines "toeplitz" (the
        banded operator on frac_whole), "toeplitz_sym" (the folded
        operators on sym_conv, half the products; a kernel that is not
        symmetric falls back to "toeplitz" under the
        conv_toeplitz_sym_fallback trace), "pallas" (the B=64
        mini-Toeplitz on frac_whole; no fallback) and "direct" (the
        superkernel's strided product on frac_whole); "ozaki", the
        error-free split-operand guarantee engine (ops/ozaki.py); or the
        df32-FFT guarantee engines "pallas_fft5", "pallas_fft4",
        "pallas_fft" and "fft" (the FP64 overlap-save kernel of
        ops/pallas_dfft.py, in the reference's geometry for each name;
        "fft" under precision="high" only, else torch.fft).  The stage
        executors (ops/stages.py) accept or reject an engine.

        frac_engine: "auto" (the reference's rule: "im2col" in float32
        when the windows barely overlap, else "conv"); "im2col",
        "pallas" and "conv" (one frac_whole call, ops/pallas_frac.py); or
        "ozaki".  A polynomial-mode stage takes "banded" (float32's
        "auto") or "gather" (float64's), and under "ozaki" the banded
        engine's split products at precision "high".  With
        conv_engine="ozaki", precision="high" and float32 the stages hand
        (hi, lo) pairs across their seams (the df32 carry: only the final
        output rounds) unless the environment sets R8BT_DF_CARRY=0.

        device: where the operators live and the contraction runs; "cuda"
        (the default) raises RuntimeError when CUDA is not available."""
        super().__init__()
        if fused not in ("auto", False):
            raise NotImplementedError(
                f"fused={fused!r} is not ported yet (ROADMAP.md queue 1 "
                f"item 11, fused='poly'); 'auto' and False run")
        if plan is not None and not isinstance(plan, Plan):
            raise TypeError("plan must be an r8brain_torch Plan; convert a "
                            "reference plan with convert.plan_from_reference")
        self.device = resolve_device(device)
        self.plan = plan if plan is not None else make_plan(
            src_rate, dst_rate, trans_band, atten, phase)
        self.dtype = dtype
        self.precision = precision
        trace_plan(self.plan, context=f"resampler dtype={dtype} "
                                      f"precision={precision}")
        execs = None
        if fused == "auto" and conv_engine == "auto" \
                and frac_engine == "auto":
            execs = fuse_stage_list(self.plan, dtype, precision)
        if execs is None:
            execs = [build_exec(s, dtype, precision, conv_engine, frac_engine)
                     for s in self.plan.stages]
        self.execs = nn.ModuleList(execs)
        self.df_carry = (precision == "high" and conv_engine == "ozaki"
                         and dtype == torch.float32
                         and os.environ.get("R8BT_DF_CARRY", "1") != "0")
        self.to(self.device)

    @property
    def latency_frac(self) -> float:
        return self.plan.latency_frac

    @property
    def latency(self) -> int:
        """Always 0: like the reference front-end (CDSPResampler.h:430-436),
        whole-sample latency is consumed inside the chain; only the
        fractional remainder (latency_frac) is reported."""
        return 0

    def clear(self) -> None:
        """No-op: the whole-array executor is stateless between oneshot
        calls (CDSPResampler::clear resets stream buffers; streaming is
        ROADMAP.md queue 1 item 6)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stage chain on x [C, N] (already zero-flushed).  Stages with
        a seam protocol hand their raw (unsliced) framing buffer and a
        logical length to the next stage, so no seam slices and re-pads."""
        if self.df_carry:
            return self._chain_df(x)
        n = x.shape[1]
        for e in self.execs:
            if hasattr(e, "apply_v"):
                x, n = e.apply_v(x, n)
            else:
                if x.shape[1] != n:
                    x = x[:, :n]
                x = e(x)
                n = x.shape[1]
        return x if x.shape[1] == n else x[:, :n]

    def _chain_df(self, x: torch.Tensor) -> torch.Tensor:
        """The guarantee chain's df32 carry: stages thread raw (hi float32,
        lo bfloat16) pair buffers plus the logical count.  The first stage
        only emits (there is no residual to consume), the last only
        consumes, so the chain ends with one float32 output.  Every
        executor build_exec returns has a carry path."""
        h, l, n = x, None, x.shape[1]
        for i, e in enumerate(self.execs):
            h, l, n = e.apply_df(h, l, n, emit_pair=i < len(self.execs) - 1)
        return h if h.shape[1] == n else h[:, :n]

    def out_len_for_in(self, n_in: int) -> int:
        return chain_out_len(self.plan.stages, n_in)

    def in_len_for_out(self, out_len: int) -> int:
        return chain_in_for_out(self.plan.stages, out_len)

    def default_out_len(self, n_in: int) -> int:
        return int(math.floor(n_in * self.plan.dst_rate / self.plan.src_rate))

    def max_out_len(self, max_in: int) -> int:
        """Upper bound on outputs a ``max_in``-sample block can produce at
        ANY stream position -- the reference's buffer-sizing query
        (getMaxOutLen, CDSPResampler.h:497-506).  Unlike out_len_for_in
        (exact count from stream start) this ignores start latency."""
        return chain_max_out_len(self.plan.stages, max_in)

    def get_input_required_for_output(self, req_out: int) -> int:
        """Minimal input count yielding >= req_out outputs
        (getInputRequiredForOutput, CDSPResampler.h:476-484)."""
        return chain_in_for_out(self.plan.stages, req_out) if req_out > 0 \
            else 0

    def get_in_len_before_out_pos(self, req_out_pos: int) -> int:
        """Input samples required to advance past output position
        ``req_out_pos`` (CDSPResampler.h:406-419)."""
        return self.get_input_required_for_output(req_out_pos + 1) - 1

    @torch.no_grad()
    def oneshot(self, x, out_len: Optional[int] = None,
                max_chunk: Optional[int] = None) -> torch.Tensor:
        """Offline conversion with zero-flush.  x: [C, N] or [N], a tensor
        or an array; the result is a tensor on the resampler's device.

        max_chunk: inputs longer than ``max_chunk`` samples need the
        streaming path, which is not ported yet (NotImplementedError)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.to(device=self.device, dtype=self.dtype)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None, :]
        C, N = x.shape
        if out_len is None:
            out_len = self.default_out_len(N)
        if not self.plan.stages:  # src == dst passthrough
            y = x[:, :out_len]
            if out_len > N:
                y = torch.nn.functional.pad(y, (0, out_len - N))
            return y[0] if squeeze else y
        if max_chunk is not None and max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
        if max_chunk is not None and N > max_chunk:
            raise NotImplementedError(
                "oneshot(max_chunk=...) over more than one chunk needs "
                "streaming, ROADMAP.md queue 1 item 6")
        T = max(N, self.in_len_for_out(out_len))
        if T > N:
            x = torch.nn.functional.pad(x, (0, T - N))
        y = self(x)[:, :out_len]
        return y[0] if squeeze else y


class Resampler16(Resampler):
    """16-bit precision preset, ReqAtten 136.45 dB (CDSPResampler.h:743-748)."""

    def __init__(self, src_rate, dst_rate, trans_band=2.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__(src_rate, dst_rate, trans_band, 136.45, 0, dtype,
                         device=device)


class Resampler16IR(Resampler):
    """16-bit impulse-response preset, ReqAtten 109.56 dB
    (CDSPResampler.h:774-779)."""

    def __init__(self, src_rate, dst_rate, trans_band=2.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__(src_rate, dst_rate, trans_band, 109.56, 0, dtype,
                         device=device)


class Resampler24(Resampler):
    """24-bit precision preset, ReqAtten 180.15 dB (CDSPResampler.h:804-809)."""

    def __init__(self, src_rate, dst_rate, trans_band=2.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__(src_rate, dst_rate, trans_band, 180.15, 0, dtype,
                         device=device)
