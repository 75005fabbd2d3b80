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
``ozaki`` interpolator.  ``fused=True`` fuses whatever the engines, ``fused="poly"`` also the
[conv, polynomial-frac] pair (ops/poly_fused.py).
``oneshot(max_chunk=...)`` over more than one chunk runs through the
push-mode stream (models/stream.py); ``functional.resample_fn`` is the
differentiable transform over the same chain.  Nothing falls back to
another path.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.fused import fuse_stage_list
from ..ops.stages import build_exec, df_collapse_input
from ..utils.trace import count, exec_span, spanned, trace_plan
from .lengths import chain_in_for_out, chain_max_out_len, chain_out_len
from .plan import Plan, make_plan

__all__ = ["Resampler", "Resampler16", "Resampler16IR", "Resampler24",
           "run_chain"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and CUDA is
    not available (the port never carries on quietly on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for the "
                           "plain PyTorch path")
    return device


def to_device(x: torch.Tensor, device: torch.device, dtype) -> torch.Tensor:
    """x on ``device`` in ``dtype``; a host tensor's upload to a card is
    counted in ``h2d_bytes``."""
    if x.device.type == "cpu" and device.type == "cuda":
        count("h2d_bytes", x.numel() * dtype.itemsize)
    return x.to(device=device, dtype=dtype)


def run_chain(execs, x: torch.Tensor, df_carry: bool = False, x_lo=None,
              emit_pair: bool = False):
    """The stage chain ``execs`` on x [C, N] (already zero-flushed), the
    body of ``Resampler.forward`` and of each streamed block.  Stages with
    a seam protocol hand their raw (unsliced) framing buffer and a
    logical length to the next stage, so no seam slices and re-pads.

    df_carry: the guarantee chain's df32 carry.  Stages then thread raw
    (hi float32, lo bfloat16) pair buffers plus the logical count; the
    first stage only emits (there is no residual to consume), the last
    only consumes, so the chain ends with one float32 output.  Every
    executor build_exec returns has a carry path; before one without
    (the fused executors of ``fused=True``) the pair collapses, the
    seam's rounding without the carry.  A streamed piece of a
    chain carries the pair across its own ends: x_lo is the residual
    stream entering the first stage, and emit_pair=True returns the last
    stage's (hi, lo) pair (lo None where the stage collapses).

    Each executor call runs inside its ``r8b.exec.<class>`` span
    (utils/trace.py)."""
    n = x.shape[1]
    if df_carry:
        h, l = x, x_lo
        for i, e in enumerate(execs):
            with exec_span(e):
                if hasattr(e, "apply_df"):
                    h, l, n = e.apply_df(
                        h, l, n, emit_pair=emit_pair or i < len(execs) - 1)
                else:  # no carry path (the fused executors): one rounding
                    h, l = e(df_collapse_input(h, l, n)), None
                    n = h.shape[1]
        h = h if h.shape[1] == n else h[:, :n]
        if not emit_pair:
            return h
        return h, (l if l is None or l.shape[1] == n else l[:, :n])
    for e in execs:
        with exec_span(e):
            if hasattr(e, "apply_v"):
                x, n = e.apply_v(x, n)
            else:
                if x.shape[1] != n:
                    x = x[:, :n]
                x = e(x)
                n = x.shape[1]
    return x if x.shape[1] == n else x[:, :n]


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
        engines are "auto", and runs the other stages one by one; True
        (any truthy value) does the same whatever the engines, building
        the other stages with them (the fused pair always runs
        frac_whole; the cascade needs a matmul conv engine); "poly" also
        fuses each [conv, polynomial-frac] pair into one drifting operator
        in float32 on the matmul engines (ops/poly_fused.py; opt-in, as
        in the reference); False runs every stage one by one.

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
        if plan is not None and not isinstance(plan, Plan):
            raise TypeError("plan must be an r8brain_torch Plan; convert a "
                            "reference plan with convert.plan_from_reference")
        self.device = resolve_device(device)
        self.plan = plan if plan is not None else make_plan(
            src_rate, dst_rate, trans_band, atten, phase)
        self.dtype = dtype
        self.precision = precision
        self.conv_engine = conv_engine
        self.frac_engine = frac_engine
        trace_plan(self.plan, context=f"resampler dtype={dtype} "
                                      f"precision={precision}")
        build = functools.partial(build_exec, conv_engine=conv_engine,
                                  frac_engine=frac_engine)
        fuse_poly = fused == "poly"
        if fused == "auto":
            fused = conv_engine == "auto" and frac_engine == "auto"
        execs = fuse_stage_list(self.plan, dtype, precision, build,
                                engine=conv_engine,
                                poly=fuse_poly) if fused else None
        if execs is None:
            execs = [build(s, dtype, precision) for s in self.plan.stages]
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
        calls.  The stream state that CDSPResampler::clear resets lives in
        a ``StreamResampler`` (models/stream.py), which has its own
        ``clear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stage chain on x [C, N] (already zero-flushed): ``run_chain``
        with the df32 carry when the guarantee chain has it on."""
        return run_chain(self.execs, x, self.df_carry)

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
    @spanned("r8b.oneshot")
    def oneshot(self, x, out_len: Optional[int] = None,
                max_chunk: Optional[int] = None) -> torch.Tensor:
        """Offline conversion with zero-flush.  x: [C, N] or [N], a tensor
        or an array; the result is a tensor on the resampler's device.

        max_chunk bounds device memory for long signals: inputs longer
        than ``max_chunk`` samples are pushed through the streaming path
        (``StreamResampler``, the same outputs as the whole-array chain
        to its rounding) in ``max_chunk``-sample pieces, each moved to the
        device when it is pushed, and the outputs are written into the
        result as they come, so the working set beside the input and the
        result is O(channels x max_chunk).  Default None runs the whole
        array at once (fastest)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None, :]
        C, N = x.shape
        if out_len is None:
            out_len = self.default_out_len(N)
        if not self.plan.stages:  # src == dst passthrough
            y = to_device(x, self.device, self.dtype)[:, :out_len]
            if out_len > N:
                y = torch.nn.functional.pad(y, (0, out_len - N))
            return y[0] if squeeze else y
        if max_chunk is not None and max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
        if max_chunk is not None and N > max_chunk:
            y = self._oneshot_chunked(x, out_len, int(max_chunk))
            return y[0] if squeeze else y
        x = to_device(x, self.device, self.dtype)
        T = max(N, self.in_len_for_out(out_len))
        if T > N:
            x = torch.nn.functional.pad(x, (0, T - N))
        y = self(x)[:, :out_len]
        return y[0] if squeeze else y

    def _oneshot_chunked(self, x: torch.Tensor, out_len: int,
                         max_chunk: int) -> torch.Tensor:
        from .stream import StreamResampler

        st = StreamResampler(self, block_len=max_chunk)
        y = torch.empty((x.shape[0], out_len), dtype=self.dtype,
                        device=self.device)
        pos = 0
        for i in range(0, x.shape[1] + max_chunk, max_chunk):
            o = st.process(x[:, i : i + max_chunk]) if i < x.shape[1] \
                else st.flush(out_len)
            take = min(o.shape[1], out_len - pos)
            y[:, pos : pos + take] = o[:, :take]
            pos += take
        assert pos == out_len, (pos, out_len)
        return y


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
