"""Tracing: the plan log under ``R8B_TRACE``, and spans and counters that
a running ``torch.profiler`` records.

The plan log is the R8BCONSOLE equivalent.  The reference compiles
printf-style tracing in via the R8BCONSOLE macro (r8bconf.h:31-42) and
logs every design decision: resampler plan (CDSPResampler.h:131-133,717),
filter design results (CDSPFIRFilter.h:534), convolver geometry
(CDSPBlockConvolver.h:181-184), interpolator mode
(CDSPFracInterpolator.h:784-788).  Here it is runtime-gated by the
``R8B_TRACE`` env var (any non-empty value; "json" for machine-readable
lines) and routed through the standard logging module.

Spans and counters record exactly while a ``torch.profiler`` session
records, and at no other time: there is no switch of their own.
``span(name)`` is then ``torch.profiler.record_function(name)``, on the
profiler's clock beside the device's operations, and otherwise one shared
no-op context; ``count(name, n)`` adds to a tally that ``counters()``
copies and ``reset_counters()`` clears.  Neither reads a device value,
synchronises or allocates.  The names the package records:

* spans ``r8b.oneshot`` (``Resampler.oneshot``), ``r8b.stream.block``
  (each block a stream runs), ``r8b.stream.window`` (a period stream's
  window copies), ``r8b.stream.poly`` (the streamed polynomial stage),
  inside it ``r8b.poly.positions`` (host read positions and geometry) and
  ``r8b.poly.operators`` (their upload and the operators' build),
  ``r8b.stream.suffix`` (the suffix ring after the polynomial stage),
  ``r8b.exec.<class>`` (each executor call of ``run_chain``),
  ``r8b.kernel.<name>`` (the CUDA kernels' wrappers, ``poly_dot`` among
  them), ``r8b.frame`` (the framing copy before a ``frac_whole`` call of
  a ``FramedOperator`` that does not read its input in place: on the CPU,
  and where the input needs a cast), ``r8b.hb.edge`` (the half-band up
  cascade's float64 edge correction, ``ops/hb_cascade.py``), and in the
  guarantee chain
  ``r8b.ozaki.prep`` (an ozaki executor's framing copies and per-channel
  scales before each ``ozaki_framed`` call) and
  ``r8b.ozaki.carry`` (the df32 carry's torch work: the framing copy of
  the seam residual that ``ozaki_framed`` takes as ``x_lo``, and every
  collapse of a seam's pair before a stage without a carry path);
* counters ``h2d_bytes`` (bytes copied from the host to a card: inputs
  given as host arrays and the polynomial stage's positions),
  ``poly_cache.hit`` and ``poly_cache.miss`` (a polynomial stage's state
  for one input length found in its cache, or built on the host and
  uploaded), ``frac_whole.folds`` and ``frac_whole.folds_full`` (the
  folds ``frac_whole`` walks, and those of all of D),
  ``ozaki_framed.macs`` (the multiply-adds of each ``ozaki_framed``
  call), ``poly.kernel`` and ``poly.banded`` (one a polynomial
  stage's banded-engine call, by the path its contraction took:
  ``poly_dot``, or the banded operators), ``frame.bytes`` (the bytes
  each ``r8b.frame`` span's copy writes, 0 where the framing is a view),
  ``frame.direct`` (one a ``FramedOperator`` call whose ``frac_whole``
  reads the input where it lies, from the window origin, with no copy)
  and ``hb_cascade.out_bytes`` (the bytes the half-band up cascade's
  ``frac_whole`` call writes, the columns it trims included).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
from collections import Counter
from typing import Any, Dict

import torch

_logger = logging.getLogger("r8brain_torch")
_mode = os.environ.get("R8B_TRACE", "")
if _mode and not _logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("r8b: %(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)

__all__ = ["count", "counters", "exec_span", "reset_counters", "span",
           "spanned", "trace", "trace_plan"]

#: True while a torch profiler records (one C call, about 0.1 us).
_recording = torch._C._autograd._profiler_enabled
#: The one context ``span`` hands out while nothing records.
_OFF = contextlib.nullcontext()
_counts: Counter = Counter()


def span(name: str):
    """A host range named ``name`` on the profiler's timeline while a
    profiler records, else a shared no-op context."""
    return torch.profiler.record_function(name) if _recording() else _OFF


def exec_span(ex):
    """``span("r8b.exec.<class of ex>")``, its name built only while a
    profiler records."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(f"r8b.exec.{type(ex).__name__}")


def spanned(name: str):
    """Decorator: the function's whole body inside ``span(name)``."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            if not _recording():
                return f(*args, **kwargs)
            with torch.profiler.record_function(name):
                return f(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _recording():
        _counts[name] += n


def counters() -> Dict[str, int]:
    """A copy of the counters' tally."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()


def trace(event: str, **fields: Any) -> None:
    if not _mode:
        return
    if _mode == "json":
        _logger.info(json.dumps({"event": event, **fields}, default=str))
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        _logger.info(f"{event} {kv}")


def trace_plan(plan, context: str = "") -> None:
    if not _mode:
        return
    if _mode == "json":
        stages = []
        for s in plan.stages:
            d: Dict[str, Any] = {"kind": s.kind}
            if s.kind == "conv":
                d.update(up=s.up, down=s.down, klen=s.filt.kernel_len,
                         offset=s.offset)
            elif s.kind in ("hb_up", "hb_down"):
                d.update(taps=s.hb.num_taps, atten=s.hb.atten)
            else:
                d.update(mode="whole" if s.is_whole else "poly",
                         taps=s.filter_len, in_step=s.in_step,
                         out_step=s.out_step)
            stages.append(d)
        trace("plan", context=context, src=plan.src_rate, dst=plan.dst_rate,
              tb=plan.trans_band, atten=plan.atten, phase=plan.phase,
              latency_frac=plan.latency_frac, stages=stages)
    else:
        _logger.info("%s%s", f"[{context}] " if context else "",
                     plan.describe())
