"""Structured stage-plan tracing (R8BCONSOLE equivalent).

The reference compiles printf-style tracing in via the R8BCONSOLE macro
(r8bconf.h:31-42) and logs every design decision: resampler plan
(CDSPResampler.h:131-133,717), filter design results (CDSPFIRFilter.h:534),
convolver geometry (CDSPBlockConvolver.h:181-184), interpolator mode
(CDSPFracInterpolator.h:784-788).  Here tracing is runtime-gated by the
``R8B_TRACE`` env var (any non-empty value; "json" for machine-readable
lines) and routed through the standard logging module.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

_logger = logging.getLogger("r8brain_torch")
_mode = os.environ.get("R8B_TRACE", "")
if _mode and not _logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("r8b: %(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)

__all__ = ["enabled", "trace", "trace_plan"]


def enabled() -> bool:
    return bool(_mode)


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
