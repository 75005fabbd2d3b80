"""Carry a reference-package plan across to the port.

The "weights" of this system are the designed filters of a plan.
``plan_from_reference`` reads a plan built by the reference JAX package
(``r8brain_tpu.make_plan``) by attribute only -- it imports nothing of that
package -- and copies every stage integer and every tap array into this
package's dataclasses, so ``Resampler(..., plan=plan_from_reference(p))``
computes with exactly the reference's filters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .design.fracbank import FracBank
from .design.halfband import HBFilter
from .design.lpfilter import LPFilter
from .models.plan import ConvStage, FracStage, HBDownStage, HBUpStage, Plan

__all__ = ["plan_from_reference"]

_STAGES = {"conv": ConvStage, "hb_up": HBUpStage, "hb_down": HBDownStage,
           "frac": FracStage}
# dataclass-valued fields of the stage specs
_NESTED = {"filt": LPFilter, "hb": HBFilter, "bank": FracBank}


def _copy(obj, cls):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if v is not None and f.name in _NESTED:
            v = _copy(v, _NESTED[f.name])
        elif isinstance(v, np.ndarray):
            v = np.array(v, copy=True)
        kw[f.name] = v
    return cls(**kw)


def plan_from_reference(plan) -> Plan:
    """This package's Plan with the same stages, integers and taps as the
    reference-package ``plan`` (any object with the same attributes)."""
    stages = tuple(_copy(s, _STAGES[s.kind]) for s in plan.stages)
    return Plan(plan.src_rate, plan.dst_rate, plan.trans_band, plan.atten,
                plan.phase, stages, plan.latency_frac)
