"""Carry a reference-package plan across to the port.

The "weights" of this system are the designed filters of a plan.
``plan_from_reference`` reads a plan built by the reference JAX package
(``r8brain_tpu.make_plan``) by attribute only -- it imports nothing of that
package -- and copies every stage integer and every tap array into this
package's dataclasses, so ``Resampler(..., plan=plan_from_reference(p))``
computes with exactly the reference's filters.

``stream_state_from_reference`` carries a reference ``StreamResampler``
checkpoint (``get_state()``, a dict of numpy arrays and integers) into the
layout of this package's ``StreamResampler.set_state``, after checking
that the two streams cut the signal into the same blocks;
``sharded_stream_state_from_reference`` does the same for a reference
``ShardedStreamResampler`` checkpoint and the port's sharded stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .design.fracbank import FracBank
from .design.halfband import HBFilter
from .design.lpfilter import LPFilter
from .models.plan import ConvStage, FracStage, HBDownStage, HBUpStage, Plan

__all__ = ["plan_from_reference", "stream_state_from_reference",
           "sharded_stream_state_from_reference"]

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


def _width(a) -> Optional[int]:
    return None if a is None else int(np.asarray(a).shape[1])


def stream_state_from_reference(state: dict, stream, reference=None) -> dict:
    """This package's checkpoint of ``stream`` (an r8brain_torch
    StreamResampler) from the reference-package stream state ``state``.

    The two streams must share their block geometry: the block, each
    period stream's L and H and the interpolator's history H.  With
    ``reference`` (the reference StreamResampler, read by attribute only)
    those are compared directly; in any case each carried array must have
    the width of this stream's history and each input count must be a
    whole number of its blocks.  Raises ValueError otherwise.  The
    reference's suffix pending samples and its device re-blocker's fill
    become this stream's suffix pending samples (in that order)."""
    geo = stream.geometry()
    if reference is not None:
        ref = {"block": reference.block}
        for key, attr in (("core", "_core"), ("suf", "_suf")):
            ps = getattr(reference, attr, None)
            if ps is not None:
                ref[f"{key}_L"], ref[f"{key}_H"] = ps.L, ps.H
        tail = getattr(reference, "_tail", None)
        if tail is not None:
            ref["tail_H"] = tail.H
        if ref != geo:
            raise ValueError(f"reference stream geometry {ref} is not this "
                             f"stream's {geo}")
    bad = []
    pend = _width(state["pending"])
    if pend is not None and pend >= geo["block"]:
        bad.append(f"pending {pend} >= block {geo['block']}")
    for key in ("core", "suf"):
        sub = state.get(key)
        if (sub is None) != (f"{key}_L" not in geo):
            bad.append(f"{key} state {'missing' if sub is None else 'extra'}")
            continue
        if sub is None:
            continue
        w = _width(sub["hist"])
        if w is not None and w != geo[f"{key}_H"]:
            bad.append(f"{key} history {w} != H {geo[f'{key}_H']}")
        if sub["n_in"] % geo[f"{key}_L"]:
            bad.append(f"{key} n_in {sub['n_in']} not whole blocks of "
                       f"{geo[f'{key}_L']}")
    tail = state.get("tail")
    if (tail is None) != ("tail_H" not in geo):
        bad.append("tail state missing or extra")
    elif tail is not None and _width(tail["buf"]) not in (None,
                                                          geo["tail_H"]):
        bad.append(f"tail history {_width(tail['buf'])} != H "
                   f"{geo['tail_H']}")
    if bad:
        raise ValueError("reference state does not fit this stream: "
                         + "; ".join(bad))

    def arr(a):
        return None if a is None else np.array(a, copy=True)

    st = {"geometry": geo, "n_in_total": int(state["n_in_total"]),
          "n_out_total": int(state["n_out_total"]),
          "pending": arr(state["pending"]), "channels": state["channels"],
          "squeeze": bool(state["squeeze"])}
    if "core" in state:
        st["core"] = {"hist": arr(state["core"]["hist"]),
                      "n_in": int(state["core"]["n_in"])}
    if tail is not None:
        st["tail"] = {k: int(tail[k]) for k in ("n_in", "m_out",
                                                 "skip_left")}
        st["tail"]["buf"] = arr(tail["buf"])
    if "suf" in state:
        sf = state["suf"]
        parts = [np.asarray(a) for a in (sf["pending"], sf.get("dev_buf"))
                 if a is not None and np.asarray(a).shape[1]]
        st["suf"] = {"hist": arr(sf["hist"]), "n_in": int(sf["n_in"]),
                     "pending": np.concatenate(parts, axis=1)
                     if parts else None}
    return st


def sharded_stream_state_from_reference(state: dict, stream) -> dict:
    """The checkpoint of ``stream`` (an r8brain_torch ShardedStreamResampler
    on an in-process mesh) from the reference ShardedStreamResampler state
    ``state`` (numpy ``carry`` [C_pad, H] and ``pending``, counters, and
    ``call`` for polynomial plans).  The carry must have this stream's
    history H and one row for each padded channel, the input count must
    be whole blocks and the pending samples less than a block; raises
    ValueError otherwise."""
    if stream.mesh.distributed:
        raise ValueError("a reference checkpoint holds every shard's carry; "
                         "resume it on an in-process mesh")
    geo = stream.geometry()
    bad = []
    n_in = int(state["n_in"])
    if n_in % geo["block"]:
        bad.append(f"n_in {n_in} not whole blocks of {geo['block']}")
    call = int(state.get("call", n_in // geo["block"]))
    if call != n_in // geo["block"]:
        bad.append(f"call {call} != n_in / block {n_in // geo['block']}")
    carry = state["carry"]
    if (carry is None) != (call == 0):
        bad.append("carry missing after a call" if carry is None
                   else "carry before the first call")
    channels = state["channels"]
    if carry is not None:
        rows = -(-int(channels) // geo["n_ch"]) * geo["n_ch"]
        if np.asarray(carry).shape != (rows, geo["H"]):
            bad.append(f"carry {np.asarray(carry).shape} != ({rows}, "
                       f"{geo['H']})")
    pend = _width(state["pending"])
    if pend is not None and pend >= geo["block"]:
        bad.append(f"pending {pend} >= block {geo['block']}")
    if bad:
        raise ValueError("reference state does not fit this stream: "
                         + "; ".join(bad))
    return {"geometry": geo,
            "carry": None if carry is None else np.array(carry, copy=True),
            "n_in": n_in, "n_out": int(state["n_out"]), "call": call,
            "channels": channels,
            "pending": None if state["pending"] is None
            else np.array(state["pending"], copy=True)}
