"""Channel x time-block sharding of a Resampler's chain over a Mesh.

Counterpart of the reference package's ``parallel/sharding.py``.  The
reference library has no distributed layer: concurrency is one resampler
object per channel (README.md:52-55).  The sharded form:

* **Channel shards** over the mesh axis ``ch``: stages are channel
  independent, so no shard talks to another.
* **Time-block shards** over ``t``: each shard computes a contiguous
  segment of the *output* from its input segment and two halos from its
  time neighbours (``Mesh.permute``): a left halo (history, the
  overlap-save / ring-buffer state of CDSPBlockConvolver.h:303-305) and a
  right halo (look-ahead, the chain's latency lead, CDSPResampler.h:
  476-484).  Shard 0's missing left halo and the last shard's missing
  right halo are zeros: the reference's zero history at the stream start
  and zero flush at its end.

Correctness rests on the shift invariance of the planned chain: shifting
the input by p_in samples shifts the output by p_out = p_in*dst/src samples
with the same filter phases.  ``chain_shift_period`` (models/lengths.py)
computes the least such
(p_in, p_out); halos and segments are rounded to it, so every shard runs
the same executor shapes on shifted data.  The fused executor
(ops/fused.py) builds one supercycle of its operator from the period, and
the push-mode stream (models/stream.py) its period-aligned blocks.

A plan with a polynomial-mode interpolator (an irrational ratio) has no
whole-chain period, but the stages around the interpolator are periodic and
its read positions are a closed form of the absolute output index
(CDSPFracInterpolator.h:907-919).  Time shards then split the chain at the
interpolator: the periodic prefix runs under the same halos; each shard's
read positions and float64 spline values are computed on the host for its
own output range; the suffix is window-aligned on its own period.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.lengths import (chain_in_for_out, chain_input_span,
                              chain_out_len, chain_shift_period,
                              frac_positions, round_up)
from ..models.plan import FracStage, Plan, subplan
from ..ops.dfloat import df_add, df_add_f, two_prod

__all__ = ["split_poly_chain", "poly_split", "shard_geometry", "poly_geometry",
           "ShardedResampler"]

#: Geometries (and the polynomial path's device data) a sharded resampler
#: keeps, by (out_len, n_in).
LAYOUT_CACHE = 4


def split_poly_chain(plan: Plan):
    """(pre_stages, frac_spec, post_stages) around the single poly-mode
    interpolator, or None when the plan has none."""
    idx = [i for i, s in enumerate(plan.stages)
           if isinstance(s, FracStage) and not s.is_whole]
    if not idx:
        return None
    assert len(idx) == 1, "plans carry at most one fractional interpolator"
    i = idx[0]
    return plan.stages[:i], plan.stages[i], plan.stages[i + 1 :]


def shard_geometry(plan: Plan, period: Optional[Tuple[int, int]],
                   span: int, n_t: int, out_len: int, n_in: int):
    """Per-shard (M_s, L_s, H, W, R) for ``n_t`` time shards: M_s outputs
    and L_s useful inputs a shard, H the left halo (input span), W the
    warm-up outputs recomputed from the halo, R the right halo."""
    if n_t == 1:
        # channel-only: one time block covering the whole input
        M_s = out_len
        L_s = max(n_in, chain_in_for_out(plan.stages, out_len))
        R = max(0, chain_in_for_out(plan.stages, out_len) - L_s)
        return M_s, L_s, 0, 0, R
    p_in, p_out = period
    M_s = round_up(round_up(out_len, n_t) // n_t, p_out)
    # cover both the output-derived input need and the whole given input
    # (outputs near out_len reach real samples past out_len * p_in/p_out;
    # cutting real input would feed the last shard zeros)
    L_s = round_up(max(M_s * p_in // p_out, -(-n_in // n_t)), p_in)
    M_s = L_s * p_out // p_in
    H = round_up(span + 64, p_in)
    W = H * p_out // p_in
    need = chain_in_for_out(plan.stages, W + M_s)
    R = max(0, need - (H + L_s))
    R = round_up(R, p_in) + p_in
    if H > L_s or R > L_s:
        # halos come from the immediate neighbour only
        grow = round_up(max(H, R), p_in)
        L_s = max(L_s, grow)
        M_s = L_s * p_out // p_in
    return M_s, L_s, H, W, R


def poly_split(plan: Plan) -> dict:
    """The split chain of a polynomial-interpolator plan: its stages
    around the interpolator, their periods and dependency spans.  Raises
    ValueError when the stages around it are not periodic."""
    pre, fs, post = split_poly_chain(plan)
    pre_p = chain_shift_period(subplan(plan, pre)) if pre else (1, 1)
    post_p = chain_shift_period(subplan(plan, post)) if post else (1, 1)
    if pre_p is None or post_p is None:
        raise ValueError("plan has non-periodic stages around the "
                         "polynomial interpolator; channel sharding only")
    return {"pre": pre, "fs": fs, "post": post,
            "pre_p": pre_p, "post_p": post_p,
            "span_pre": chain_input_span(subplan(plan, pre)) if pre else 1,
            "span_post": chain_input_span(subplan(plan, post))
            if post else 0}


def poly_geometry(plan: Plan, P_: dict, n_t: int, out_len: int,
                  n_in: int):
    """Host geometry and per-shard data of the split-chain program for
    ``n_t`` time shards (``P_`` from ``poly_split``): (geom dict, relpos
    [n_t, Fc] int64, flt [n_t, Fc, fl] float64 spline values)."""
    pre, fs, post = P_["pre"], P_["fs"], P_["post"]
    pp_in, pp_out = P_["pre_p"]
    sp_in, sp_out = P_["post_p"]
    span_pre, span_post = P_["span_pre"], P_["span_post"]
    fl = fs.filter_len
    fll = fl // 2 - 1
    in_lat = fs.in_latency

    ratio = plan.dst_rate / plan.src_rate
    Wf_in = round_up(span_post + 16, sp_in) if post else 0
    Wf_out = Wf_in * sp_out // sp_in if post else 0

    L_s = round_up(max(-(-n_in // n_t), 2 * pp_in), pp_in)
    H = round_up(span_pre + 64, pp_in)
    R = H
    settle = -(-(span_pre * pp_out) // pp_in) + 2
    for _ in range(64):
        # a shard's outputs track its own input segment (shard k's
        # reads land near k*Lmid); n_t*M_s >= out_len by construction
        M_s = round_up(max(-(-out_len // n_t),
                            int(math.ceil(L_s * ratio))), sp_out)
        if post:
            Ff = M_s * sp_in // sp_out
            Fc = chain_in_for_out(post, Wf_out + M_s) + sp_in
        else:
            Ff, Fc = M_s, M_s
        F0 = [0] + [k * Ff - Wf_in for k in range(1, n_t)]

        # absolute read positions per shard (closed form,
        # CDSPFracInterpolator.h:907-919), held at the last one a
        # shard consumes: the suffix window emits [0, Wf_out_k +
        # end_k), so positions past chain_in_for_out(post, that) feed
        # only discarded outputs and must not widen the right halo
        s_rows, t_rows = [], []
        for k in range(n_t):
            s, xf = frac_positions(fs, F0[k], Fc)
            end_k = min(out_len, (k + 1) * M_s) - k * M_s
            if post:
                need = chain_in_for_out(post, max(end_k, 0)
                                        + (Wf_out if k else 0))
            else:
                need = max(end_k, 0)
            v = int(np.clip(need, 1, Fc))
            s[v:] = s[v - 1]
            xf[v:] = xf[v - 1]
            s_rows.append(s)
            t_rows.append(xf)
        s_all = np.stack(s_rows)        # [n_t, Fc] int64
        xf_all = np.stack(t_rows)       # [n_t, Fc] float64

        W_pre = H * pp_out // pp_in
        midlen = chain_out_len(pre, H + L_s + R) if pre \
            else H + L_s + R
        Lmid = L_s * pp_out // pp_in
        # relpos[k, n] = in_lat + s - fll - origin_k; origin_0 = 0,
        # origin_k = k*Lmid - W_pre
        origin = np.array([0] + [k * Lmid - W_pre
                                 for k in range(1, n_t)])[:, None]
        relpos = in_lat + s_all - fll - origin
        if n_t > 1 and relpos[1:].min() < settle:
            d = settle - int(relpos[1:].min())
            H += round_up(-(-d * pp_in // pp_out) + pp_in, pp_in)
            if H > L_s:
                L_s = round_up(H, pp_in)
            continue
        if relpos.max() + fl > midlen:
            d = int(relpos.max()) + fl - midlen
            R += round_up(-(-d * pp_in // pp_out) + pp_in, pp_in)
            if R > L_s:
                L_s = round_up(R, pp_in)
            continue
        if H > L_s or R > L_s:
            L_s = round_up(max(H, R), pp_in)
            continue
        break
    else:
        raise RuntimeError("poly shard geometry did not converge")
    padl = max(0, -int(relpos.min()))
    relpos = relpos + padl
    geom = dict(M_s=M_s, L_s=L_s, H=H, R=R, Fc=Fc, padl=padl,
                Wf_out=Wf_out, fl=fl)
    return geom, relpos, spline_values(fs, xf_all)


def spline_values(fs: FracStage, xf: np.ndarray) -> np.ndarray:
    """[..., fl] float64 spline values c0 + (c1 + c2 t) t of the fractional
    positions xf (FracPolyExec's host evaluation)."""
    tb = np.asarray(fs.bank.table, dtype=np.float64)  # [rows, fl, 3]
    fr = xf * fs.bank.fracs
    fti = np.floor(fr).astype(np.int64)
    t = (fr - fti)[..., None]
    return tb[fti, :, 0] + (tb[fti, :, 1] + tb[fti, :, 2] * t) * t


def filter_values(flt: np.ndarray, dtype, high: bool, device):
    """Spline values on the device: in ``dtype``, or under precision
    "high" in float32 as the (hi, lo) pair of their float64 value."""
    v = torch.from_numpy(np.ascontiguousarray(flt)).to(device)
    if not high:
        return v.to(dtype)
    hi = v.float()
    return hi, (v - hi.double()).float()


def gather_dot(mid: torch.Tensor, rp: torch.Tensor, fv) -> torch.Tensor:
    """The interpolator as a gather-dot: output n sums fv[n, i] * mid[:,
    rp[n] + i] over the fl taps, in tap order; with fv an (hi, lo) pair
    (precision "high") the products are exact and summed in df32."""
    fl = (fv[0] if isinstance(fv, tuple) else fv).shape[-1]
    if isinstance(fv, tuple):
        hi, lo = fv
        acc = None
        for i in range(fl):
            xi = torch.index_select(mid, 1, rp + i)
            p = df_add_f(two_prod(xi, hi[None, :, i]), xi * lo[None, :, i])
            acc = p if acc is None else df_add(acc, p)
        return acc[0] + acc[1]
    y = None
    for i in range(fl):
        c = fv[None, :, i] * torch.index_select(mid, 1, rp + i)
        y = c if y is None else y + c
    return y


class ShardedResampler:
    """A Resampler's chain over a ("ch", "t") mesh (parallel/mesh.py):
    channel shards need nothing from one another, time shards take two
    halos a call.  Every shard runs the resampler's own executors.

    In-process (``mesh.group is None``) ``oneshot`` takes and returns the
    whole [C, N] / [C, out_len] signal and runs the shards one after
    another on the resampler's device.  Under torch.distributed each rank
    passes and gets back only its own piece: ``shard_slices`` says which
    rows and columns of the input and output those are."""

    def __init__(self, rs, mesh):
        self.rs = rs
        self.mesh = mesh
        self.n_ch, self.n_t = mesh.n_ch, mesh.n_t
        mesh.check_device(rs.device)
        self.period = chain_shift_period(rs.plan)
        self.span = chain_input_span(rs.plan)
        self._poly = None
        if self.period is None and self.n_t > 1:
            # time shards split the chain at the interpolator (module
            # docstring); a channel-only mesh runs the whole chain
            from ..models.stream import _sub_execs

            self._poly = poly_split(rs.plan)
            self._poly["pre_execs"] = _sub_execs(rs, self._poly["pre"]) \
                if self._poly["pre"] else []
            self._poly["post_execs"] = _sub_execs(rs, self._poly["post"]) \
                if self._poly["post"] else []
        self._layouts = OrderedDict()

    # -- geometry ----------------------------------------------------------

    def _layout(self, out_len: int, n_in: int) -> dict:
        """The program's geometry for (out_len, n_in) and, on the
        polynomial path, its device data; kept for LAYOUT_CACHE keys."""
        key = (out_len, n_in)
        lay = self._layouts.get(key)
        if lay is not None:
            self._layouts.move_to_end(key)
            return lay
        if not self.rs.plan.stages:
            M_s = -(-max(n_in, out_len) // self.n_t)
            lay = dict(kind="pass", M_s=M_s, L_s=M_s, H=0, W=0, R=0)
        elif self._poly is not None:
            geom, relpos, flt = poly_geometry(self.rs.plan, self._poly,
                                              self.n_t, out_len, n_in)
            dev = self.rs.device
            high = (self.rs.precision == "high"
                    and self.rs.dtype == torch.float32)
            lay = dict(kind="poly", **geom,
                       rp=torch.from_numpy(relpos).to(dev),
                       fv=filter_values(flt, self.rs.dtype, high, dev))
        else:
            M_s, L_s, H, W, R = shard_geometry(self.rs.plan, self.period,
                                               self.span, self.n_t, out_len,
                                               n_in)
            lay = dict(kind="rational", M_s=M_s, L_s=L_s, H=H, W=W, R=R)
        self._layouts[key] = lay
        while len(self._layouts) > LAYOUT_CACHE:
            self._layouts.popitem(last=False)
        return lay

    def shard_slices(self, channels: int, n_in: int,
                     out_len: Optional[int] = None, rank=None):
        """(rows, t_in, t_out): the slices of the [channels, n_in] input
        and of the [channels, out_len] output that shard ``rank`` owns
        (default: this process's rank under torch.distributed).  A caller
        loads ``x[rows, t_in]`` and gets back ``y[rows, t_out]``."""
        if out_len is None:
            out_len = self.rs.default_out_len(n_in)
        if rank is None:
            if not self.mesh.distributed:
                raise ValueError("an in-process mesh needs the shard's rank")
            rank = self.mesh.rank
        lay = self._layout(out_len, n_in)
        ci, ti = self.mesh.coord(rank)
        C_loc = -(-channels // self.n_ch)
        L_s, M_s = lay["L_s"], lay["M_s"]

        def cut(a, b, n):
            return slice(min(n, a), min(n, b))

        return (cut(ci * C_loc, (ci + 1) * C_loc, channels),
                cut(ti * L_s, (ti + 1) * L_s, n_in),
                cut(ti * M_s, (ti + 1) * M_s, out_len))

    # -- execution ---------------------------------------------------------

    def _halos(self, pieces, L_s: int, H: int, R: int):
        """Each shard's left halo (the last H inputs of its left
        neighbour) and right halo (the first R of its right one)."""
        mesh = self.mesh
        left = mesh.permute({r: p[:, L_s - H :] for r, p in pieces.items()},
                            mesh.t_pairs(+1))
        right = mesh.permute({r: p[:, :R] for r, p in pieces.items()},
                             mesh.t_pairs(-1))
        return left, right

    def _window(self, xl, left, right, H: int, ti: int):
        """Shard ti's chain input.  A mid-stream shard reads [left | own |
        right] and drops its warm-up outputs.  Shard 0 computes the TRUE
        stream start: the chain is not shift-invariant there (the latency
        skip drops the filters' pre-ring, and a zero history would put
        ghost pre-ring samples where later stages read; the reference
        starts every buffer at absolute zero, CDSPBlockConvolver.h:
        94-158), so it reads [own | right | zeros(H)] and keeps its outputs
        from 0."""
        if ti == 0:
            return torch.cat([xl, right, xl.new_zeros((xl.shape[0], H))],
                             dim=1)
        return torch.cat([left, xl, right], dim=1)

    def _run_rational(self, pieces, lay):
        M_s, L_s, H, W, R = (lay[k] for k in ("M_s", "L_s", "H", "W", "R"))
        chain = self.rs if lay["kind"] == "rational" else (lambda w: w)
        out = {}
        if self.n_t > 1:
            left, right = self._halos(pieces, L_s, H, R)
        for r, xl in pieces.items():
            ti = self.mesh.coord(r)[1]
            if self.n_t > 1:
                window = self._window(xl, left[r], right[r], H, ti)
                start = 0 if ti == 0 else W
            else:
                window, start = F.pad(xl, (0, R)), W
            y = chain(window)
            assert y.shape[1] >= start + M_s, (y.shape, start, M_s)
            out[r] = y[:, start : start + M_s]
        return out

    def _run_poly(self, pieces, lay):
        from ..models.resampler import run_chain

        P_ = self._poly
        M_s, L_s, H, R = lay["M_s"], lay["L_s"], lay["H"], lay["R"]
        padl, Wf_out = lay["padl"], lay["Wf_out"]
        fv = lay["fv"]
        left, right = self._halos(pieces, L_s, H, R)
        out = {}
        for r, xl in pieces.items():
            ti = self.mesh.coord(r)[1]
            mid = self._window(xl, left[r], right[r], H, ti)
            if P_["pre_execs"]:
                mid = run_chain(P_["pre_execs"], mid)
            if padl:
                mid = F.pad(mid, (padl, 0))
            y = gather_dot(mid, lay["rp"][ti],
                           tuple(v[ti] for v in fv)
                           if isinstance(fv, tuple) else fv[ti])
            start = 0
            if P_["post_execs"]:
                y = run_chain(P_["post_execs"], y)
                start = 0 if ti == 0 else Wf_out
            assert y.shape[1] >= start + M_s, (y.shape, start, M_s)
            out[r] = y[:, start : start + M_s]
        return out

    @torch.no_grad()
    def oneshot(self, x, out_len: Optional[int] = None,
                n_in: Optional[int] = None,
                channels: Optional[int] = None) -> torch.Tensor:
        """Sharded offline conversion with the oneshot's zero flush.

        In-process: x [C, N], a tensor or an array; returns [C, out_len]
        on the resampler's device.  Under torch.distributed: x is this
        rank's ``x[rows, t_in]`` of the [channels, n_in] signal
        (``shard_slices``), and the result its ``y[rows, t_out]``."""
        rs, mesh = self.rs, self.mesh
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.to(device=rs.device, dtype=rs.dtype)
        if mesh.distributed:
            if n_in is None or channels is None:
                raise ValueError("under torch.distributed oneshot needs the "
                                 "whole signal's n_in and channels")
            C, N = int(channels), int(n_in)
        else:
            C, N = x.shape
        if out_len is None:
            out_len = rs.default_out_len(N)
        lay = self._layout(out_len, N)
        L_s = lay["L_s"]
        C_loc = -(-C // self.n_ch)
        if mesh.distributed:
            rows, t_in, t_out = self.shard_slices(C, N, out_len)
            want = (rows.stop - rows.start, t_in.stop - t_in.start)
            if tuple(x.shape) != want:
                raise ValueError(f"rank {mesh.rank} owns x[{rows.start}:"
                                 f"{rows.stop}, {t_in.start}:{t_in.stop}], "
                                 f"got a piece of shape {tuple(x.shape)}")
            pieces = {mesh.rank: F.pad(x, (0, L_s - x.shape[1],
                                           0, C_loc - x.shape[0]))}
        else:
            T = self.n_t * L_s
            xp = F.pad(x, (0, max(0, T - N), 0, C_loc * self.n_ch - C))
            pieces = mesh.split(xp[:, :T], C_loc, L_s)
        run = self._run_poly if lay["kind"] == "poly" else self._run_rational
        ys = run(pieces, lay)
        if mesh.distributed:
            return ys[mesh.rank][: want[0], : t_out.stop - t_out.start]
        return mesh.assemble(ys)[:C, :out_len]
