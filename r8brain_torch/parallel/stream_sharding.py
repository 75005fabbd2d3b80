"""Sharded push-mode streaming: a halo exchange every block, over a Mesh.

Counterpart of the reference package's ``parallel/stream_sharding.py``.
The port's StreamResampler (models/stream.py) carries the last H input
samples between blocks, the explicit-carry form of the reference's ring
buffers.  This module shards that loop over a ("ch", "t") mesh
(parallel/mesh.py):

* channels over ``ch`` (no communication);
* time WITHIN each pushed block over ``t``: shard k processes segment k of
  the block.  Its history (the H samples before its segment) is the tail
  of shard k-1's segment (``Mesh.permute``), except for shard 0, whose
  history is the carry: the last H samples of the previous block, which
  move each call from the channel row's last shard to its first.

A causal chain needs no right halo on steady blocks: it emits only outputs
computable from inputs received so far (out(n) = n*r - lat_o), so shard
k's outputs end exactly at its own segment's last input.  Only the FIRST
call differs: it must reproduce the true stream start (the chain is not
shift-invariant there, see parallel/sharding.py shard 0), so call 0 runs
the start program, in which shard 0 reads an unshifted window with a right
halo from shard 1, mid shards read left and right halos, and the last
lat_o outputs (which depend on the next block) are withheld and emitted by
call 1.

Polynomial-interpolator plans stream through ``_PolyShardedStream``: the
same [history | segment] window and carry; each call the host gives every
shard a contiguous output range bounded by what its window can causally
produce (read positions are a closed form of the absolute output index)
and computes the positions and spline values behind it.

In-process, ``process_block`` takes the whole [C, block] block and returns
the call's outputs; under torch.distributed each rank passes its own
[rows, L] segment (``shard_slices``) and gets its own outputs back.
Outputs are tensors on the stream's device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.lengths import (chain_in_for_out, chain_input_span,
                              chain_out_len, chain_shift_period,
                              frac_positions, round_up)
from .sharding import filter_values, gather_dot, poly_split, spline_values

__all__ = ["ShardedStreamResampler"]


def ShardedStreamResampler(rs, mesh, seg_len: int = 8192):
    """Push-mode streaming of ``rs`` over the mesh ``mesh``.

    Feed whole blocks of ``self.block`` input samples a call
    (``process_block``); each call returns the newly computable outputs.
    Rational plans stream through the period-aligned program
    (:class:`_RationalShardedStream`), polynomial-interpolator plans
    through the split-chain program with host positions each call
    (:class:`_PolyShardedStream`)."""
    if chain_shift_period(rs.plan) is None:
        return _PolyShardedStream(rs, mesh, seg_len)
    return _RationalShardedStream(rs, mesh, seg_len)


class _ShardedStream:
    """What the two programs share: the blocks, the carry, the counters,
    process / flush and the checkpoints.  A subclass sets H, L, block and
    implements ``_step(pieces) -> (outputs by rank, counts by t)``."""

    def _setup(self, rs, mesh):
        self.rs = rs
        self.mesh = mesh
        self.n_ch, self.n_t = mesh.n_ch, mesh.n_t
        self.device = rs.device
        self.dtype = rs.dtype
        mesh.check_device(rs.device)

    def geometry(self) -> dict:
        """The geometry a checkpoint must match."""
        return {"block": self.block, "L": self.L, "H": self.H,
                "n_ch": self.n_ch, "n_t": self.n_t}

    def shard_slices(self, channels: int, rank=None):
        """(rows, t_in): the rows of a [channels, block] block and the
        columns that shard ``rank`` (default: this process's rank under
        torch.distributed) owns; its outputs are rows ``rows`` of the
        call's output, columns after those of its time predecessors."""
        if rank is None:
            if not self.mesh.distributed:
                raise ValueError("an in-process mesh needs the shard's rank")
            rank = self.mesh.rank
        ci, ti = self.mesh.coord(rank)
        C_loc = -(-channels // self.n_ch)
        return (slice(min(channels, ci * C_loc),
                      min(channels, (ci + 1) * C_loc)),
                slice(ti * self.L, (ti + 1) * self.L))

    def reset(self):
        self._carry = None
        self.n_in = 0
        self.n_out = 0
        self._call = 0
        self._channels = None
        self._pending = None
        self._counts = None

    def _ti(self, r: int) -> int:
        return self.mesh.coord(r)[1]

    def _history(self, pieces):
        """Each shard's history: the carry on shard 0 (None before the
        first call, whose shard 0 starts the stream), the tail of its left
        neighbour's segment elsewhere."""
        carry = self._carry or {}
        if self.n_t == 1:
            return {r: carry.get(r) for r in pieces}
        left = self.mesh.permute(
            {r: p[:, self.L - self.H :] for r, p in pieces.items()},
            self.mesh.t_pairs(+1))
        return {r: carry.get(r) if self._ti(r) == 0 else left[r]
                for r in pieces}

    @torch.no_grad()
    def process_block(self, x) -> torch.Tensor:
        """One whole block -> the outputs it completes.  In-process: x is
        [C, block]; under torch.distributed this rank's [rows, L]
        segment of it (``shard_slices``)."""
        mesh = self.mesh
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.to(device=self.device, dtype=self.dtype)
        width = self.L if mesh.distributed else self.block
        if x.dim() != 2 or x.shape[1] != width:
            raise ValueError(f"block must be [channels, {width}], got "
                             f"{tuple(x.shape)}")
        C = int(x.shape[0])
        if self._channels is None:
            self._channels = C
        elif C != self._channels:
            raise ValueError(f"block has {C} channels, stream started "
                             f"with {self._channels}")
        if mesh.distributed:
            pieces = {mesh.rank: x}
        else:
            C_loc = -(-C // self.n_ch)
            x = F.pad(x, (0, 0, 0, C_loc * self.n_ch - C))
            pieces = mesh.split(x, C_loc, self.L)
        outs, counts = self._step(pieces)
        carry = mesh.permute(
            {r: p[:, self.L - self.H :] for r, p in pieces.items()},
            mesh.carry_pairs())
        # a copy: the caller may reuse its block's memory
        self._carry = {r: c.clone() for r, c in carry.items()
                       if self._ti(r) == 0}
        self._counts = (self.n_out, counts)
        self.n_in += self.block
        self.n_out += int(sum(counts))
        self._call += 1
        if mesh.distributed:
            return outs[mesh.rank]
        return mesh.assemble(outs)[:C]

    def process(self, x) -> torch.Tensor:
        """Chunks of any length (in-process only), re-blocked on the block
        grid; the outputs of the whole blocks they complete."""
        if self.mesh.distributed:
            raise ValueError("process() re-blocks the whole signal; under "
                             "torch.distributed each rank feeds its "
                             "segments to process_block")
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.to(device=self.device, dtype=self.dtype)
        if x.dim() == 1:
            x = x[None]
        buf = x if self._pending is None else torch.cat([self._pending, x],
                                                        dim=1)
        outs = []
        while buf.shape[1] >= self.block:
            outs.append(self.process_block(buf[:, : self.block]))
            buf = buf[:, self.block :]
        self._pending = buf
        return torch.cat(outs, dim=1) if outs else \
            x.new_zeros((x.shape[0], 0))

    def flush(self, out_len: Optional[int] = None) -> torch.Tensor:
        """Zero-feed until out_len outputs in all (default floor(n_in *
        r)).  Under torch.distributed this rank's part of them."""
        n_real = self.n_in + (0 if self._pending is None
                              else self._pending.shape[1])
        if out_len is None:
            out_len = int(math.floor(
                n_real * self.rs.plan.dst_rate / self.rs.plan.src_rate))
        C = self._channels or 1
        outs = []
        guard = 0
        while self.n_out < out_len and guard < 10000:
            if self.mesh.distributed:
                y = self.process_block(torch.zeros((C, self.L)))
                before, counts = self._counts
                ti = self._ti(self.mesh.rank)
                pos = before + sum(counts[:ti])
                outs.append(y[:, : max(0, min(y.shape[1], out_len - pos))])
            else:
                n_pend = 0 if self._pending is None \
                    else self._pending.shape[1]
                outs.append(self.process(
                    torch.zeros((C, self.block - n_pend))))
            guard += 1
        y = torch.cat(outs, dim=1) if outs else \
            torch.zeros((C, 0), dtype=self.dtype, device=self.device)
        extra = self.n_out - out_len
        if extra > 0:
            if not self.mesh.distributed:
                y = y[:, : y.shape[1] - extra]
            self.n_out = out_len
        return y

    # -- checkpoint / resume -------------------------------------------------

    def get_state(self) -> dict:
        """Host arrays and counters; ``carry`` is [C_pad, H] in-process,
        this rank's [rows, H] under torch.distributed (None on ranks that
        are no channel row's first time shard, and before the first
        call)."""
        carry = None
        if self._carry is not None:
            if self.mesh.distributed:
                c = self._carry.get(self.mesh.rank)
                carry = None if c is None else c.cpu().numpy()
            else:
                carry = torch.cat([self._carry[self.mesh.rank_at(ci, 0)]
                                   for ci in range(self.n_ch)],
                                  dim=0).cpu().numpy()
        return {"geometry": self.geometry(), "carry": carry,
                "n_in": self.n_in, "n_out": self.n_out, "call": self._call,
                "channels": self._channels,
                "pending": None if self._pending is None
                else self._pending.cpu().numpy()}

    def set_state(self, st: dict) -> None:
        if st["geometry"] != self.geometry():
            raise ValueError(f"checkpoint geometry {st['geometry']} is not "
                             f"this stream's {self.geometry()}")
        self.reset()
        carry = st["carry"]
        if carry is not None:
            c = torch.as_tensor(carry).to(self.device, self.dtype)
            if self.mesh.distributed:
                self._carry = {self.mesh.rank: c}
            else:
                rows = c.shape[0] // self.n_ch
                self._carry = {self.mesh.rank_at(ci, 0):
                               c[ci * rows : (ci + 1) * rows]
                               for ci in range(self.n_ch)}
        self.n_in = int(st["n_in"])
        self.n_out = int(st["n_out"])
        self._call = int(st["call"])
        self._channels = st["channels"]
        if st["pending"] is not None:
            self._pending = torch.as_tensor(st["pending"]).to(self.device,
                                                               self.dtype)


class _RationalShardedStream(_ShardedStream):
    """Period-aligned sharded streaming for whole-stepping plans."""

    def __init__(self, rs, mesh, seg_len: int = 8192):
        self._setup(rs, mesh)
        period = chain_shift_period(rs.plan)
        assert period is not None
        p_in, p_out = period
        span = chain_input_span(rs.plan)
        stages = rs.plan.stages

        # --- geometry (all period-aligned) -------------------------------
        H = round_up(span + 64, p_in)          # history / left halo
        L = round_up(max(seg_len, H, 2 * p_in), p_in)  # segment a shard
        # steady output lag: n*r - out_len(n) is constant past warm-up
        n0 = round_up(3 * (H + L) + span, p_in)
        lat_o = n0 * p_out // p_in - chain_out_len(stages, n0)
        # W0: where the steady window [hist H | seg L] starts emitting
        W0 = H * p_out // p_in - lat_o
        while W0 < 0:
            H += round_up((-W0) * p_in // p_out + p_in, p_in)
            W0 = H * p_out // p_in - lat_o
        M = L * p_out // p_in                    # outputs a shard a call
        # the steady window must be past warm-up (on the steady line) and
        # causal: out_len(H + L) == (H+L)*r - lat_o >= W0 + M
        guard = 0
        while chain_out_len(stages, H + L) < W0 + M or M <= lat_o:
            L += round_up(max(p_in, span), p_in)
            M = L * p_out // p_in
            guard += 1
            assert guard < 64, "cannot reach steady state; plan too deep"
        if H > L:  # halos come from the immediate neighbour
            L = round_up(H, p_in)
            M = L * p_out // p_in
        # call 0's right halo: mid / start windows emit [W, W+M) / [0, M)
        # and need chain_in_for_out(W + M) <= H + L + R inputs
        W = H * p_out // p_in
        R = max(0, chain_in_for_out(stages, W + M) - (H + L))
        R = round_up(R, p_in) + p_in
        if R > L:
            L = round_up(R, p_in)
            M = L * p_out // p_in
        self.p_in, self.p_out = p_in, p_out
        self.H, self.L, self.M, self.R = H, L, M, R
        self.W0, self.W, self.lat_o = W0, W, lat_o
        self.block = self.n_t * L                # inputs a process_block
        self.reset()

    def _step(self, pieces):
        rs, H, L, M, R = self.rs, self.H, self.L, self.M, self.R
        out = {}
        if self._call == 0:
            # true stream start on shard 0, halos elsewhere; the last
            # lat_o outputs withheld
            if self.n_t > 1:
                left = self.mesh.permute(
                    {r: p[:, L - H :] for r, p in pieces.items()},
                    self.mesh.t_pairs(+1))
                right = self.mesh.permute(
                    {r: p[:, :R] for r, p in pieces.items()},
                    self.mesh.t_pairs(-1))
            for r, xl in pieces.items():
                ti = self._ti(r)
                if self.n_t == 1:
                    y = rs(F.pad(xl, (0, R + H)))[:, :M]
                elif ti == 0:
                    y = rs(torch.cat([xl, right[r],
                                      xl.new_zeros((xl.shape[0], H))],
                                     dim=1))[:, :M]
                else:
                    y = rs(torch.cat([left[r], xl, right[r]],
                                     dim=1))[:, self.W : self.W + M]
                out[r] = y[:, : M - self.lat_o] if ti == self.n_t - 1 else y
            counts = [M] * (self.n_t - 1) + [M - self.lat_o]
            return out, counts
        hist = self._history(pieces)
        for r, xl in pieces.items():
            y = rs(torch.cat([hist[r], xl], dim=1))
            out[r] = y[:, self.W0 : self.W0 + M]
        return out, [M] * self.n_t


class _PolyShardedStream(_ShardedStream):
    """Sharded push-mode streaming for polynomial-interpolator plans.

    Shard k's window is [history H | segment L], the history being the
    carry (shard 0) or the left neighbour's segment tail.  Each call the
    host gives every shard a contiguous FINAL-output range bounded by what
    its window can causally produce, and computes the interpolator
    positions and float64 spline values behind it, padded to fixed caps
    (padded columns read the zero pad with zero filters).  A periodic
    suffix (the intermediate-interpolation branch) has period (1, sp_out),
    pure integer upsampling, so each shard runs it on its own interpolator
    window and takes its outputs from a per-shard offset w.  On call 0
    shard 0's window puts the input at the true stream origin ([x |
    zeros]), so the stages' latency skips see the reference's zero
    history."""

    def __init__(self, rs, mesh, seg_len: int = 8192):
        from ..models.stream import _sub_execs

        self._setup(rs, mesh)
        P_ = poly_split(rs.plan)
        pre, fs, post = P_["pre"], P_["fs"], P_["post"]
        assert P_["post_p"][0] == 1, \
            "suffix after a polynomial stage must be integer-upsampling"
        pp_in, pp_out = P_["pre_p"]
        self.sp_out = sp_out = P_["post_p"][1]
        span_pre, span_post = P_["span_pre"], P_["span_post"]
        self.pre_execs = _sub_execs(rs, pre) if pre else []
        self.post_execs = _sub_execs(rs, post) if post else []
        self.post = post
        self.fs = fs
        self.fl = fl = fs.filter_len
        self.fll = fl // 2 - 1
        self.in_lat = fs.in_latency
        self.pp_in, self.pp_out = pp_in, pp_out
        self.settle = -(-(span_pre * pp_out) // pp_in) + 2
        self.Wf_in = span_post + 16 if post else 0
        self.Wf_out = self.Wf_in * sp_out
        r_frac = fs.src_rate / fs.dst_rate
        # H must keep shard k's first output -- whose reads start about
        # (suffix warm-up + suffix latency)*r_frac + fl before the
        # previous shard's coverage limit (itself short of the window end
        # by the prefix latency) -- past settle; the latencies come from
        # the length algebra, and the hand-off is then checked by a dry
        # run of the per-call assignment below, H growing until it holds
        lam_pre = chain_in_for_out(pre, 1) if pre else 0
        lam_post = chain_in_for_out(post, 1) if post else 0
        reach_mid = fl + 66 + int(math.ceil(
            (self.Wf_in + lam_post) * r_frac))
        H = round_up(span_pre + 64 + lam_pre
                      + (-(-reach_mid * pp_in // pp_out)), pp_in)
        ratio = rs.plan.dst_rate / rs.plan.src_rate
        self._high = rs.precision == "high" and rs.dtype == torch.float32
        for _ in range(10):
            # on call 0, shard 0 must emit at least the suffix warm-up
            # before shard 1 takes over (its window start a_k >= 0)
            L_min = int(math.ceil((self.Wf_out + sp_out + 64) / ratio)) \
                + span_pre + H if post else 0
            L = round_up(max(seg_len, H, 2 * pp_in, L_min), pp_in)
            self.H, self.L = H, L
            self.block = self.n_t * L
            self.midlen = chain_out_len(pre, H + L) if pre else H + L
            self.padl = fl + 4
            self.M_cap = int(math.ceil((H + L) * ratio)) + 8
            if post:
                self.Fc_cap = chain_in_for_out(
                    post, self.Wf_out + sp_out + self.M_cap) + 2
                self.plen = chain_out_len(post, self.Fc_cap)
                assert self.plen >= self.Wf_out + sp_out + self.M_cap
            else:
                self.Fc_cap = self.M_cap
            # shard 0's call-0 window is [x | zeros]: mid j is true-stream
            # only while its inputs stay inside the L real samples
            lo, hi = 0, self.midlen
            while lo < hi:
                m = (lo + hi + 1) // 2
                if (chain_in_for_out(pre, m) if pre else m) <= L:
                    lo = m
                else:
                    hi = m - 1
            self.valid_hi0 = lo
            # dry-run the host assignment for the start and two steady
            # calls (the geometry is call-invariant past that, drift one
            # sample a shard at most)
            self.n_out = 0
            try:
                for c in range(3):
                    _, _, _, counts = self._positions(c)
                    self.n_out += int(sum(counts))
                break
            except RuntimeError:
                H = round_up(H + max(H // 4, pp_in), pp_in)
        else:
            raise RuntimeError("poly stream geometry did not converge")
        self.reset()

    # -- host-side per-call output assignment --------------------------------

    def _max_n_for_read(self, lim: int) -> int:
        """Largest output index n whose integer read position s(n) <= lim
        (guarded closed-form search, models/lengths.py semantics)."""
        from ..models.lengths import _frac_read_pos_scalar as srd

        fs = self.fs
        r = fs.src_rate / fs.dst_rate
        shift = fs.init_frac_pos * fs.dst_rate / fs.src_rate
        n = int(math.floor((lim + 1) / r - shift))
        while n >= 0 and srd(fs, n) > lim:
            n -= 1
        while srd(fs, n + 1) <= lim:
            n += 1
        return n

    def _positions(self, call_idx: int):
        """(rp [n_t, Fc_cap] int64, flt [n_t, Fc_cap, fl] float64, w
        [n_t], counts [n_t]) of this call.  A shard's final-output range
        [b, b+cnt) maps to a suffix window starting at interpolator index
        a with emission offset w = b - a*sp_out; its positions are those
        of interpolator outputs [a, a + Fc_cap) (zero-padded past the
        count it consumes)."""
        n_t, H, L = self.n_t, self.H, self.L
        fl, fll, in_lat = self.fl, self.fll, self.in_lat
        post, sp_out, Wf_out = self.post, self.sp_out, self.Wf_out
        B = self.block
        rp_rows, fv_rows, w_rows, counts = [], [], [], []
        b = self.n_out
        for k in range(n_t):
            start0 = call_idx == 0 and k == 0
            org_in = 0 if start0 else call_idx * B + k * L - H
            org_mid = org_in * self.pp_out // self.pp_in
            mid_hi = org_mid + (self.valid_hi0 if start0 else self.midlen)
            # interpolator outputs this window can produce (exclusive):
            # the largest n whose read window [s-fll+in_lat, +fl) fits
            lim = mid_hi - fl + fll - in_lat
            n_frac_hi = self._max_n_for_read(lim) + 1
            if post:
                if start0:
                    a, w = 0, 0
                else:
                    a = (b - Wf_out) // sp_out
                    w = b - a * sp_out
                    if a < 0:
                        raise RuntimeError(
                            "suffix warm-up precedes stream start; "
                            "increase seg_len")
                navail = n_frac_hi - a
                lo, hi = 0, self.M_cap
                while lo < hi:
                    m = (lo + hi + 1) // 2
                    if chain_in_for_out(post, w + m) <= navail:
                        lo = m
                    else:
                        hi = m - 1
                cnt = lo
                fc_need = chain_in_for_out(post, w + cnt)
            else:
                a, w = b, 0
                cnt = min(max(n_frac_hi - b, 0), self.M_cap)
                fc_need = cnt
            if fc_need > 0:
                s, xf = frac_positions(self.fs, a, fc_need)
                rel = in_lat + s - fll - org_mid + self.padl
                if rel.min() < 0 or rel.max() + fl > self.padl + self.midlen:
                    raise RuntimeError("poly stream read out of window")
                if not start0 and rel.min() < self.padl + self.settle:
                    raise RuntimeError("poly stream read before settle")
                flt = spline_values(self.fs, xf)
            else:
                rel = np.zeros(0, dtype=np.int64)
                flt = np.zeros((0, fl), dtype=np.float64)
            pad = self.Fc_cap - fc_need
            rp_rows.append(np.concatenate([rel, np.zeros(pad, np.int64)]))
            fv_rows.append(np.concatenate([flt, np.zeros((pad, fl))]))
            w_rows.append(w)
            counts.append(cnt)
            b += cnt
        return np.stack(rp_rows), np.stack(fv_rows), w_rows, counts

    # -- one call ------------------------------------------------------------

    def _step(self, pieces):
        from ..models.resampler import run_chain

        rp, flt, w, counts = self._positions(self._call)
        # only the shards this process runs need their rows on the device
        ks = sorted({self._ti(r) for r in pieces})
        rp_d = torch.from_numpy(rp[ks]).to(self.device)
        fv_d = filter_values(flt[ks], self.dtype, self._high, self.device)
        hist = self._history(pieces)
        out = {}
        for r, xl in pieces.items():
            ti = self._ti(r)
            j = ks.index(ti)
            if self._call == 0 and ti == 0:
                window = F.pad(xl, (0, self.H))
            else:
                window = torch.cat([hist[r], xl], dim=1)
            mid = run_chain(self.pre_execs, window) if self.pre_execs \
                else window
            mid = F.pad(mid, (self.padl, 0))
            fv = tuple(v[j] for v in fv_d) if isinstance(fv_d, tuple) \
                else fv_d[j]
            y = gather_dot(mid, rp_d[j], fv)
            if self.post_execs:
                y = run_chain(self.post_execs, y)
            out[r] = y[:, w[ti] : w[ti] + counts[ti]]
        return out, counts
