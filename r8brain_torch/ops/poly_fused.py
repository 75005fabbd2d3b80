"""Fused [upsampling convolver, polynomial-mode interpolator] executor:
the polynomial chain's counterpart of ops/fused.py.

Counterpart of the reference package's ``ops/poly_fused.py``.  For the
interpolator's output n (read base w_n on the convolver's output grid,
spline filter flt_n) the pair composes into one drifting banded operator
over the original input:

    y[n] = sum_q Comp_n[q] * x[q],
    Comp_n[q] = sum_i flt_n[i] * k[(w_n + i) - up*q]

at about (K + fl)/up products an output, with no intermediate [C, up*N]
stream.  It runs on the banded machinery of ``FracPolyExec``: a rational
S/G near the per-output input advance, frames of W samples at the
uniform stride S read as reshape views, the groups chunked to the
operator's band (``chunk_drift_groups``), and each chunk contracted
against its operator R'[m, w, g] by ``banded_contract`` (a batched
``torch.matmul``; no kernel of its own).  The operator is built on the
device, fl gather-accumulate passes over a static host table:

    R'[m, w, g] = sum_i flt[m, g, i] * K2D[e(m, g) + i, w],
    K2D[e, w] = k[e - up*w],  e(m, g) = w_n - up*(A + m*S)

in float64 (filter values and sums), rounded once to the stage's dtype,
and kept for each input length, as ``FracPolyExec`` keeps its operators.
The main product sums in float64 (``poly_contract``, the interpolator's
own) and rounds once; under ``precision="high"`` the operator's rounding
residual rides a second pass.  The reference builds the operator in
float32, sums in float32 and contracts its residual table at bfloat16
DEFAULT precision: a float32 sum of the composite's W (880 at 44.1k ->
96001) taps misses the -141 dB class (ROADMAP.md section 3 records both
forms' dB).

The interpolator reads hard zeros below its stream start while the
composite extends the convolver into its latency zone, so the few
leading outputs affected get ``FusedUpExec``'s start correction (a
float64 product against the input prefix).

Opt-in (``Resampler(fused="poly")``), as in the reference.
"""

from __future__ import annotations

from collections import OrderedDict
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.lengths import chain_out_len, frac_positions
from ..models.plan import ConvStage, FracStage
from .stages import (_to_device, check_dtype, check_precision,
                     chunk_drift_groups, poly_cached, poly_contract)

__all__ = ["FusedPolyExec"]

#: The largest group size G the composite considers (the reference's).
G_MAX = 160
#: Drift slack of the composite's band, in input samples (the reference's).
SLACK = 6


class FusedPolyExec(nn.Module):
    def __init__(self, conv: ConvStage, frac: FracStage, dtype=torch.float32,
                 precision: str = "fast"):
        super().__init__()
        if not (isinstance(conv, ConvStage) and conv.down == 1
                and isinstance(frac, FracStage) and not frac.is_whole):
            raise ValueError("FusedPolyExec needs a [conv(up, down=1), "
                             "polynomial-frac] pair")
        check_dtype(dtype)
        check_precision(precision)
        self.stages = (conv, frac)
        self.frac = frac
        self.dtype = dtype
        self.precision = precision if dtype == torch.float32 else "fast"
        self.up = up = conv.up
        k64 = np.asarray(conv.filt.kernel, dtype=np.float64)
        self.K = K = k64.shape[0]
        self.off = conv.offset
        self.register_buffer("tab", torch.tensor(frac.bank.table,
                                                 dtype=torch.float64))
        self.fracs = frac.bank.fracs
        self.fl = fl = frac.filter_len
        self.fll = fl // 2 - 1
        self.in_lat = frac.in_latency

        # a rational convergent of the per-output advance on the input
        # grid (the interpolator's positions live on the convolver's
        # output grid, up times the input rate)
        r_in = (frac.src_rate / frac.dst_rate) / up
        fr = Fraction(r_in).limit_denominator(G_MAX)
        if fr.denominator >= 8:
            km = max(1, min(G_MAX // fr.denominator,
                            -(-128 // fr.denominator)))
            self.G, self.S = fr.denominator * km, fr.numerator * km
        else:
            self.G, self.S = 128, int(round(128 * r_in))
        drift = abs(self.G * r_in - self.S)
        self.ngrp_max = max(8, int(SLACK / max(drift, 1e-12)))
        # the operator rows a group can reach: e <= (K - 1) + up*(the
        # group's ramp S - 1 + the drift slack), plus fl for the taps
        self.E = K + fl + up * (self.S + SLACK)
        self.W = -(-(self.E // up + 2) // 8) * 8
        e_i = np.arange(self.E)[:, None]
        kk = e_i - up * np.arange(self.W)[None, :]
        valid = (kk >= 0) & (kk < K)
        self.register_buffer("K2D", torch.from_numpy(
            np.where(valid, k64[np.clip(kk, 0, K - 1)], 0.0)))
        self._build_corr(k64)
        self._state = OrderedDict()

    def _filters(self, f: np.ndarray) -> np.ndarray:
        """[..., fl] float64 spline filters at the fractional positions f
        (host; the correction's few outputs)."""
        fr = f * self.fracs
        fti = np.floor(fr).astype(np.int64)
        t = (fr - fti)[..., None]
        tab = self.tab.numpy()
        return tab[fti, :, 0] + (tab[fti, :, 1] + tab[fti, :, 2] * t) * t

    def _build_corr(self, k64: np.ndarray) -> None:
        """The stream-start correction (see FusedUpExec): for the leading
        outputs whose interpolator window dips below the convolver's
        output stream start (s_n - fll + i < 0 reads a hard zero in the
        two-stage chain), the composite's spurious contribution, a float64
        host matrix against the input prefix."""
        up, K, fl, fll = self.up, self.K, self.fl, self.fll
        rows, js = [], []
        n = 0
        while True:
            s, f = frac_positions(self.frac, n, 1)
            s_n = int(s[0])
            if s_n - fll >= 0:
                break
            B = self._filters(f)[0]
            w_n = s_n - fll + self.in_lat + self.off
            qw = (w_n + fl - 1) // up + 1
            if qw > 0:
                row = np.zeros(qw, dtype=np.float64)
                for i in range(min(fl, fll - s_n)):  # window below start
                    for q in range(qw):
                        v = w_n + i - up * q
                        if 0 <= v < K:
                            row[q] += B[i] * k64[v]
                if np.any(row):
                    rows.append(row)
                    js.append(n)
            n += 1
        corr = corr_js = None
        if js:
            corr = np.zeros((len(js), max(r.shape[0] for r in rows)))
            for i, row in enumerate(rows):
                corr[i, : row.shape[0]] = row
            corr = torch.from_numpy(corr)
            corr_js = torch.tensor(js, dtype=torch.long)
        self.register_buffer("corr", corr)
        self.register_buffer("corr_js", corr_js)

    def out_len(self, n_in: int) -> int:
        return chain_out_len(self.stages, n_in)

    def _operators(self, fti, t, e, dev) -> dict:
        """``poly_contract``'s operators for one chunk: R'[m, w, g] from
        host positions (table rows fti, float64 phases t, band rows e;
        [nloc, G] each), summed in float64 on ``dev`` and rounded once to
        the stage's dtype (float32: "R64" holds the rounded operator in
        float64, and under "high" "R_lo" the rounding's residual; float64:
        "R")."""
        d = _to_device(np.stack([fti, t, e]).astype(np.float64), dev)
        fi, tt, ed = d[0].long(), d[1][..., None], d[2].long()
        tb = self.tab[fi]
        flt = tb[..., 0] + (tb[..., 1] + tb[..., 2] * tt) * tt
        R = None
        for i in range(self.fl):
            term = flt[..., i : i + 1] * self.K2D[ed + i]
            R = term if R is None else R + term
        R = R.transpose(1, 2).contiguous()  # [nloc, W, G]
        if self.dtype == torch.float64:
            return {"R": R, "R64": None, "R_lo": None}
        R64 = R.float().double()
        lo = (R - R64).float() if self.precision == "high" else None
        return {"R": None, "R64": R64, "R_lo": lo}

    def _build(self, M: int, dev):
        """(chunks [(A, nloc, operators)], need_len, pad_l) of M outputs,
        built once a length."""
        up, K, G, S = self.up, self.K, self.G, self.S
        n_grp = -(-M // G)
        s, f = frac_positions(self.frac, 0, n_grp * G)
        fr = f * self.fracs
        fti = np.floor(fr).astype(np.int64)
        t = fr - fti
        w = s - self.fll + self.in_lat + self.off  # composite read base
        # each output's first input with a nonzero coefficient
        q_lo = -(-(w - K + 1) // up)
        chunks, need_len, pad_l = chunk_drift_groups(
            q_lo.reshape(n_grp, G), w.reshape(n_grp, G), up, S, self.fl,
            self.E, self.ngrp_max, self.W)
        fti2, t2 = fti.reshape(n_grp, G), t.reshape(n_grp, G)
        built = [(A, nloc, self._operators(fti2[g0 : g0 + nloc],
                                           t2[g0 : g0 + nloc], e, dev))
                 for g0, nloc, A, e in chunks]
        return built, need_len, pad_l

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        C, N = x.shape
        M = self.out_len(N)
        if M <= 0:
            return x.new_zeros((C, 0), dtype=self.dtype)
        chunks, need_len, pad_l = poly_cached(
            self._state, (M, x.device), lambda: self._build(M, x.device))
        S, W, G = self.S, self.W, self.G
        xp = F.pad(x.to(self.dtype), (pad_l, max(0, need_len - (N + pad_l))))
        span = -(-W // S) * S  # past the chunk's nloc*S: its last frame
        outs = []
        for A, nloc, ops in chunks:
            # float32: the main product sums in float64 in both precision
            # classes ("high" is poly_contract's float64 sum), as a
            # float32 sum of the composite's W taps misses the -141 dB
            # class (ROADMAP.md section 3); float64 sums in float64
            o, small = poly_contract(
                xp[:, A : A + nloc * S + span], ops, nloc, S, W,
                "fast" if self.dtype == torch.float64 else "high")
            if small is not None:
                o = o + small
            outs.append(o.reshape(C, nloc * G))
        y = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        if self.corr_js is not None:
            qw = self.corr.shape[1]
            xw = F.pad(x[:, :qw], (0, max(0, qw - N)))
            # the few stream-start outputs, in float64 (never TF32)
            delta = torch.matmul(xw.double(), self.corr.T)
            y[:, self.corr_js] -= delta.to(self.dtype)
        return y[:, :M]

    forward = apply
