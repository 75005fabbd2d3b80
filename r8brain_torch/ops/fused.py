"""Fused two-stage executor: upsampling convolver + whole-stepping
interpolator as ONE per-phase composite operator.

The most common audio chain (e.g. 44.1 kHz -> 96 kHz: 2X convolver then
147/160 interpolator, CDSPResampler.h:218-227) is a cascade of two LTI+
resampling stages.  Composing them analytically gives, for each output
phase j in [0, p_out), a single composite FIR over the *input* stream at
stride p_in:

    y[m*p_out + j] = sum_q C_j[q] * x[m*p_in + q + a_j]
    C_j[q] = G_j(t_j - up*q),   G_j(v) = sum_i bank[f_j][i] * k[v + i]

derived by substituting the convolver's content formula
(y_c[r] = sum_m k[m] u[r + off - m], u = zero-stuff(x)) into the
interpolator's (y[n] = sum_i bank[f_n][i] y_c[s_n - fll + i]); the phase
residue t_j mod up is constant per j because the per-supercycle advance
p_in*up is divisible by up.

The operator is built on the host in float64 exactly as the reference
package builds it (r8brain_tpu/ops/fused.py), and held as ``op``
(ops/operators.py).  The contraction runs through ``frac_whole``: the
CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor.

Applicability: plan == [ConvStage(up, down=1), FracStage(whole)].
``fuse_stage_list`` also replaces each run of two or more float32
half-band upsamplers by one ``HBUpCascadeExec`` (ops/hb_cascade.py) and,
when asked, each [conv, poly-frac] pair by a ``FusedPolyExec``
(ops/poly_fused.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.lengths import chain_out_len, chain_shift_period
from ..models.plan import ConvStage, FracStage, Plan
from .hb_cascade import HBUpCascadeExec, hb_up_run_fusable
from .operators import FramedOperator
from .poly_fused import FusedPolyExec
from .stages import build_exec, check_dtype, check_precision

__all__ = ["can_fuse", "fuse_stage_list", "FusedUpExec"]


def _pair_fusable(a, b) -> bool:
    # every planner branch that puts a convolver directly before the
    # interpolator uses down == 1 (exact-ratio downsampling bypasses the
    # interpolator, CDSPResampler.h:337-391), so this covers all plans
    return (isinstance(a, ConvStage) and a.down == 1
            and isinstance(b, FracStage) and b.is_whole)


def can_fuse(plan: Plan) -> bool:
    s = plan.stages
    return len(s) == 2 and _pair_fusable(s[0], s[1])


def _poly_pair_fusable(a, b, dtype, engine, poly) -> bool:
    """[conv(up, down=1), poly-frac] fuses into a FusedPolyExec when asked
    (``poly``), in float32 on the matmul engines (float64 keeps the
    two-stage gather chain).  Opt-in, as in the reference: its drifting
    operator is built per input length."""
    return (poly and isinstance(a, ConvStage) and a.down == 1
            and isinstance(b, FracStage) and not b.is_whole
            and dtype == torch.float32
            and engine in ("auto", "toeplitz", "matmul"))


def fuse_stage_list(plan: Plan, dtype, precision, build=build_exec,
                    engine: str = "auto", poly: bool = False):
    """Executor list for the plan with every run of >= 2 half-band
    upsamplers replaced by an HBUpCascadeExec (float32 matmul engines),
    every adjacent [conv(up, down=1), whole-frac] pair by a FusedUpExec
    (any dtype and engine: on the card it always runs frac_whole), with
    ``poly`` every [conv(down=1), poly-frac] pair by a FusedPolyExec
    (float32 matmul engines), and every other stage given its own
    executor by ``build(stage, dtype, precision)`` (``build_exec`` with
    the caller's engines).  ``engine`` is the conv engine the caller asked
    for.  A pair or run mid-chain is valid: its input stream starts at
    zero of its own input, the fused executors' stream-start semantics.
    Returns None if nothing fuses: the caller then builds the stages one
    by one."""
    stages = plan.stages
    execs = []
    fused_any = False
    i = 0
    while i < len(stages):
        hb_run = hb_up_run_fusable(stages, i, dtype, engine)
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        if hb_run:
            execs.append(HBUpCascadeExec(stages[i : i + hb_run], dtype))
            i += hb_run
        elif nxt is not None and _pair_fusable(stages[i], nxt):
            sub = Plan(plan.src_rate, plan.dst_rate, plan.trans_band,
                       plan.atten, plan.phase, (stages[i], nxt),
                       nxt.latency_frac_out)
            execs.append(FusedUpExec(sub, dtype, precision))
            i += 2
        elif nxt is not None and _poly_pair_fusable(stages[i], nxt, dtype,
                                                    engine, poly):
            execs.append(FusedPolyExec(stages[i], nxt, dtype, precision))
            i += 2
        else:
            execs.append(build(stages[i], dtype, precision))
            i += 1
            continue
        fused_any = True
    return execs if fused_any else None


class FusedUpExec(nn.Module):
    def __init__(self, plan: Plan, dtype=torch.float32,
                 precision: str = "fast"):
        super().__init__()
        if not can_fuse(plan):
            raise ValueError("FusedUpExec needs a [conv(up, down=1), "
                             "whole-frac] plan:\n" + plan.describe())
        check_dtype(dtype)
        check_precision(precision)
        conv: ConvStage = plan.stages[0]
        frac: FracStage = plan.stages[1]
        self.stages = plan.stages
        self.dtype = dtype
        self.precision = precision if dtype == torch.float32 else "fast"
        np_dt = np.float64 if dtype == torch.float64 else np.float32

        up = conv.up
        k = np.asarray(conv.filt.kernel, dtype=np.float64)
        K = k.shape[0]
        bank = np.asarray(frac.bank.table, dtype=np.float64)  # [O_f, fl]
        fl = frac.filter_len
        fll = fl // 2 - 1
        I_f, O_f, W0 = frac.in_step, frac.out_step, frac.init_frac_pos_w

        # full-chain shift period
        period = chain_shift_period(plan)
        assert period is not None
        p_in, p_out = period
        # frac-input advance per supercycle must be whole and a multiple
        # of up (constant phase residue per j)
        assert (p_out * I_f) % O_f == 0
        assert (p_out * I_f // O_f) % up == 0

        # per-phase composite kernels over the input grid
        a = np.zeros(p_out, dtype=np.int64)
        width = (K + up * fl) // up + 2
        C = np.zeros((p_out, width), dtype=np.float64)
        for j in range(p_out):
            g = W0 + j * I_f
            s_j = g // O_f + frac.in_latency
            f_j = g % O_f
            t_j = s_j - fll + conv.offset
            B = bank[f_j]
            # G_j(v) = sum_i B[i] k[v + i], nonzero for v in
            # [-(fl-1), K); x[q] has coefficient G_j(t_j - up*q)
            # valid q: t_j - up*q in [-(fl-1), K)  ->
            #   q in ((t_j - K)/up, (t_j + fl - 1)/up]
            q_lo = -(-(t_j - K + 1) // up)  # ceil((t_j-K+1)/up)
            q_hi = (t_j + fl - 1) // up
            a[j] = q_lo
            for d, q in enumerate(range(q_lo, q_hi + 1)):
                v = t_j - up * q
                i0 = max(0, -v)
                i1 = min(fl, K - v)
                if i1 > i0:
                    C[j, d] = np.dot(B[i0:i1], k[v + i0 : v + i1])
        # extend the supercycle by the smallest k that makes the column
        # count k*p_out a multiple of 128 (the reference's layout choice;
        # kept so the operator is bit-identical to the reference's)
        kx = 1
        for cand in range(1, 5):
            if (cand * p_out) % 128 == 0:
                kx = cand
                break
        self.kx = kx
        a_min = int(a.min())
        D = int((a.max() - a_min)) + width + (kx - 1) * p_in
        sk = np.zeros((kx * p_out, D), dtype=np.float64)
        for c_off in range(kx):
            for j in range(p_out):
                o = int(a[j] - a_min) + c_off * p_in
                sk[c_off * p_out + j, o : o + width] = C[j]
        self.p_in, self.p_out = kx * p_in, kx * p_out
        self.a0 = a_min
        self.D = D

        # Stream-start correction: the composite extends the convolver
        # formula into its discarded latency zone, but the real chain's
        # interpolator reads hard zeros below its (post-skip) stream start.
        # Subtract the spurious contribution for the few affected outputs:
        #   delta[n] = sum_{i: r'_i < 0} bank[f_n][i] * yc[r'_i + in_lat]
        # where r'_i = g_n//O_f - fll + i and yc is the convolver formula.
        corr_rows = []
        corr_js = []
        n = 0
        while True:
            # walk OUTPUT indices until the interpolator window clears the
            # stream start -- for small supercycle advances (p_in*up < fll)
            # this spans multiple supercycles, not just the first
            g = W0 + n * I_f
            s_nolat = g // O_f
            if s_nolat - fll >= 0:
                break
            j = n
            B = bank[g % O_f]
            t_j = (s_nolat + frac.in_latency) - fll + conv.offset
            qw = (t_j + fl - 1) // up + 1  # x window [0, qw)
            if qw > 0:
                row = np.zeros(qw, dtype=np.float64)
                for i in range(min(fl, fll - s_nolat)):  # r'_i < 0
                    # yc[r'_i + in_lat] = sum_q k[(t_j + i) - up*q] x[q]
                    for q in range(qw):
                        v = t_j + i - up * q
                        if 0 <= v < K:
                            row[q] += B[i] * k[v]
                if np.any(row):
                    corr_rows.append(row)
                    corr_js.append(j)
            n += 1
        if corr_js:
            qw_max = max(r.shape[0] for r in corr_rows)
            Cm = np.zeros((len(corr_js), qw_max), dtype=np.float64)
            for r_i, row in enumerate(corr_rows):
                Cm[r_i, : row.shape[0]] = row
            self.register_buffer("corr", torch.from_numpy(Cm.astype(np_dt)))
            self.register_buffer("corr_js", torch.tensor(corr_js,
                                                         dtype=torch.long))
        else:
            self.corr = self.corr_js = None
        lo = None
        if self.precision == "high":
            lo = (sk.T - sk.T.astype(np.float32).astype(np.float64)).astype(
                np.float32)
        self.op = FramedOperator(sk.T, dtype, lo)

    def out_len(self, n_in: int) -> int:
        return chain_out_len(self.stages, n_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [C, N] on the executor's device -> y [C, out_len(N)]."""
        C_, N = x.shape
        M = self.out_len(N)
        if M <= 0:
            return x.new_zeros((C_, 0), dtype=self.dtype)
        p_in = self.p_in
        n_cyc = -(-M // self.p_out)
        x = x.to(self.dtype)
        # n_cyc windows of D samples from a0, framed over (n_cyc + n_seg) *
        # p_in samples
        y = self.op.apply(x, self.a0, (n_cyc - (-self.D // p_in)) * p_in,
                          p_in, n_cyc)
        if self.corr_js is not None:
            qw = self.corr.shape[1]
            xw = x[:, :qw]
            if xw.shape[1] < qw:
                xw = torch.nn.functional.pad(xw, (0, qw - xw.shape[1]))
            # the few stream-start outputs: a [C, qw] x [qw, n_aff] product
            # in float64 (exact enough, and never TF32)
            delta = torch.matmul(xw.double(), self.corr.double().T)
            y[:, self.corr_js] -= delta.to(self.dtype)
        return y[:, :M]
