"""A run of two or more half-band upsamplers as one polyphase framed
product.

Counterpart of the reference package's ``ops/hb_cascade.py``.  The
cascade is linear and time-invariant, so it composes exactly: with each
stage written as

    x_k[j] = conv(G_k, up2(x_{k-1}))[j + s_k],
    s_k = (2*nt_k - 1) + out_latency_k

(G_k the half-band kernel of length 4*nt_k - 1: centre tap 1 at 2*nt_k - 1,
taps flt[i] at 2*nt_k - 2 - 2*i and 2*nt_k + 2*i), the whole run is

    x_m[j] = conv(Gc, upU(x_0))[j + S],   U = 2^m,
    Gc_{t+1} = conv(G_{t+1}, up2(Gc_t)),  S_{t+1} = s_{t+1} + 2*S_t.

Output phase p in [0, U) reads the input grid only,

    x_m[U*n + p] = sum_j h_p[j] * x_0[n + c_p - j],
    e = p + S,  c_p = e // U,  h_p[j] = Gc[U*j + (e % U)],

so one framed product against a [L_f, U*B] operator writes the final
stream: one ``frac_whole`` call at I = B = 128, O = U*128 (4096 for the
five stages of PCM -> DSD64), no intermediate stream.

Left edge: each inner stage zero-pads its trimmed input stream, while the
composite sees the virtual pre-trim values there, so the first E outputs
differ.  E is bounded by carrying each inner stage's edge width 2*nt - 2
through the upsamplers after it (a <- 2a + 2*nt - 1).  The host builds, in
float64, the [P, E] correction C (cascade minus composite on unit
impulses: both are linear, and outputs < E depend only on the first P
inputs), added in place to the first E outputs; and the dense cascade
response D that is the whole functional when every output lies in the
edge.  In float64 the cascade equals the per-stage chain to ~1e-15
(tests/test_torch_halfband.py); in float32 it is a different, shorter
rounding chain, held to the same class.

While a profiler records, the edge step (the float64 copy of the first P
inputs, its product with C or D, the cast and the add) runs inside the
``r8b.hb.edge`` span, and each call adds the bytes its ``frac_whole``
call writes, trimmed columns included, to ``hb_cascade.out_bytes``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.lengths import stage_in_for_out, stage_out_len
from ..models.plan import HBUpStage
from ..utils.trace import count, span
from .framing import shifted
from .operators import FramedOperator
from .stages import HB_BLOCK, check_dtype

__all__ = ["HBUpCascadeExec", "hb_up_run_fusable", "compose_run"]


def hb_up_run_fusable(stages, i, dtype, engine: str = "auto") -> int:
    """Length of the run of HBUpStages from stages[i] that fuses (0 if
    shorter than 2): float32 matmul engines only (the conv engine
    ``engine`` "auto", "toeplitz" or "matmul", as the reference gates it);
    float64 keeps the per-stage stencils in the oracle's order."""
    if dtype != torch.float32 or engine not in ("auto", "toeplitz",
                                                 "matmul"):
        return 0
    n = 0
    while i + n < len(stages) and isinstance(stages[i + n], HBUpStage):
        n += 1
    return n if n >= 2 else 0


def _hb_full_kernel(spec: HBUpStage) -> np.ndarray:
    """A half-band stage as a full FIR over the zero-stuffed grid."""
    nt = spec.hb.num_taps
    t = np.asarray(spec.hb.taps, dtype=np.float64)
    g = np.zeros(4 * nt - 1, dtype=np.float64)
    g[2 * nt - 1] = 1.0
    g[2 * nt - 2 - 2 * np.arange(nt)] = t
    g[2 * nt + 2 * np.arange(nt)] = t
    return g


def _up2(g: np.ndarray) -> np.ndarray:
    u = np.zeros(2 * g.shape[0] - 1, dtype=np.float64)
    u[::2] = g
    return u


def compose_run(specs):
    """(Gc, S, U) of the run: x_m[j] = conv(Gc, upU(x_0))[j + S]."""
    Gc, S, U = None, 0, 1
    for sp in specs:
        g = _hb_full_kernel(sp)
        s_k = (2 * sp.hb.num_taps - 1) + sp.out_latency
        if Gc is None:
            Gc, S = g, s_k
        else:
            Gc = np.convolve(g, _up2(Gc))
            S = s_k + 2 * S
        U *= 2
    return Gc, S, U


def _cascade_ref(x: np.ndarray, specs) -> np.ndarray:
    """The per-stage cascade on a 1-D float64 signal, HBUpExec's
    semantics: y[2n] = x[n]; y[2n+1] = sum_i flt[i]*(x[n+1+i] + x[n-i])
    with x zero-extended on the left; then [lat : lat+M]."""
    for sp in specs:
        nt = sp.hb.num_taps
        t = np.asarray(sp.hb.taps, dtype=np.float64)
        npair = x.shape[0] - nt
        M = max(0, 2 * npair - sp.out_latency)
        if M <= 0:
            return np.zeros(0, dtype=np.float64)
        xp = np.pad(x, (nt, nt))
        odd = np.zeros(npair)
        for i in range(nt):
            odd += t[i] * (xp[nt + 1 + i : nt + 1 + i + npair]
                           + xp[nt - i : nt - i + npair])
        y = np.empty(2 * npair)
        y[0::2] = x[:npair]
        y[1::2] = odd
        x = y[sp.out_latency : sp.out_latency + M]
    return x


class HBUpCascadeExec(nn.Module):
    """One polyphase framed product for a run of >= 2 HBUpStages (the
    operator, the edge matrices and their geometry built on the host in
    float64, as the reference builds them)."""

    engine = "matmul"

    def __init__(self, specs, dtype=torch.float32):
        super().__init__()
        if len(specs) < 2 or not all(isinstance(s, HBUpStage)
                                     for s in specs):
            raise ValueError("HBUpCascadeExec needs a run of >= 2 "
                             "half-band upsamplers")
        check_dtype(dtype)
        self.specs = tuple(specs)
        self.dtype = dtype
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        B = HB_BLOCK
        Gc, S, U = compose_run(specs)
        self.U = U

        # per-phase filters over the input grid, zero-trimmed
        phases = []  # (c_p adjusted, taps)
        for p in range(U):
            c_p, r = divmod(p + S, U)
            h = Gc[r::U]
            nz = np.nonzero(h)[0]
            assert nz.size, "a half-band composite phase cannot be empty"
            j0, j1 = int(nz[0]), int(nz[-1])
            phases.append((c_p - j0, h[j0 : j1 + 1]))
        # phase p reads offsets c'_p - j', j' in [0, len(h))
        minr = min(c - (len(h) - 1) for c, h in phases)
        maxr = max(c for c, h in phases)
        self.minr = minr
        T = np.zeros((B + (maxr - minr), U * B), dtype=np.float64)
        b = np.arange(B)
        for p, (c, h) in enumerate(phases):
            for j, v in enumerate(h):
                T[c - j - minr + b, p + U * b] = v
        self.op = FramedOperator(T, dtype)

        # the left edge: carry each inner stage's edge width through the
        # rest of the run
        m = len(specs)
        E = 0
        for t in range(1, m):
            a = 2 * specs[t].hb.num_taps - 2
            for s in range(t + 1, m):
                a = 2 * a + 2 * specs[s].hb.num_taps - 1
            E = max(E, a)
        # the input prefix that fixes outputs < E in both forms
        P = 0
        if E > 0:
            P = E
            for sp in reversed(specs):
                P = stage_in_for_out(sp, P)
            P = max(P, (E - 1) // U + maxr + 1)
        self.E, self.P = E, P
        Cm = D = None
        if E > 0:
            D = np.zeros((P, E), dtype=np.float64)   # cascade responses
            Cm = np.zeros((P, E), dtype=np.float64)  # cascade - composite
            LG = Gc.shape[0]
            for i in range(P):
                imp = np.zeros(P)
                imp[i] = 1.0
                casc = _cascade_ref(imp, specs)
                assert casc.shape[0] >= E
                D[i] = casc[:E]
                lo = S - U * i  # the composite's response: Gc[j + lo]
                j0, j1 = max(0, -lo), min(E, LG - lo)
                Cm[i] = D[i]
                if j1 > j0:
                    Cm[i, j0:j1] -= Gc[lo + j0 : lo + j1]
            Cm, D = (torch.from_numpy(a.astype(np_dt)) for a in (Cm, D))
        self.register_buffer("edge_C", Cm)
        self.register_buffer("edge_D", D)

    def out_len(self, n_in: int) -> int:
        n = n_in
        for sp in self.specs:
            n = stage_out_len(sp, n)
        return n

    def _edge(self, x: torch.Tensor, Mx: torch.Tensor) -> torch.Tensor:
        """x's first P samples (zero-padded) times an edge matrix, in
        float64 (never TF32), in x's dtype."""
        xh = shifted(x, 0, self.P, torch.float64)[:, : self.P]
        return torch.matmul(xh, Mx.double()).to(self.dtype)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        C, N = x.shape
        M = self.out_len(N)
        if M <= 0:
            return x.new_zeros((C, 0), dtype=self.dtype)
        if self.edge_D is not None and M <= self.E:
            # every output lies in the edge: the dense cascade response
            # is the exact functional
            with span("r8b.hb.edge"):
                return self._edge(x, self.edge_D[:, :M])
        B, U = HB_BLOCK, self.U
        n_blocks = -(-(-(-M // U)) // B)
        # block b reads x[minr + b*B + l], l < L_f; cells of zero weight
        # may lie outside x (zeros there)
        y = self.op.apply(x, self.minr, (n_blocks - 1) * B + self.op.L_f, B,
                          n_blocks)
        count("hb_cascade.out_bytes", n_blocks * B * U * C
              * self.dtype.itemsize)
        if self.edge_C is not None:
            E = min(self.E, M)
            with span("r8b.hb.edge"):
                y[:, :E] += self._edge(x, self.edge_C[:, :E])
        return y[:, :M]

    forward = apply
