"""Minimal derivative-free optimisers (numpy only), for the port's table
regenerators tools/torch_hbopt.py and tools/torch_winopt.py: the
counterparts of the reference's BiteOptDeep-based offline optimisers
(other/hbopt.cpp:12-230, other/winopt.cpp:13-137).  The same algorithms,
draws and stopping rules as tools/optim.py, so a run with the same seed
returns the same point.

``differential_evolution`` expects a VECTORIZED cost: fn(P[pop, dim]) ->
cost[pop].  A final coordinate pattern-search polish tightens the best
point (the reference's plateau-based stop plays the same role).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["differential_evolution", "pattern_polish"]


def differential_evolution(
    fn: Callable[[np.ndarray], np.ndarray],
    lo: np.ndarray, hi: np.ndarray, *,
    pop: int = 48, gens: int = 1500, f: float = 0.7, cr: float = 0.9,
    seed: int = 1, tol_stall: int = 300,
    x0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, float]:
    """DE/rand/1/bin with clamped bounds and stall-based early stop."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    dim = lo.shape[0]
    X = lo + (hi - lo) * rng.random((pop, dim))
    if x0 is not None:
        X[0] = np.clip(np.asarray(x0, dtype=np.float64), lo, hi)
    C = fn(X)
    best_i = int(np.argmin(C))
    best_x, best_c = X[best_i].copy(), float(C[best_i])
    stall = 0
    for _ in range(gens):
        idx = np.arange(pop)
        r1, r2, r3 = (rng.permutation(pop) for _ in range(3))
        # ensure distinctness cheaply: r's are permutations, collisions rare
        V = X[r1] + f * (X[r2] - X[r3])
        mask = rng.random((pop, dim)) < cr
        mask[idx, rng.integers(0, dim, pop)] = True
        U = np.where(mask, V, X)
        U = np.clip(U, lo, hi)
        CU = fn(U)
        better = CU < C
        X[better] = U[better]
        C[better] = CU[better]
        i = int(np.argmin(C))
        if C[i] < best_c - 1e-12:
            best_x, best_c = X[i].copy(), float(C[i])
            stall = 0
        else:
            stall += 1
            if stall >= tol_stall:
                break
    return best_x, best_c


def pattern_polish(
    fn: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray, lo: np.ndarray, hi: np.ndarray, *,
    step: float = 1e-3, shrink: float = 0.5, min_step: float = 1e-10,
) -> Tuple[np.ndarray, float]:
    """Coordinate pattern search from ``x`` (vectorized probes per axis)."""
    x = np.asarray(x, dtype=np.float64).copy()
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    dim = x.shape[0]
    c = float(fn(x[None])[0])
    s = step * (hi - lo)
    while np.max(s / (hi - lo)) > min_step:
        probes = np.concatenate([
            np.clip(x[None] + np.diag(s), lo, hi),
            np.clip(x[None] - np.diag(s), lo, hi)], axis=0)
        pc = fn(probes)
        i = int(np.argmin(pc))
        if pc[i] < c - 1e-15:
            x = probes[i]
            c = float(pc[i])
        else:
            s *= shrink
    return x, c
