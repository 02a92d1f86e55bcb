"""Performance bounds: Theorem 3.5 upper bound (17), Lemma B.1 lower bound
(35), and the resulting CG-BPRR approximation ratio (B.4)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.perf_model import Problem
from repro_torch.core.placement import amortized_time, conservative_m


def cg_upper_bound(problem: Problem, R: int) -> float:
    """(17):  T^g ≤ Σ_{j≤K} t̃_j m_j − τ_K (Σ_{j≤K} m_j − L)."""
    m = conservative_m(problem, R)
    t_tilde = amortized_time(problem, m)
    order = np.argsort(t_tilde, kind="stable")
    tau = problem.tau()
    total_m = 0
    bound = 0.0
    for j in order:
        if m[j] <= 0 or not np.isfinite(t_tilde[j]):
            continue
        total_m += int(m[j])
        bound += t_tilde[j] * m[j]
        if total_m >= problem.L:
            bound -= tau[j] * (total_m - problem.L)
            return float(bound)
    return float("inf")  # infeasible placement


def lower_bound_client(problem: Problem, client: int) -> float:
    """(35): block-by-block relaxation with m̄_j = min(⌊M_j/(s_m+s_c)⌋, L)."""
    m_bar = np.minimum(
        np.floor(problem.mem() / (problem.s_m + problem.s_c)),
        problem.L).astype(int)
    ok = m_bar > 0
    if not ok.any():
        return float("inf")
    t = np.full(problem.n_servers, np.inf)
    t[ok] = problem.tau()[ok] + problem.rtt_token[client][ok] / m_bar[ok]
    order = np.argsort(t, kind="stable")
    remaining = problem.L
    total = 0.0
    for j in order:
        if not np.isfinite(t[j]) or remaining <= 0:
            break
        take = min(int(m_bar[j]), remaining)
        total += t[j] * take
        remaining -= take
    return float(total) if remaining <= 0 else float("inf")


def lower_bound(problem: Problem,
                requests_per_client: Optional[np.ndarray] = None) -> float:
    """T^o ≥ (1/|R|) Σ_c |R_c| T_c^o."""
    w = (np.ones(problem.n_clients) if requests_per_client is None
         else np.asarray(requests_per_client, float))
    vals = np.array([lower_bound_client(problem, c)
                     for c in range(problem.n_clients)])
    return float((w * vals).sum() / w.sum())


def approximation_ratio(problem: Problem, R: int) -> float:
    """Upper/lower bound ratio for CG-BPRR (B.4)."""
    ub = cg_upper_bound(problem, R)
    lb = lower_bound(problem)
    return float(ub / lb) if np.isfinite(ub) and lb > 0 else float("inf")
