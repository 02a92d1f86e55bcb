"""Block placement algorithms.

* ``cg_bp``        — Conservative Greedy Block Placement (Alg. 1 lines 1–8):
                     conservative m_j, greedy ordering by amortised inference
                     time t̃_j = τ_j + t_*j/m_j, need-of-service via (C_b, T_b).
* ``petals_bp``    — the PETALS heuristic [8]/[16]: each joining server takes
                     m_j = ⌊(M_j − reserve)/s_m⌋ blocks and picks the most
                     under-served contiguous span by a throughput metric.
* variants         — 'Optimized Order' / 'Optimized Number' ablations (§4.3).
* ``auto_R``       — the |R| configuration rule after Corollary 3.6 with the
                     feasibility bound (18)/(19).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.perf_model import Placement, Problem


@dataclass
class CGInfo:
    order: np.ndarray  # servers in increasing t̃_j
    t_tilde: np.ndarray
    capacity: np.ndarray  # f̄_j (15)
    K: int  # servers needed to cover all blocks (Thm 3.5)
    feasible: bool


def conservative_m(problem: Problem, R: int) -> np.ndarray:
    """Line 1 of Alg. 1:  m_j = min(⌊M_j/(s_m + s_c·R)⌋, L)."""
    denom = problem.s_m + problem.s_c * R
    return np.minimum(np.floor(problem.mem() / denom), problem.L).astype(int)


def capacity(problem: Problem, m: np.ndarray) -> np.ndarray:
    """f̄_j (15): concurrent sessions guaranteed to fit beside m_j blocks."""
    with np.errstate(divide="ignore", invalid="ignore"):
        cap = np.floor((problem.mem() - problem.s_m * m)
                       / (problem.s_c * np.maximum(m, 1)))
    cap[m == 0] = 0
    return np.maximum(cap, 0).astype(np.int64)


def amortized_time(problem: Problem, m: np.ndarray) -> np.ndarray:
    """t̃_j (14) = τ_j + t_*j / m_j  (inf for unusable servers)."""
    t = np.full(problem.n_servers, np.inf)
    ok = m > 0
    t[ok] = problem.tau()[ok] + problem.t_star()[ok] / m[ok]
    return t


def cg_bp(problem: Problem, R: int) -> Tuple[Placement, CGInfo]:
    """Alg. 1 lines 1–8 (CG-BP)."""
    L = problem.L
    m = conservative_m(problem, R)
    cap = capacity(problem, m)
    t_tilde = amortized_time(problem, m)
    order = np.argsort(t_tilde, kind="stable")

    t0 = (np.nanmax(t_tilde[np.isfinite(t_tilde)]) + 1.0
          if np.isfinite(t_tilde).any() else 1.0)
    C = np.zeros(L, dtype=np.int64)  # C_b: capacity covering block b
    T = np.full(L, t0 * R, dtype=float)  # T_b: total amortised time on b
    a = np.zeros(problem.n_servers, dtype=int)

    K = 0
    covered = False
    for rank, j in enumerate(order):
        mj = int(m[j])
        if mj <= 0:
            continue
        n_starts = L - mj + 1
        if (C < R).any():
            # line 5: contiguous span with max Σ T_b among spans containing
            # at least one under-served block; ties -> smallest start index.
            span_T = np.convolve(T, np.ones(mj), mode="valid")  # Σ over span
            under = (C < R).astype(float)
            has_under = np.convolve(under, np.ones(mj), mode="valid") > 0
            span_T = np.where(has_under, span_T, -np.inf)
            aj = int(np.argmax(span_T))  # argmax returns first max ✓
        else:
            # line 6: span with lexicographically smallest sorted capacities
            best, aj = None, 0
            for s in range(n_starts):
                key = tuple(np.sort(C[s: s + mj]))
                if best is None or key < best:
                    best, aj = key, s
        a[j] = aj
        span = slice(aj, aj + mj)
        fj = int(cap[j])
        T[span] -= (t0 - t_tilde[j]) * np.minimum(
            np.maximum(R - C[span], 0), fj)
        C[span] += fj
        if not covered:
            K = rank + 1
            cov = np.zeros(L, bool)
            for jj in order[: rank + 1]:
                if m[jj] > 0:
                    cov[a[jj]: a[jj] + m[jj]] = True
            covered = bool(cov.all())
    placement = Placement(a=a, m=m)
    feasible = placement.feasible_cover(L)
    info = CGInfo(order=order, t_tilde=t_tilde, capacity=cap,
                  K=K if feasible else -1, feasible=feasible)
    return placement, info


# ---------------------------------------------------------------------------
# |R| configuration (after Corollary 3.6)
# ---------------------------------------------------------------------------


def cg_feasible_R(problem: Problem, R: int) -> bool:
    """Feasibility condition (18)."""
    return int(conservative_m(problem, R).sum()) >= problem.L


def max_feasible_R(problem: Problem) -> int:
    """Upper bound (19) refined by binary search on (18)."""
    hi = int((problem.mem().sum() - problem.s_m
              * (problem.L + problem.n_servers))
             // (problem.s_c * (problem.L + problem.n_servers)))
    hi = max(hi, 0)
    # (19) is sufficient, not tight — extend by doubling then bisect on (18)
    lo = 0
    probe = max(hi, 1)
    while cg_feasible_R(problem, probe):
        lo = probe
        probe *= 2
        if probe > 1 << 24:
            break
    lo_ok, hi_bad = lo, probe
    while lo_ok + 1 < hi_bad:
        mid = (lo_ok + hi_bad) // 2
        if cg_feasible_R(problem, mid):
            lo_ok = mid
        else:
            hi_bad = mid
    return lo_ok


def auto_R(problem: Problem, arrival_rate: float,
           expected_session_s: float) -> int:
    """mean + std of Poisson arrivals during a session, capped by (18)/(19)."""
    mean = arrival_rate * expected_session_s
    target = int(np.ceil(mean + np.sqrt(max(mean, 1e-9))))
    return max(1, min(target, max_feasible_R(problem)))


# ---------------------------------------------------------------------------
# PETALS baseline placement [8]/[16] + ablation variants (§4.3)
# ---------------------------------------------------------------------------


def petals_m(problem: Problem, reserve_fraction: float = 0.05,
             reserve_bytes: float = 1 << 30) -> np.ndarray:
    """PETALS block counts: fixed cache reserve, ignore concurrency."""
    mem = problem.mem()
    usable = mem - reserve_bytes - reserve_fraction * mem
    return np.clip(np.floor(usable / problem.s_m), 0, problem.L).astype(int)


def petals_bp(problem: Problem, join_order: Optional[Sequence[int]] = None,
              m: Optional[np.ndarray] = None) -> Placement:
    """Sequential joins; each server takes the most under-served span as
    measured by per-block total throughput (1/τ_j per hosting server)."""
    L = problem.L
    m = petals_m(problem) if m is None else m
    order = (np.arange(problem.n_servers) if join_order is None
             else np.asarray(join_order))
    thr = 1.0 / np.maximum(problem.tau(), 1e-9)  # tokens/s per block
    block_thr = np.zeros(L)
    a = np.zeros(problem.n_servers, int)
    for j in order:
        mj = int(m[j])
        if mj <= 0:
            continue
        # lexicographically smallest sorted throughput tuple = weakest span
        best, aj = None, 0
        for s in range(L - mj + 1):
            key = tuple(np.sort(block_thr[s: s + mj]))
            if best is None or key < best:
                best, aj = key, s
        a[j] = aj
        block_thr[aj: aj + mj] += thr[j]
    return Placement(a=a, m=m)


def optimized_order_bp(problem: Problem, R: int) -> Placement:
    """'Optimized Order': PETALS placement, servers joining in CG speed order."""
    m = conservative_m(problem, R)
    t_tilde = amortized_time(problem, m)
    order = np.argsort(t_tilde, kind="stable")
    return petals_bp(problem, join_order=order, m=petals_m(problem))


def optimized_number_bp(problem: Problem, R: int) -> Placement:
    """'Optimized Number': PETALS span choice with CG's conservative m_j."""
    return petals_bp(problem, m=conservative_m(problem, R))
