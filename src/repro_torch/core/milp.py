"""MILP formulations solved with scipy.optimize.milp (HiGHS) — a copy of
the reference's ``repro/core/milp.py``.

* ``solve_bprr_milp``     — the full joint MILP (13) with the bilinear-term
  linearisation (31)–(34).  Exponential in general (Thm 3.2: NP-hard via
  PARTITION), so used on small instances for optimality-gap studies/tests.
* ``solve_routing_ilp``   — the routing subproblem (16) given a placement
  ('Optimized RR' ablation, §4.3).
* ``solve_online_routing``— the per-request online MILP (21) with the
  waiting variable t^W (the paper solves this with Gurobi; HiGHS here).
* ``brute_force_bprr``    — exhaustive optimum for tiny instances (tests).

Indexing note: this module uses the paper's 1-based block encoding
(a_j, m_j ∈ [L]; S-client a=0,m=1; D-client a=L+1,m=1) and converts to the
0-based ``Placement`` at the boundary.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp

from repro_torch.core.perf_model import Placement, Problem, Route
from repro_torch.core.routing import edge_cost_matrix
from repro_torch.core.topology import RoutingGraph, route_blocks


@dataclass
class MILPResult:
    status: int
    objective: float
    placement: Optional[Placement]
    routes: Optional[List[Route]]
    message: str = ""


def solve_bprr_milp(problem: Problem, client_of_request: List[int],
                    time_limit: float = 120.0) -> MILPResult:
    """Joint BPRR MILP (13).  Requests r have clients client_of_request[r]."""
    n = problem.n_servers
    R = len(client_of_request)
    L = problem.L
    tau = problem.tau()
    Lp1 = L + 1

    # ---- variable layout -------------------------------------------------
    # globals: a_j (n), m_j (n)
    # per request r:
    #   S-edges  (S->j): f, alpha(=a_j f), gamma(=m_j f)          3n vars
    #   mid edges (i->j), i != j: f, alpha, beta, gamma, delta    5n(n-1)
    #   D-edges  (j->D): f                                        n
    idx = {}
    pos = 0

    def add(name):
        nonlocal pos
        idx[name] = pos
        pos += 1

    for j in range(n):
        add(("a", j))
    for j in range(n):
        add(("m", j))
    for r in range(R):
        for j in range(n):
            add(("fS", r, j))
            add(("aS", r, j))
            add(("gS", r, j))
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                for v in ("f", "al", "be", "ga", "de"):
                    add((v, r, i, j))
        for j in range(n):
            add(("fD", r, j))
    nv = pos

    lb = np.zeros(nv)
    ub = np.full(nv, np.inf)
    integrality = np.zeros(nv)
    c = np.zeros(nv)
    for j in range(n):
        lb[idx[("a", j)]] = 1
        ub[idx[("a", j)]] = L
        integrality[idx[("a", j)]] = 1
        lb[idx[("m", j)]] = 1
        ub[idx[("m", j)]] = L
        integrality[idx[("m", j)]] = 1
    for key, p in idx.items():
        if key[0] in ("fS", "fD", "f"):
            ub[p] = 1
            integrality[p] = 1

    rows = []
    lo = []
    hi = []

    def row(coeffs: Dict[int, float], lo_v, hi_v):
        rows.append(coeffs)
        lo.append(lo_v)
        hi.append(hi_v)

    # ---- objective (13a) + constraints ------------------------------------
    for r in range(R):
        cl = client_of_request[r]
        for j in range(n):
            # S->j: e_S = 1 (1-based); k_j = a_j + m_j - 1
            c[idx[("fS", r, j)]] += problem.rtt_token[cl, j] - tau[j]
            c[idx[("aS", r, j)]] += tau[j]
            c[idx[("gS", r, j)]] += tau[j]
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                c[idx[("f", r, i, j)]] += problem.rtt_token[cl, j]
                c[idx[("al", r, i, j)]] += tau[j]
                c[idx[("ga", r, i, j)]] += tau[j]
                c[idx[("be", r, i, j)]] -= tau[j]
                c[idx[("de", r, i, j)]] -= tau[j]

        # flow conservation (13c)
        row({idx[("fS", r, j)]: 1.0 for j in range(n)}, 1, 1)
        row({idx[("fD", r, j)]: 1.0 for j in range(n)}, 1, 1)
        for j in range(n):
            coeffs = {idx[("fS", r, j)]: 1.0, idx[("fD", r, j)]: -1.0}
            for i in range(n):
                if i == j:
                    continue
                coeffs[idx[("f", r, i, j)]] = coeffs.get(
                    idx[("f", r, i, j)], 0.0) + 1.0
                coeffs[idx[("f", r, j, i)]] = coeffs.get(
                    idx[("f", r, j, i)], 0.0) - 1.0
            row(coeffs, 0, 0)

        for j in range(n):
            # S->j feasibility: a_j f <= 1  and  f <= a_j + m_j - 1
            row({idx[("aS", r, j)]: 1.0}, -np.inf, 1.0)  # alpha_Sj <= e_S=1
            row({idx[("fS", r, j)]: 1.0, idx[("a", j)]: -1.0,
                 idx[("m", j)]: -1.0}, -np.inf, -1.0)  # f <= a_j+m_j-1
            # D-edge feasibility: f_jD = 1 -> a_j + m_j = L+1
            row({idx[("fD", r, j)]: Lp1, idx[("a", j)]: -1.0,
                 idx[("m", j)]: -1.0}, -np.inf, 0.0)  # (L+1) f <= a_j+m_j
            row({idx[("fD", r, j)]: Lp1, idx[("a", j)]: 1.0,
                 idx[("m", j)]: 1.0}, -np.inf, 2 * Lp1)
            # linearisation for S-edge alpha=a_j f, gamma=m_j f (31)/(33)
            _linearize(row, idx, ("aS", r, j), ("fS", r, j), ("a", j), Lp1)
            _linearize(row, idx, ("gS", r, j), ("fS", r, j), ("m", j), Lp1)

        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                # (13e): alpha_ij <= a_i + m_i
                row({idx[("al", r, i, j)]: 1.0, idx[("a", i)]: -1.0,
                     idx[("m", i)]: -1.0}, -np.inf, 0.0)
                # (13f): beta + delta <= a_j + m_j - 1
                row({idx[("be", r, i, j)]: 1.0, idx[("de", r, i, j)]: 1.0,
                     idx[("a", j)]: -1.0, idx[("m", j)]: -1.0},
                    -np.inf, -1.0)
                # (31)-(34)
                _linearize(row, idx, ("al", r, i, j), ("f", r, i, j),
                           ("a", j), Lp1)
                _linearize(row, idx, ("be", r, i, j), ("f", r, i, j),
                           ("a", i), Lp1)
                _linearize(row, idx, ("ga", r, i, j), ("f", r, i, j),
                           ("m", j), Lp1)
                _linearize(row, idx, ("de", r, i, j), ("f", r, i, j),
                           ("m", i), Lp1)

    # block range validity (13d): a_j + m_j - 1 <= L
    for j in range(n):
        row({idx[("a", j)]: 1.0, idx[("m", j)]: 1.0}, -np.inf, L + 1)

    # memory (13b)
    for j in range(n):
        coeffs = {idx[("m", j)]: float(problem.s_m)}
        for r in range(R):
            coeffs[idx[("aS", r, j)]] = coeffs.get(idx[("aS", r, j)], 0.0) \
                + problem.s_c
            coeffs[idx[("gS", r, j)]] = coeffs.get(idx[("gS", r, j)], 0.0) \
                + problem.s_c
            coeffs[idx[("fS", r, j)]] = coeffs.get(idx[("fS", r, j)], 0.0) \
                - problem.s_c  # k = a_j + m_j - e_S, e_S = 1
            for i in range(n):
                if i == j:
                    continue
                coeffs[idx[("al", r, i, j)]] = problem.s_c
                coeffs[idx[("ga", r, i, j)]] = problem.s_c
                coeffs[idx[("be", r, i, j)]] = -problem.s_c
                coeffs[idx[("de", r, i, j)]] = -problem.s_c
        row(coeffs, -np.inf, float(problem.servers[j].mem_bytes))

    A = np.zeros((len(rows), nv))
    for rr, coeffs in enumerate(rows):
        for p, v in coeffs.items():
            A[rr, p] = v
    res = milp(c=c, constraints=LinearConstraint(A, lo, hi),
               integrality=integrality, bounds=Bounds(lb, ub),
               options={"time_limit": time_limit})
    if not res.success:
        return MILPResult(status=res.status, objective=np.inf,
                          placement=None, routes=None, message=res.message)
    x = res.x
    a1 = np.array([int(round(x[idx[("a", j)]])) for j in range(n)])
    m1 = np.array([int(round(x[idx[("m", j)]])) for j in range(n)])
    placement = Placement(a=a1 - 1, m=m1)  # to 0-based
    routes = []
    for r in range(R):
        chain = []
        cur = None
        for j in range(n):
            if x[idx[("fS", r, j)]] > 0.5:
                cur = j
                break
        while cur is not None:
            chain.append(cur)
            nxt = None
            for j in range(n):
                if j != cur and x[idx[("f", r, cur, j)]] > 0.5:
                    nxt = j
                    break
            cur = nxt
        routes.append(route_blocks(placement, tuple(chain)))
    return MILPResult(status=0, objective=float(res.fun),
                      placement=placement, routes=routes)


def _linearize(row, idx, prod_key, f_key, var_key, big):
    """(31)-style: prod = var * f for binary f, var in [0, big]."""
    p, f, v = idx[prod_key], idx[f_key], idx[var_key]
    row({p: 1.0, f: -float(big)}, -np.inf, 0.0)  # prod <= big f
    row({p: 1.0, v: -1.0}, -np.inf, 0.0)  # prod <= var
    row({v: 1.0, f: float(big), p: -1.0}, -np.inf, float(big))  # prod >= ...


# ---------------------------------------------------------------------------
# Routing-only ILP (16) — 'Optimized RR'
# ---------------------------------------------------------------------------


def solve_routing_ilp(problem: Problem, placement: Placement,
                      client_of_request: List[int],
                      time_limit: float = 60.0) -> Tuple[float, List[Route]]:
    """(16): min Σ t^c_ij f  s.t. memory + flow conservation, given (a,m)."""
    graph = RoutingGraph.build(placement, problem.L)
    n = problem.n_servers
    a, m = placement.a, placement.m
    e = a + m
    R = len(client_of_request)
    edges = []  # (i, j) with i == n meaning S-client
    for j in graph.first:
        edges.append((n, int(j)))
    for i in range(n):
        for j in graph.succ[i]:
            edges.append((i, int(j)))
    dedges = [int(j) for j in graph.last]
    ne = len(edges)
    nv = R * (ne + len(dedges))

    c = np.zeros(nv)
    costs = {cl: edge_cost_matrix(problem, placement, cl)
             for cl in set(client_of_request)}

    def fidx(r, k):
        return r * (ne + len(dedges)) + k

    rows, lo, hi = [], [], []
    for r in range(R):
        cm = costs[client_of_request[r]]
        for k, (i, j) in enumerate(edges):
            c[fidx(r, k)] = cm[i, j]
        # flow conservation
        coeffs = {fidx(r, k): 1.0 for k, (i, j) in enumerate(edges) if i == n}
        rows.append(coeffs)
        lo.append(1)
        hi.append(1)
        coeffs = {fidx(r, ne + k): 1.0 for k in range(len(dedges))}
        rows.append(coeffs)
        lo.append(1)
        hi.append(1)
        for v in range(n):
            if m[v] <= 0:
                continue
            coeffs = {}
            for k, (i, j) in enumerate(edges):
                if j == v:
                    coeffs[fidx(r, k)] = coeffs.get(fidx(r, k), 0) + 1.0
                if i == v:
                    coeffs[fidx(r, k)] = coeffs.get(fidx(r, k), 0) - 1.0
            for k, j in enumerate(dedges):
                if j == v:
                    coeffs[fidx(r, ne + k)] = coeffs.get(
                        fidx(r, ne + k), 0) - 1.0
            rows.append(coeffs)
            lo.append(0)
            hi.append(0)
    # memory (16b)
    for v in range(n):
        if m[v] <= 0:
            continue
        coeffs = {}
        for r in range(R):
            for k, (i, j) in enumerate(edges):
                if j == v:
                    k_blocks = e[v] - (0 if i == n else e[i])
                    coeffs[fidx(r, k)] = problem.s_c * float(k_blocks)
        if coeffs:
            rows.append(coeffs)
            lo.append(-np.inf)
            hi.append(float(problem.servers[v].mem_bytes
                            - problem.s_m * m[v]))
    A = np.zeros((len(rows), nv))
    for rr, coeffs in enumerate(rows):
        for p, vv in coeffs.items():
            A[rr, p] = vv
    res = milp(c=c, constraints=LinearConstraint(A, lo, hi),
               integrality=np.ones(nv),
               bounds=Bounds(np.zeros(nv), np.ones(nv)),
               options={"time_limit": time_limit})
    if not res.success:
        return np.inf, []
    routes = []
    for r in range(R):
        nxt = {}
        start = None
        for k, (i, j) in enumerate(edges):
            if res.x[fidx(r, k)] > 0.5:
                if i == n:
                    start = j
                else:
                    nxt[i] = j
        chain = []
        cur = start
        while cur is not None:
            chain.append(cur)
            cur = nxt.get(cur)
        routes.append(route_blocks(placement, tuple(chain)))
    return float(res.fun), routes


def solve_online_routing(problem: Problem, placement: Placement, client: int,
                         waiting: np.ndarray,
                         time_limit: float = 10.0
                         ) -> Tuple[Optional[Route], float]:
    """Per-request online MILP (21): min t^W + l_max Σ t^c_ij f_ij with
    t^W ≥ t^W_ij f_ij.  (The simulator's 'Optimized RR' arm.)"""
    graph = RoutingGraph.build(placement, problem.L)
    n = problem.n_servers
    edges = [(n, int(j)) for j in graph.first]
    for i in range(n):
        for j in graph.succ[i]:
            edges.append((i, int(j)))
    dedges = [int(j) for j in graph.last]
    ne = len(edges)
    nv = ne + len(dedges) + 1  # + t^W
    TW = nv - 1
    cm = edge_cost_matrix(problem, placement, client)
    lmax = float(problem.workload.l_out)
    c = np.zeros(nv)
    c[TW] = 1.0
    for k, (i, j) in enumerate(edges):
        c[k] = lmax * cm[i, j]
    rows, lo, hi = [], [], []
    rows.append({k: 1.0 for k, (i, j) in enumerate(edges) if i == n})
    lo.append(1)
    hi.append(1)
    rows.append({ne + k: 1.0 for k in range(len(dedges))})
    lo.append(1)
    hi.append(1)
    for v in range(n):
        if placement.m[v] <= 0:
            continue
        coeffs = {}
        for k, (i, j) in enumerate(edges):
            if j == v:
                coeffs[k] = coeffs.get(k, 0) + 1.0
            if i == v:
                coeffs[k] = coeffs.get(k, 0) - 1.0
        for k, j in enumerate(dedges):
            if j == v:
                coeffs[ne + k] = coeffs.get(ne + k, 0) - 1.0
        rows.append(coeffs)
        lo.append(0)
        hi.append(0)
    for k, (i, j) in enumerate(edges):
        w = waiting[i, j]
        if not np.isfinite(w):
            # edge unusable now: forbid
            rows.append({k: 1.0})
            lo.append(0)
            hi.append(0)
        elif w > 0:
            rows.append({TW: 1.0, k: -float(w)})
            lo.append(0)
            hi.append(np.inf)
    A = np.zeros((len(rows), nv))
    for rr, coeffs in enumerate(rows):
        for p, vv in coeffs.items():
            A[rr, p] = vv
    ub = np.ones(nv)
    ub[TW] = np.inf
    integ = np.ones(nv)
    integ[TW] = 0
    res = milp(c=c, constraints=LinearConstraint(A, lo, hi),
               integrality=integ, bounds=Bounds(np.zeros(nv), ub),
               options={"time_limit": time_limit})
    if not res.success:
        return None, np.inf
    nxt = {}
    start = None
    for k, (i, j) in enumerate(edges):
        if res.x[k] > 0.5:
            if i == n:
                start = j
            else:
                nxt[i] = j
    chain = []
    cur = start
    while cur is not None:
        chain.append(cur)
        cur = nxt.get(cur)
    return route_blocks(placement, tuple(chain)), float(res.fun)


# ---------------------------------------------------------------------------
# Brute force (tests only)
# ---------------------------------------------------------------------------


def brute_force_bprr(problem: Problem, client_of_request: List[int]
                     ) -> Tuple[float, Optional[Placement]]:
    """Exhaustive search over placements (m_j >= 1) + optimal routing via
    the routing ILP.  Exponential — tiny instances only."""
    n = problem.n_servers
    L = problem.L
    best = (np.inf, None)
    spans = [(a, m_) for m_ in range(1, L + 1) for a in range(L - m_ + 1)]
    for combo in itertools.product(spans, repeat=n):
        a = np.array([s[0] for s in combo])
        m = np.array([s[1] for s in combo])
        if (problem.s_m * m > problem.mem()).any():
            continue
        placement = Placement(a=a, m=m)
        if not placement.feasible_cover(L):
            continue
        obj, routes = solve_routing_ilp(problem, placement,
                                        client_of_request)
        if obj < best[0]:
            best = (obj, placement)
    return best
