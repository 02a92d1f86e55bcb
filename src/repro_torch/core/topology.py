"""Logical routing topology G (paper §3.1, Fig. 4) and Lemma 3.1 feasibility.

Nodes: S-client (one per routing query), servers, D-client.  Internally we
track per-node "progress" e = #blocks served after visiting the node
(0-based): S-client e=0; server j has hosted range [a_j, a_j+m_j); edge
i→j is feasible  ⟺  a_j ≤ e_i ≤ a_j + m_j − 1  (Lemma 3.1), after which
e_j = a_j + m_j (the first server hosting a block processes it, §3.1).
D-client requires e = L.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.perf_model import Placement, Problem, Route

S_NODE = -1  # virtual S-client node id
D_NODE = -2  # virtual D-client node id


def edge_feasible(a: np.ndarray, m: np.ndarray, e_i: int, j: int) -> bool:
    """Lemma 3.1: can a session with progress e_i continue at server j?"""
    return bool(m[j] > 0 and a[j] <= e_i <= a[j] + m[j] - 1)


def route_feasible(placement: Placement, L: int,
                   servers: Tuple[int, ...]) -> bool:
    """Check a full chain via Lemma 3.1 (induction in the paper's proof)."""
    a, m = placement.a, placement.m
    e = 0
    for j in servers:
        if not edge_feasible(a, m, e, j):
            return False
        e = a[j] + m[j]
    return e == L


def route_blocks(placement: Placement, servers: Tuple[int, ...]) -> Route:
    """k_j per hop for a feasible chain (max(a_j, e_i) .. a_j+m_j)."""
    a, m = placement.a, placement.m
    e = 0
    ks = []
    for j in servers:
        e_new = a[j] + m[j]
        ks.append(int(e_new - e))
        e = e_new
    return Route(servers=tuple(servers), blocks=tuple(ks))


@dataclass
class RoutingGraph:
    """Feasible routing DAG for one placement (shared across clients).

    Nodes 0..S-1 are servers; S_NODE/D_NODE virtual.  Topological order is
    by end-progress e_j = a_j + m_j (strictly increases along feasible
    edges).  ``succ[j]`` lists feasible successor servers of j.
    """

    placement: Placement
    L: int
    order: np.ndarray  # server ids sorted by e_j
    first: np.ndarray  # servers reachable from S (host block 0)
    last: np.ndarray  # servers that can end a chain (e_j == L)
    succ: List[np.ndarray]

    @staticmethod
    def build(placement: Placement, L: int) -> "RoutingGraph":
        a, m = placement.a, placement.m
        n = len(a)
        e = a + m
        active = m > 0
        first = np.where(active & (a == 0))[0]
        last = np.where(active & (e == L))[0]
        succ = []
        for i in range(n):
            if not active[i]:
                succ.append(np.empty(0, int))
                continue
            ok = active & (a <= e[i]) & (e[i] <= e - 1)
            succ.append(np.where(ok)[0])
        order = np.argsort(e, kind="stable")
        return RoutingGraph(placement, L, order, first, last, succ)
