"""Request routing.

* ``shortest_path_route``  — optimal routing given a feasible placement
  (Lemma 3.4): exact DP over the feasible routing DAG in e_j order.
* ``ws_rr``                — Waiting-penalised Shortest-path Request Routing
  (§3.3.2): link cost  t^W_ij(t) + l_max · t^c_ij  with the waiting time from
  the tracked server state, eq. (20).
* ``petals_route``         — the PETALS client heuristic [16]: Dijkstra over
  (progress, server) states with latency+throughput edge weights, ignoring
  memory/waiting (the paper's key comparison point).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.perf_model import (Placement, Problem, Route,
                                   route_per_token_time, route_prefill_time)
from repro_torch.core.topology import RoutingGraph, route_blocks


def edge_cost_matrix(problem: Problem, placement: Placement,
                     client: int, avg_over_tokens: bool = False) -> np.ndarray:
    """cost[i, j] = t^c_ij by eq (4) (or eq (8) if avg_over_tokens), for the
    *maximum* processed blocks k_j = e_j − e_i implied by hop (i, j); the
    S-client row is index n (progress 0)."""
    a, m = placement.a, placement.m
    n = problem.n_servers
    e = a + m
    tau = problem.tau()
    lw = problem.workload
    cost = np.full((n + 1, n), np.inf)
    e_from = np.concatenate([e, [0]])  # progress after i (last row = S)
    cumw = problem.llm.tau_cumweights()  # per-family block weights (W[e])
    for row in range(n + 1):
        # weighted blocks processed at j when reached from row; equals
        # e - e_from[row] under the paper's uniform weights
        k = cumw[e] - cumw[e_from[row]]
        t_tok = problem.rtt_token[client] + tau * k
        if avg_over_tokens:
            t_pre = problem.rtt_prefill[client] + problem.tau_prefill() * k
            c = t_pre / lw.l_out + (lw.l_out - 1) / lw.l_out * t_tok
        else:
            c = t_tok
        cost[row] = c
    return cost


class RouteCostCache:
    """Memoized placement-derived routing inputs, shared across arrivals.

    ``edge_cost_matrix`` and ``RoutingGraph.build`` depend only on
    (problem, placement, client) — yet the online controller used to
    rebuild both on EVERY arriving request.  This cache computes the
    routing graph once, one edge-cost matrix per (client, avg_over_tokens),
    and the eq. (20) slot capacities once, and hands them to
    ``shortest_path_route`` / ``ws_rr`` / ``edge_waiting_times`` via their
    ``cache=`` parameter.  The holder must invalidate by REPLACING the
    cache whenever the placement, the RTT matrices, server capacities or
    τ values change (``OnlineBPRR.replace_servers`` does exactly that);
    per-arrival state (waiting times) is never cached here.

    ``suspicion``: optional ``{server: penalty_seconds}`` map — every edge
    INTO a suspected server carries the additive per-token penalty, so
    WS-RR (and the memoized base decisions) steer routes away from
    flapping servers without forbidding them outright.  The penalty
    biases route SELECTION only; ``route_times`` (the billed eq. (1)
    clock of whatever route is chosen) never includes it.
    """

    def __init__(self, problem: Problem, placement: Placement,
                 suspicion: Optional[Dict[int, float]] = None):
        self.problem = problem
        self.placement = placement
        self.suspicion = dict(suspicion) if suspicion else {}
        self.graph = RoutingGraph.build(placement, problem.L)
        # eq. (20) inputs reused by edge_waiting_times on every arrival
        m = placement.m
        self.total_slots = np.floor((problem.mem() - problem.s_m * m)
                                    / problem.s_c)
        self._cost: Dict[Tuple[int, bool], np.ndarray] = {}
        self._route_times: Dict[Tuple[int, Tuple[int, ...]],
                                Tuple[float, float]] = {}
        self._w0: Optional[np.ndarray] = None
        self._kthr: Optional[np.ndarray] = None
        self._base_ws_rr: Optional[List[Tuple[Optional[Route], float]]] = None
        self._petals: Dict[int, Optional[Route]] = {}

    def cost(self, client: int, avg_over_tokens: bool = False) -> np.ndarray:
        key = (int(client), bool(avg_over_tokens))
        if key not in self._cost:
            c = edge_cost_matrix(
                self.problem, self.placement, client, avg_over_tokens)
            for j, pen in self.suspicion.items():
                if 0 <= int(j) < c.shape[1]:
                    c[:, int(j)] += float(pen)
            self._cost[key] = c
        return self._cost[key]

    def route_times(self, client: int, route: Route) -> Tuple[float, float]:
        """(prefill, per_token) for ``route`` — eq. (1) terms, which depend
        only on (problem, route, client), never on the arrival time."""
        key = (int(client), route.servers)
        hit = self._route_times.get(key)
        if hit is None:
            hit = (route_prefill_time(self.problem, route, client),
                   route_per_token_time(self.problem, route, client))
            self._route_times[key] = hit
        return hit

    def empty_waiting(self) -> np.ndarray:
        """The eq. (20) wait matrix of the EMPTY system: entries are 0 where
        k_j = e_j − e_i fits in server j's total slots and inf where the hop
        can never fit (so those edges stay forbidden at any load)."""
        if self._w0 is None:
            self._w0 = edge_waiting_times(
                self.problem, self.placement, {}, cache=self)
        return self._w0

    @property
    def zero_wait_kthr(self) -> np.ndarray:
        """Per-server free-slot threshold for the contention-free fast path:
        while ``free_j >= zero_wait_kthr[j]`` on EVERY server, the full
        eq. (20) wait matrix equals :meth:`empty_waiting` elementwise
        (finite-capacity entries need ``free >= k_needed`` to stay at 0;
        entries with ``k_needed > total_slots`` are inf at any load)."""
        if self._kthr is None:
            a, m = self.placement.a, self.placement.m
            e = a + m
            e_from = np.concatenate([e, [0]])
            k_needed = e[None, :] - e_from[:, None]  # (n+1, n)
            relevant = ((k_needed > 0) & (k_needed <= self.total_slots[None, :])
                        & (m > 0)[None, :])
            self._kthr = np.where(relevant.any(axis=0),
                                  np.where(relevant, k_needed, 0).max(axis=0),
                                  0).astype(float)
        return self._kthr

    def base_ws_rr(self, client: int) -> Tuple[Optional[Route], float]:
        """WS-RR decision of the EMPTY system for ``client`` — exactly what
        :func:`ws_rr` returns whenever the wait matrix equals
        :meth:`empty_waiting`.  All clients' DPs are batched in one
        vectorized pass (same order / tie-breaks as ``_dag_shortest``)."""
        if self._base_ws_rr is None:
            w0 = self.empty_waiting()
            lmax = float(self.problem.workload.l_out)
            costs = np.stack([w0 + lmax * self.cost(c)
                              for c in range(self.problem.n_clients)])
            dist, parent = _dag_shortest_batch(self.graph, costs)
            self._base_ws_rr = [
                _extract_route(self.graph, self.problem, self.placement,
                               dist[c], parent[c])
                for c in range(self.problem.n_clients)]
        return self._base_ws_rr[int(client)]

    def petals(self, client: int) -> Optional[Route]:
        """Memoized :func:`petals_route` — arrival-invariant by construction
        (no waiting/memory terms in the PETALS heuristic)."""
        c = int(client)
        if c not in self._petals:
            self._petals[c] = petals_route(self.problem, self.placement, c)
        return self._petals[c]


def _dag_shortest(graph: RoutingGraph, cost: np.ndarray,
                  extra: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """DP over servers in e_j order.  cost has S-client at row n.

    extra[j]: additive per-node cost (e.g. waiting penalties folded in by the
    caller through ``cost`` directly; kept for clarity).  Returns
    (dist, parent) with parent = n for S-client predecessor.
    """
    a, m = graph.placement.a, graph.placement.m
    n = len(a)
    e = a + m
    dist = np.full(n, np.inf)
    parent = np.full(n, -100, int)
    first = set(graph.first.tolist())
    for j in graph.order:
        if m[j] <= 0:
            continue
        if j in first:
            d = cost[n, j]
            if d < dist[j]:
                dist[j] = d
                parent[j] = n
        # predecessors i with a_j <= e_i <= e_j - 1
        ok = (m > 0) & (a[j] <= e) & (e <= e[j] - 1) & np.isfinite(dist)
        if ok.any():
            cand = dist[ok] + cost[np.where(ok)[0], j]
            b = int(np.argmin(cand))
            if cand[b] < dist[j]:
                dist[j] = cand[b]
                parent[j] = int(np.where(ok)[0][b])
    return dist, parent


def _dag_shortest_batch(graph: RoutingGraph, costs: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """``_dag_shortest`` vectorized over a leading batch axis (one cost
    matrix per client): same e_j relaxation order, same first-min
    tie-breaks, so per-client results are exactly the scalar DP's."""
    a, m = graph.placement.a, graph.placement.m
    n = len(a)
    e = a + m
    nb = costs.shape[0]
    dist = np.full((nb, n), np.inf)
    parent = np.full((nb, n), -100, int)
    first = set(graph.first.tolist())
    rows = np.arange(nb)
    for j in graph.order:
        j = int(j)
        if m[j] <= 0:
            continue
        if j in first:
            d = costs[:, n, j]
            upd = d < dist[:, j]
            dist[upd, j] = d[upd]
            parent[upd, j] = n
        ok = (m > 0) & (a[j] <= e) & (e <= e[j] - 1)
        if ok.any():
            # non-ok / unreachable predecessors masked to inf: argmin then
            # picks the first (lowest-index) minimum exactly like the
            # scalar DP's subset argmin
            cand = np.where(ok[None, :] & np.isfinite(dist),
                            dist + costs[:, :n, j], np.inf)
            b = np.argmin(cand, axis=1)
            cb = cand[rows, b]
            upd = cb < dist[:, j]
            dist[upd, j] = cb[upd]
            parent[upd, j] = b[upd]
    return dist, parent


def _extract_route(graph: RoutingGraph, problem: Problem,
                   placement: Placement, dist: np.ndarray, parent: np.ndarray
                   ) -> Tuple[Optional[Route], float]:
    """Walk the DP parents back from the best terminal server (shared by the
    scalar and batched DPs so route extraction tie-breaks identically)."""
    if len(graph.last) == 0:
        return None, np.inf
    lasts = graph.last[np.isfinite(dist[graph.last])]
    if len(lasts) == 0:
        return None, np.inf
    end = int(lasts[np.argmin(dist[lasts])])
    chain = [end]
    while parent[chain[-1]] != problem.n_servers:
        chain.append(int(parent[chain[-1]]))
        if len(chain) > problem.n_servers + 1:
            return None, np.inf
    chain.reverse()
    return route_blocks(placement, tuple(chain)), float(dist[end])


def shortest_path_route(problem: Problem, placement: Placement, client: int,
                        avg_over_tokens: bool = False,
                        waiting: Optional[np.ndarray] = None,
                        l_max_weight: float = 1.0,
                        cache: Optional[RouteCostCache] = None
                        ) -> Tuple[Optional[Route], float]:
    """Optimal feasible route for ``client`` (Lemma 3.4).

    ``waiting``: optional (n+1, n) per-edge waiting times t^W_ij(t) — when
    given, edge cost becomes  t^W_ij + l_max_weight * t^c_ij  (WS-RR).
    ``cache``: optional :class:`RouteCostCache` for the SAME (problem,
    placement) — skips rebuilding the routing graph and edge-cost matrix
    per call (the online-controller fast path).
    Returns (route, path_cost); (None, inf) if no feasible chain exists.
    """
    if cache is not None:
        graph, cost = cache.graph, cache.cost(client, avg_over_tokens)
    else:
        graph = RoutingGraph.build(placement, problem.L)
        cost = edge_cost_matrix(problem, placement, client, avg_over_tokens)
    if waiting is not None:
        cost = waiting + l_max_weight * cost
    dist, parent = _dag_shortest(graph, cost)
    return _extract_route(graph, problem, placement, dist, parent)


# ---------------------------------------------------------------------------
# WS-RR: waiting times from server state, eq. (20)
# ---------------------------------------------------------------------------


@dataclass
class ServerState:
    """Active sessions at one server: (remaining_time, cache_blocks)."""

    remaining: List[float]
    blocks: List[int]

    def sorted_pairs(self):
        pairs = sorted(zip(self.remaining, self.blocks))
        return pairs


class ServerStateArrays:
    """Array-backed eq. (20) state: per-server ``remaining``/``blocks``
    numpy pairs that :func:`edge_waiting_times` / :func:`ws_rr` consume
    directly — the SoA twin of ``Dict[int, ServerState]`` for callers
    (the fast simulator loop, ``OnlineBPRR``) that already hold session
    state in arrays and should not rebuild Python dicts per arrival."""

    __slots__ = ("n_servers", "remaining", "blocks")

    def __init__(self, n_servers: int):
        self.n_servers = int(n_servers)
        self.remaining: List[Optional[np.ndarray]] = [None] * self.n_servers
        self.blocks: List[Optional[np.ndarray]] = [None] * self.n_servers

    def set(self, j: int, remaining: np.ndarray, blocks: np.ndarray):
        self.remaining[j] = remaining
        self.blocks[j] = blocks

    @staticmethod
    def from_states(states: Dict[int, ServerState],
                    n_servers: int) -> "ServerStateArrays":
        out = ServerStateArrays(n_servers)
        for j, st in states.items():
            if st.remaining:
                out.set(j, np.asarray(st.remaining, float),
                        np.asarray(st.blocks, np.int64))
        return out

    def to_states(self) -> Dict[int, ServerState]:
        return {j: ServerState(self.remaining[j].tolist(),
                               self.blocks[j].tolist())
                for j in range(self.n_servers)
                if self.remaining[j] is not None and len(self.remaining[j])}


def _waits_for_server(rem: Optional[np.ndarray], blk: Optional[np.ndarray],
                      slots_j: float, k_needed: np.ndarray) -> np.ndarray:
    """Vectorized eq. (20) column for one server: wait until ``k_needed``
    slots free, for every progress row at once.

    Exactness vs the dict branch: ``lexsort((blk, rem))`` reproduces
    Python's ``sorted(zip(remaining, blocks))`` order on (remaining, then
    blocks); the running free-slot totals are the same sequential sums
    (slot counts are exact small integers in float64); and
    ``searchsorted(frees, k, side="left")`` is exactly "first fk >= k"
    because ``frees`` is nondecreasing (blocks >= 0)."""
    if rem is None or len(rem) == 0:
        return np.where(k_needed <= slots_j, 0.0, np.inf)
    order = np.lexsort((blk, rem))
    rs = rem[order]
    bs = blk[order]
    free0 = slots_j - float(bs.sum())
    frees = np.concatenate([[free0], free0 + np.cumsum(bs)])
    times = np.concatenate([[0.0], rs])
    idx = np.searchsorted(frees, k_needed, side="left")
    return np.where(idx < len(frees),
                    times[np.minimum(idx, len(frees) - 1)], np.inf)


def edge_waiting_times(problem: Problem, placement: Placement,
                       states: Union[Dict[int, ServerState],
                                     ServerStateArrays],
                       cache: Optional[RouteCostCache] = None) -> np.ndarray:
    """t^W_ij(t) per eq (20) for every (i, j): time until server j frees
    enough cache slots for k_j = e_j − e_i new blocks.  ``cache`` reuses
    the precomputed slot capacities (the per-arrival state lives in
    ``states``, never in the cache).  ``states`` may be the classic
    ``Dict[int, ServerState]`` or a :class:`ServerStateArrays`; both
    produce bit-identical matrices (tests/test_simulator.py)."""
    a, m = placement.a, placement.m
    n = problem.n_servers
    e = a + m
    e_from = np.concatenate([e, [0]])
    total_slots = cache.total_slots if cache is not None else np.floor(
        (problem.mem() - problem.s_m * m)
        / problem.s_c)  # ⌊(M_j − s_m m_j)/s_c⌋
    wait = np.zeros((n + 1, n))
    if isinstance(states, ServerStateArrays):
        for j in range(n):
            if m[j] <= 0:
                continue
            wait[:, j] = _waits_for_server(
                states.remaining[j], states.blocks[j],
                total_slots[j], e[j] - e_from)
        return wait
    for j in range(n):
        if m[j] <= 0:
            continue
        st = states.get(j)
        pairs = st.sorted_pairs() if st else []
        used = float(sum(b for _, b in pairs))
        # free_after[k] = slots free once the k shortest-remaining sessions end
        free0 = total_slots[j] - used
        frees = [free0]
        for rem, blk in pairs:
            frees.append(frees[-1] + blk)
        times = [0.0] + [rem for rem, _ in pairs]
        for row in range(n + 1):
            k_needed = e[j] - e_from[row]
            w = np.inf
            for fk, tk in zip(frees, times):
                if fk >= k_needed:
                    w = tk
                    break
            wait[row, j] = w
    return wait


def ws_rr(problem: Problem, placement: Placement, client: int,
          states: Dict[int, ServerState],
          cache: Optional[RouteCostCache] = None
          ) -> Tuple[Optional[Route], float, float]:
    """Waiting-penalised shortest path (Alg. 2).  Returns
    (route, path_cost, waiting_time) where waiting_time = max hop wait.
    ``cache``: optional :class:`RouteCostCache` reusing the routing graph,
    edge costs and slot capacities across arrivals."""
    wait = edge_waiting_times(problem, placement, states, cache=cache)
    route, cost = shortest_path_route(
        problem, placement, client, avg_over_tokens=False, waiting=wait,
        l_max_weight=float(problem.workload.l_out), cache=cache)
    if route is None:
        return None, np.inf, np.inf
    # actual waiting for this route = max over hops (Cor. 3.7: the session
    # starts once every server on the path has freed enough cache slots)
    w = 0.0
    prev_row = problem.n_servers  # S-client row of the wait matrix
    for j in route.servers:
        w = max(w, wait[prev_row, j])
        prev_row = j
    return route, cost, float(w)


# ---------------------------------------------------------------------------
# PETALS routing heuristic [16]
# ---------------------------------------------------------------------------


def petals_route(problem: Problem, placement: Placement, client: int
                 ) -> Optional[Route]:
    """Dijkstra over (progress e, server) states with heuristic weights:
    edge weight = rtt_cj + k_j · τ_j   (latency + compute throughput), no
    memory/waiting modelling — per [16]'s routing."""
    a, m = placement.a, placement.m
    n = problem.n_servers
    e_arr = a + m
    tau = problem.tau()
    cumw = problem.llm.tau_cumweights()
    L = problem.L
    # Dijkstra over progress states
    best: Dict[int, float] = {0: 0.0}
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}
    pq = [(0.0, 0, -1)]  # (cost, progress, server reaching it)
    seen = set()
    while pq:
        d, e, i = heapq.heappop(pq)
        if (e, i) in seen:
            continue
        seen.add((e, i))
        if e == L:
            chain = []
            cur = (e, i)
            while cur[1] != -1:
                chain.append(cur[1])
                cur = parent[cur]
            chain.reverse()
            return route_blocks(placement, tuple(chain))
        ok = (m > 0) & (a <= e) & (e <= e_arr - 1)
        for j in np.where(ok)[0]:
            k = cumw[e_arr[j]] - cumw[e]
            nd = d + problem.rtt_token[client, j] + k * tau[j]
            state = (int(e_arr[j]), int(j))
            if state not in seen and nd < best.get(state, np.inf):
                best[state] = nd
                parent[state] = (e, i)
                heapq.heappush(pq, (nd, int(e_arr[j]), int(j)))
    return None


# ---------------------------------------------------------------------------
# Batched routing on the device (== numpy DP, tested)
# ---------------------------------------------------------------------------


def torch_shortest_paths(problem: Problem, placement: Placement,
                         waiting: Optional[np.ndarray] = None,
                         l_max_weight: float = 1.0, device="cuda"):
    """Min-plus DP for ALL clients at once on ``device`` — the counterpart of
    the reference's ``jax_shortest_paths``.

    Edge costs ``(C, n, n)`` (``l_max_weight · t^c_ij + waiting``, masked to
    the routing DAG's edges), ``n`` relaxations ``min_i(dist_i + cost_ij)``,
    masked to first and last hops.  float64, so that it equals the numpy DP
    (``shortest_path_route``).  Runs on the card unless the caller passes
    ``device="cpu"``.  Returns (dist (C,), choice (C,)) as tensors on
    ``device``: the best completion cost and the best terminal server per
    client (``inf`` where no route exists)."""
    import torch

    a, m = placement.a, placement.m
    n = problem.n_servers
    e = a + m
    active = m > 0
    adj = (active[None, :] & active[:, None]
           & (a[None, :] <= e[:, None]) & (e[:, None] <= e[None, :] - 1))
    cumw = problem.llm.tau_cumweights()
    # weighted blocks at j from i (== block count under uniform weights)
    k_edge = np.maximum(cumw[e][None, :] - cumw[e][:, None], 0)
    k_first = cumw[e]  # from the S-client (progress 0)
    if waiting is None:
        waiting = np.zeros((n + 1, n))

    def dev(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    rtt, tau = dev(problem.rtt_token), dev(problem.tau())
    cost = l_max_weight * (rtt[:, None, :] + tau * dev(k_edge)) \
        + dev(waiting[:n])
    cost = torch.where(dev(adj, torch.bool), cost, torch.inf)
    start = l_max_weight * (rtt + tau * dev(k_first)) + dev(waiting[n])
    dist = torch.where(dev(active & (a == 0), torch.bool), start, torch.inf)
    for _ in range(n):
        dist = torch.minimum(dist, (dist[:, :, None] + cost).amin(dim=1))
    dist = torch.where(dev(active & (e == problem.L), torch.bool), dist,
                       torch.inf)
    return dist.min(dim=1)
