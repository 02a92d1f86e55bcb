"""Two-time-scale online BPRR (Alg. 2): CG-BP at the slow time scale +
WS-RR per arriving request, with tracked server state for eq. (20).

The controller is the integration point for the serving stack
(repro_torch.serving.scheduler) and the reference's simulator
(repro.sim.simulator):

    ctl = OnlineBPRR(problem, R=...)            # CG-BP placement
    route, start_t = ctl.admit(client, now)     # WS-RR + bookkeeping
    ctl.finish(session_id)                      # frees cache slots
    ctl.server_failed(j) / ctl.server_joined()  # elastic re-placement
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bounds import cg_upper_bound
from repro_torch.core.perf_model import (Placement, Problem, Route,
                                   route_per_token_time, route_prefill_time,
                                   route_total_time)
from repro_torch.core.placement import auto_R, cg_bp, max_feasible_R
from repro_torch.core.routing import (RouteCostCache, ServerState,
                                ServerStateArrays, edge_waiting_times, ws_rr)


@dataclass
class Session:
    """One tracked session in the controller's bookkeeping: its committed
    route and [start, end) interval on the virtual clock — the state that
    feeds eq. (20) waiting estimates for later arrivals."""

    sid: int
    client: int
    route: Route
    arrival: float
    start: float
    end: float


class OnlineBPRR:
    """Alg. 2 controller with session bookkeeping."""

    def __init__(self, problem: Problem, R: Optional[int] = None,
                 arrival_rate: Optional[float] = None,
                 slot_scale: float = 1.0,
                 placement: Optional[Placement] = None):
        # page-granular eq. (5)/(20): when the serving engine books pages
        # instead of worst-case slots, each co-resident session reserves
        # s_c / slot_scale cache bytes — scaling the controller's view of
        # s_c ONCE propagates consistently through CG-BP's conservative_m
        # (Alg. 1 line 1), the eq. (15) capacities, and the eq. (20)
        # waiting times (1.0 keeps the paper's slab worst case)
        self.slot_scale = float(slot_scale)
        self.problem = problem = self._cache_scaled(problem)
        if R is None:
            guess = cg_upper_bound(problem, max(1, min(8, max_feasible_R(
                problem)))) * problem.workload.l_out
            R = auto_R(problem, arrival_rate or 0.1,
                       guess if np.isfinite(guess) else 60.0)
        self.R = int(R)
        self.placement, self.info = cg_bp(problem, self.R)
        # route on the serving engine's placement: its servers host
        # exactly these block ranges (CG-BP on the page-scaled problem, or
        # on a fleet pruned of dead servers, may place differently, and its
        # routes would then name blocks a server does not host)
        self.pinned = placement is not None
        if placement is not None:
            self.placement = placement
        self.sessions: Dict[int, Session] = {}
        self._next_sid = itertools.count()
        # flap avoidance: {server: additive per-token cost penalty} for
        # servers the serving layer has seen fail by timeout — survives
        # replace_servers (a rejoined server stays penalized until cleared)
        self._suspicion: Dict[int, float] = {}
        # placement-derived routing inputs (graph, edge costs, slot caps)
        # are arrival-invariant: memoize them across admits and invalidate
        # only when the placement / server set changes (replace_servers)
        self._route_cache = RouteCostCache(self.problem, self.placement,
                                           suspicion=self._suspicion)

    def _cache_scaled(self, problem: Problem) -> Problem:
        if self.slot_scale == 1.0:
            return problem
        llm = problem.llm
        return replace(problem, llm=replace(
            llm,
            cache_bytes_per_token=llm.cache_bytes_per_token
            / self.slot_scale,
            cache_bytes_const=llm.cache_bytes_const / self.slot_scale))

    # ------------------------------------------------------------------
    def server_states(self, now: float) -> Dict[int, ServerState]:
        states: Dict[int, ServerState] = {}
        for s in self.sessions.values():
            for j, k in zip(s.route.servers, s.route.blocks):
                st = states.setdefault(j, ServerState([], []))
                st.remaining.append(max(s.end - now, 0.0))
                st.blocks.append(k)
        return states

    def server_state_arrays(self, now: float) -> ServerStateArrays:
        """Array-backed :meth:`server_states` — same sessions, same
        insertion order, same floats, but in the SoA form the vectorized
        ``edge_waiting_times`` branch consumes without per-arrival dict
        rebuilds (bit-identical wait matrices, tests/test_simulator.py)."""
        rem: Dict[int, List[float]] = {}
        blk: Dict[int, List[int]] = {}
        for s in self.sessions.values():
            for j, k in zip(s.route.servers, s.route.blocks):
                if j in rem:
                    rem[j].append(max(s.end - now, 0.0))
                    blk[j].append(k)
                else:
                    rem[j] = [max(s.end - now, 0.0)]
                    blk[j] = [k]
        out = ServerStateArrays(self.problem.n_servers)
        for j, r in rem.items():
            out.set(j, np.asarray(r, float), np.asarray(blk[j], np.int64))
        return out

    def concurrency(self) -> int:
        return len(self.sessions)

    # ------------------------------------------------------------------
    def admit(self, client: int, now: float
              ) -> Tuple[Optional[Route], float, float, int]:
        """Route a new request.  Returns (route, start_time, end_time, sid)."""
        states = self.server_state_arrays(now)
        route, cost, wait = ws_rr(self.problem, self.placement, client,
                                  states, cache=self._route_cache)
        if route is None:
            return None, np.inf, np.inf, -1
        start = now + wait
        dur = route_total_time(self.problem, route, client)
        end = start + dur
        sid = next(self._next_sid)
        self.sessions[sid] = Session(sid, client, route, now, start, end)
        return route, start, end, sid

    def finish(self, sid: int):
        self.sessions.pop(sid, None)

    def gc(self, now: float):
        """Drop sessions whose end time has passed."""
        done = [sid for sid, s in self.sessions.items() if s.end <= now]
        for sid in done:
            self.finish(sid)

    # ------------------------------------------------------------------
    # Elastic scaling / fault tolerance (slow-time-scale re-placement)
    # ------------------------------------------------------------------
    def replace_servers(self, problem: Problem, R: Optional[int] = None,
                        placement: Optional[Placement] = None):
        """Re-run CG-BP after a join/leave/failure (Alg. 2 extension,
        §3.3.3).  Running sessions keep their routes; new requests use the
        new placement.  A controller built on the engine's placement
        (``placement=`` at construction) instead takes ``placement``, the
        engine's placement with the dead servers removed
        (``GeoServingSystem.alive_placement``): the engine does not move
        blocks after a failure, so a fresh CG-BP could route through
        blocks no live server hosts."""
        self.problem = self._cache_scaled(problem)
        if R is not None:
            self.R = int(R)
        if self.pinned:
            if placement is None:
                raise ValueError("a controller pinned to the engine's "
                                 "placement needs the alive placement")
            self.placement = placement
        else:
            self.placement, self.info = cg_bp(self.problem, self.R)
        # capacities / RTTs / placement changed: drop every memoized input
        # (the suspicion map persists — flap avoidance across rejoins)
        self._route_cache = RouteCostCache(self.problem, self.placement,
                                           suspicion=self._suspicion)

    def set_suspicion(self, j: int, penalty: float):
        """Penalize edges into server ``j`` by ``penalty`` seconds/token
        in every routing decision (timeout-detected failure — see
        ``FailureDetector.suspicion_penalty``).  Rebuilds the memoized
        route cache so the next admit sees it."""
        self._suspicion[int(j)] = float(penalty)
        self._route_cache = RouteCostCache(self.problem, self.placement,
                                           suspicion=self._suspicion)

    def clear_suspicion(self, j: int):
        """Forgive server ``j`` (it has proven itself after a rejoin)."""
        if self._suspicion.pop(int(j), None) is not None:
            self._route_cache = RouteCostCache(self.problem, self.placement,
                                               suspicion=self._suspicion)

    def guarantee(self) -> float:
        """Completion-time guarantee (22) while concurrency <= R."""
        return (cg_upper_bound(self.problem, self.R)
                * self.problem.workload.l_out)
