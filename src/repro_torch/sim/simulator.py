"""Discrete-event simulator for distributed LLM inference (paper §4 byproduct)
— a numpy copy of the reference's ``repro/sim/simulator.py`` whose results
equal the reference's field for field (tests/test_torch_sim.py).

Replicates the *decision logic* of both the PETALS baseline and the proposed
two-time-scale BPRR under the validated performance models:

* session duration from eq (1) (prefill + (l_out−1) per-token),
* cache-slot accounting per server:  ⌊(M_j − s_m m_j)/s_c⌋ block-slots,
  sessions occupy k_j slots from start to completion (eq (5)/(20)),
* proposed: WS-RR waiting via eq (20) + no-overbooking commitment,
* PETALS:  memory-oblivious routing + binary-exponential-backoff retries
  (1,2,4,...s, 60 s cap — §3.3.2 footnote / §4.1),
* ablations: 'optimized_order', 'optimized_number', 'optimized_rr' (§4.3).

Metrics follow §4.1: average per-token time over ALL tokens
(= total completion / l_out, waiting included), first-token time, and
per-remaining-token time.

Heterogeneous stacks: session durations come from
``route_prefill_time``/``route_per_token_time``, which apply the optional
per-family block weights ``LLMSpec.block_tau`` (zamba2 hybrids, enc-dec) —
the same weighted eq. (1) the engine's virtual clock uses, so
engine-vs-simulator cross-validation holds on hybrid topologies
(``benchmarks/engine_validation.py`` ``xval.hybrid.R{4,8}``).

Two execution modes (``SimConfig.sim_mode``), same results:

* ``"reference"`` — the original per-request loop, kept verbatim as the
  bit-exact twin (the ``decode_mode="serial"`` pattern).
* ``"fast"`` — the array-native event engine for planet-scale traces
  (``sim.tput.1M`` in BENCH_engine.json): a retirement heap + per-server
  running usage counters keep a contention-free O(1) fast path per
  arrival, the ``_Timeline`` prunes dead intervals behind the trace
  frontier, and eq. (20) state is consumed as :class:`ServerStateArrays`
  instead of per-arrival dict rebuilds.  Per-request rows, routes, start
  times, drops and every ``SimResult`` metric are EXACTLY equal to the
  reference mode (tests/test_simulator.py parity matrix); only
  ``decision_time_s`` (wall clock) differs.  See docs/concurrency.md
  "Planet-scale simulation".
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.milp import solve_online_routing
from repro_torch.core.perf_model import (Placement, Problem, Route,
                                         route_per_token_time,
                                         route_prefill_time)
from repro_torch.core.placement import (auto_R, cg_bp, optimized_number_bp,
                                        optimized_order_bp, petals_bp)
from repro_torch.core.routing import (RouteCostCache, ServerState,
                                      ServerStateArrays, edge_waiting_times,
                                      petals_route, shortest_path_route,
                                      ws_rr)
from repro_torch.sim.workload import (ChurnEvent, Request, RequestBatch,
                                      poisson_requests)

ALGORITHMS = ("petals", "proposed", "optimized_order", "optimized_number",
              "optimized_rr")

SIM_MODES = ("reference", "fast")

Trace = Union[Sequence[Request], RequestBatch]


@dataclass
class SimConfig:
    algorithm: str = "proposed"
    n_requests: int = 100
    rate: float = 0.1
    seed: int = 0
    R: Optional[int] = None  # design concurrency (None = auto rule)
    backoff_max: float = 60.0
    client: int = 0
    # multi-client auto-generated traces: draw the issuing client uniformly
    # from range(n_clients) per request (None = all from ``client``)
    n_clients: Optional[int] = None
    # "reference" = original per-request loop (bit-exact twin);
    # "fast" = array-native event engine, identical rows/metrics
    sim_mode: str = "reference"
    # False skips per-request row dicts (fast mode's 1M-request traces):
    # metrics are computed from preallocated arrays with the same np.mean
    # reduction, SimResult.requests comes back empty
    collect_rows: bool = True


@dataclass
class SimResult:
    algorithm: str
    per_token_all: float  # mean total/l_out  (paper's primary metric)
    first_token: float  # mean wait + prefill
    per_token_rest: float  # mean decode per-token
    wait: float
    drop_rate: float
    decision_time_s: float  # algorithm running time (Table 6)
    placement: Optional[Placement] = None
    requests: List[Dict] = field(default_factory=list)
    sim_mode: str = "reference"
    # fast mode only: contention-free vs re-decided arrivals etc.
    fast_stats: Optional[Dict[str, int]] = None


class _Timeline:
    """Per-server cache-slot commitments, stored as flat numpy event arrays
    (start, end, k_blocks) with amortized-doubling growth.

    ``usage_max`` — the inner loop of every ``fits()`` probe — is a fully
    vectorized sweep: clip the overlapping intervals to the window, lexsort
    the ±k events by (time, delta) exactly like the old per-tuple sort, and
    take the max of the running ``cumsum``.

    Two event-engine refinements keep probes O(live intervals) instead of
    O(trace) on long runs:

    * **Buffered commits** — ``commit`` appends to per-server Python lists
      and probes flush them into the numpy arrays in bulk, so the fast
      loop's contention-free arrivals never pay per-element numpy writes.
    * **Frontier pruning** — the driver advances ``frontier`` to the
      current arrival time; once every future probe window starts at or
      after the frontier (arrivals nondecreasing — the fast loop checks),
      intervals with ``end <= frontier`` can never overlap a probe window,
      appear among ``earliest_start`` candidates, or survive a
      ``states_at`` view, so ``_flush`` compacts them away instead of
      growing.  With ``frontier = -inf`` (reference mode) nothing is ever
      pruned and behavior is the original amortized doubling.
    """

    def __init__(self, problem: Problem, placement: Placement):
        self.problem = problem
        self.placement = placement
        m = placement.m
        self.cap = np.floor((problem.mem() - problem.s_m * m)
                            / problem.s_c).astype(np.int64)
        self.cap = np.maximum(self.cap, 0)
        n = problem.n_servers
        self._start = [np.empty(8) for _ in range(n)]
        self._end = [np.empty(8) for _ in range(n)]
        self._k = [np.empty(8, np.int64) for _ in range(n)]
        self._n = [0] * n
        self._pend: List[List[Tuple[float, float, int]]] = \
            [[] for _ in range(n)]
        self.frontier = -np.inf
        self.compactions = 0

    def _flush(self, j: int):
        pend = self._pend[j]
        if not pend:
            return
        nj = self._n[j]
        p = len(pend)
        if nj + p > len(self._start[j]):
            live = self._end[j][:nj] > self.frontier
            nl = int(live.sum())
            if nl < nj:  # compact dead intervals behind the frontier
                self._start[j][:nl] = self._start[j][:nj][live]
                self._end[j][:nl] = self._end[j][:nj][live]
                self._k[j][:nl] = self._k[j][:nj][live]
                nj = nl
                self.compactions += 1
            if nj + p > len(self._start[j]):  # amortized growth
                new_cap = max(8, len(self._start[j]))
                while new_cap < nj + p:
                    new_cap *= 2
                for arrs in (self._start, self._end, self._k):
                    new = np.empty(new_cap, arrs[j].dtype)
                    new[:nj] = arrs[j][:nj]
                    arrs[j] = new
        cols = np.array(pend)  # (p, 3); k column is exact small ints
        self._start[j][nj:nj + p] = cols[:, 0]
        self._end[j][nj:nj + p] = cols[:, 1]
        self._k[j][nj:nj + p] = cols[:, 2]
        self._n[j] = nj + p
        pend.clear()

    @property
    def commits(self) -> List[List[Tuple[float, float, int]]]:
        """Per-server [(start, end, k_blocks)] view of the event arrays."""
        for j in range(self.problem.n_servers):
            self._flush(j)
        return [list(zip(self._start[j][: self._n[j]].tolist(),
                         self._end[j][: self._n[j]].tolist(),
                         self._k[j][: self._n[j]].tolist()))
                for j in range(self.problem.n_servers)]

    def usage_max(self, j: int, t0: float, t1: float) -> int:
        """Max concurrent slot usage on server j over [t0, t1)."""
        self._flush(j)
        n = self._n[j]
        if n == 0:
            return 0
        s, e, k = self._start[j][:n], self._end[j][:n], self._k[j][:n]
        live = (s < t1) & (e > t0)
        if not live.any():
            return 0
        ks = k[live]
        times = np.concatenate([np.maximum(s[live], t0),
                                np.minimum(e[live], t1)])
        deltas = np.concatenate([ks, -ks])
        order = np.lexsort((deltas, times))  # == sorted (time, ±k) tuples
        return int(np.cumsum(deltas[order]).max())

    def fits(self, route: Route, t: float, dur: float) -> bool:
        for j, k in zip(route.servers, route.blocks):
            if self.usage_max(j, t, t + dur) + k > self.cap[j]:
                return False
        return True

    def earliest_start(self, route: Route, t: float, dur: float) -> float:
        cands = {t}
        for j in route.servers:
            self._flush(j)
            n = self._n[j]
            s, e = self._start[j][:n], self._end[j][:n]
            cands.update(e[e > t].tolist())
            cands.update(s[s > t].tolist())
        for u in sorted(cands):
            if self.fits(route, u, dur):
                return u
        return np.inf

    def commit(self, route: Route, start: float, dur: float):
        end = start + dur
        for j, k in zip(route.servers, route.blocks):
            self._pend[j].append((start, end, k))

    def states_at(self, t: float) -> Dict[int, ServerState]:
        """eq (20) view: active-or-committed sessions as (remaining, k)."""
        states: Dict[int, ServerState] = {}
        for j in range(self.problem.n_servers):
            self._flush(j)
            n = self._n[j]
            live = self._end[j][:n] > t
            if live.any():
                states[j] = ServerState(
                    (self._end[j][:n][live] - t).tolist(),
                    self._k[j][:n][live].tolist())
        return states

    def states_arrays_at(self, t: float) -> ServerStateArrays:
        """``states_at`` in SoA form — same live sessions, same float
        remainings, consumed by the vectorized ``edge_waiting_times``."""
        out = ServerStateArrays(self.problem.n_servers)
        for j in range(self.problem.n_servers):
            self._flush(j)
            n = self._n[j]
            if n == 0:
                continue
            ends = self._end[j][:n]
            live = ends > t
            if live.any():
                out.set(j, ends[live] - t, self._k[j][:n][live])
        return out


def _backoff_attempts(t: float, horizon: float, cap: float):
    yield t
    delay = 1.0
    u = t
    while u < t + horizon:
        u += delay
        yield u
        delay = min(delay * 2, cap)


def _make_placement(problem: Problem, cfg: SimConfig, join_order
                    ) -> Tuple[Placement, int, float]:
    import time as _time

    t0 = _time.perf_counter()
    if cfg.R is not None:
        R = cfg.R
    else:
        # auto rule (after Cor. 3.6): arrivals during an expected session
        rough = 1.5 * problem.workload.l_out  # ~1.5 s/token prior estimate
        R = auto_R(problem, cfg.rate, rough)
    if cfg.algorithm == "petals":
        placement = petals_bp(problem, join_order=join_order)
    elif cfg.algorithm == "proposed":
        placement, _ = cg_bp(problem, R)
    elif cfg.algorithm == "optimized_order":
        placement = optimized_order_bp(problem, R)
    elif cfg.algorithm == "optimized_number":
        placement = optimized_number_bp(problem, R)
    elif cfg.algorithm == "optimized_rr":
        placement = petals_bp(problem, join_order=join_order)
    else:
        raise ValueError(cfg.algorithm)
    dt = _time.perf_counter() - t0
    return placement, R, dt


def _reference_loop(problem: Problem, cfg: SimConfig, placement: Placement,
                    requests: Trace, tl: _Timeline,
                    route_cache: RouteCostCache) -> Tuple[List[Dict], float]:
    """The original per-request admission loop, verbatim — the bit-exact
    twin every fast-path decision is tested against."""
    import time as _time

    rows: List[Dict] = []
    decision_time = 0.0
    lw = problem.workload
    for req in requests:
        t = req.arrival
        t0 = _time.perf_counter()
        wait_est = 0.0
        if cfg.algorithm in ("proposed",):
            route, _, wait_est = ws_rr(problem, placement, req.client,
                                       tl.states_at(t), cache=route_cache)
        elif cfg.algorithm == "optimized_rr":
            waiting = edge_waiting_times(problem, placement, tl.states_at(t))
            route, _ = solve_online_routing(problem, placement, req.client,
                                            waiting)
            if route is None:
                route = petals_route(problem, placement, req.client)
        elif cfg.algorithm in ("optimized_order", "optimized_number"):
            route = petals_route(problem, placement, req.client)
        else:  # petals
            route = petals_route(problem, placement, req.client)
        decision_time += _time.perf_counter() - t0
        if route is None:
            rows.append(dict(drop=True))
            continue

        prefill = route_prefill_time(problem, route, req.client)
        per_tok = route_per_token_time(problem, route, req.client)
        dur = prefill + (lw.l_out - 1) * per_tok
        earliest = tl.earliest_start(route, t, dur)
        if not np.isfinite(earliest):
            rows.append(dict(drop=True))
            continue
        if cfg.algorithm == "proposed":
            start = earliest
        else:
            # PETALS-style exponential-backoff retry until memory frees
            start = np.inf
            for u in _backoff_attempts(t, horizon=earliest - t + 130.0,
                                       cap=cfg.backoff_max):
                if u >= earliest and tl.fits(route, u, dur):
                    start = u
                    break
            if not np.isfinite(start):
                start = earliest
        tl.commit(route, start, dur)
        wait = start - t
        rows.append(dict(
            drop=False, wait=wait, first_token=wait + prefill,
            per_token_rest=per_tok, total=wait + dur,
            per_token_all=(wait + dur) / lw.l_out,
            hops=len(route.servers)))
    return rows, decision_time


def _fast_loop(problem: Problem, cfg: SimConfig, placement: Placement,
               requests: Trace, tl: _Timeline, route_cache: RouteCostCache):
    """Array-native event engine.  Exactness argument, hop by hop:

    * **Retirement heap + usage counters.**  ``used[j]`` tracks the summed
      blocks of committed sessions with ``end > t`` (lazy retirement off a
      global ``(end, j, k)`` heap) — exactly the sessions ``states_at(t)``
      reports, including not-yet-started commitments.

    * **Contention-free routing.**  ``free_j >= zero_wait_kthr[j]`` on
      every server makes the full eq. (20) wait matrix equal the
      empty-system matrix elementwise (``RouteCostCache.zero_wait_kthr``),
      so the reference's per-arrival WS-RR DP (or online MILP) would
      receive numerically identical inputs — its decision is the memoized
      per-client base decision.  Any tight server drops to the slow path,
      which runs the decision on ``states_arrays_at(t)`` (bit-identical
      wait matrices vs the dict view).

    * **Admission.**  ``used[j] + k <= cap[j]`` on every hop implies the
      reference's ``usage_max(j, t, t+dur) + k <= cap[j]`` (usage over any
      window is at most the live total), and since ``t`` is the first
      ``earliest_start`` candidate, ``earliest = t`` and backoff's first
      attempt ``u = t`` succeeds — ``start = t`` on both paths.  Otherwise
      the exact (pruned) ``earliest_start``/``fits`` probes run.

    Requires nondecreasing arrivals (needed for frontier pruning and lazy
    retirement); returns None to fall back to the reference loop if the
    trace is unsorted.
    """
    import time as _time

    if isinstance(requests, RequestBatch):
        arr_t, arr_c = requests.arrival, requests.client
    else:
        arr_t = np.asarray([r.arrival for r in requests], float)
        arr_c = np.asarray([r.client for r in requests], np.int64)
    N = int(len(arr_t))
    if N and bool(np.any(np.diff(arr_t) < 0)):
        return None

    t_loop = _time.perf_counter()
    alg = cfg.algorithm
    l_out = problem.workload.l_out
    l_out_m1 = l_out - 1
    n = problem.n_servers
    cap = tl.cap.tolist()
    slots = route_cache.total_slots.tolist()
    kthr = route_cache.zero_wait_kthr.tolist()
    # state-oblivious algorithms never re-decide under contention
    state_free = alg not in ("proposed", "optimized_rr")
    used = [0] * n
    tight = [False] * n
    n_tight = 0
    heap: List[Tuple[float, int, int]] = []
    heappush, heappop = heapq.heappush, heapq.heappop
    inf = np.inf
    isfinite = np.isfinite

    # memoized per-client base decisions and per-(client, route) timings;
    # False marks a memoized drop (no feasible route)
    base_dec: Dict[int, object] = {}
    route_info: Dict[Tuple[int, Tuple[int, ...]], tuple] = {}

    def _route_info(c: int, route: Route):
        key = (c, route.servers)
        info = route_info.get(key)
        if info is None:
            prefill, per_tok = route_cache.route_times(c, route)
            dur = prefill + l_out_m1 * per_tok
            info = (route, list(zip(route.servers, route.blocks)),
                    prefill, per_tok, dur, len(route.servers))
            route_info[key] = info
        return info

    def _base_decision(c: int):
        info = base_dec.get(c)
        if info is None:
            if alg == "proposed":
                route, _ = route_cache.base_ws_rr(c)
            elif alg == "optimized_rr":
                route, _ = solve_online_routing(
                    problem, placement, c, route_cache.empty_waiting())
                if route is None:
                    route = route_cache.petals(c)
            else:
                route = route_cache.petals(c)
            info = _route_info(c, route) if route is not None else False
            base_dec[c] = info
        return info

    collect = cfg.collect_rows
    rows: Optional[List[Dict]] = [] if collect else None
    if not collect:
        m_wait = np.empty(N)
        m_ft = np.empty(N)
        m_ptr = np.empty(N)
        m_pta = np.empty(N)
    n_ok = 0
    n_fast = 0
    n_slow = 0
    n_drop = 0

    ts = arr_t.tolist()
    cs = arr_c.tolist()
    for i in range(N):
        t = ts[i]
        c = cs[i]
        tl.frontier = t
        while heap and heap[0][0] <= t:
            _, j, k = heappop(heap)
            u = used[j] - k
            used[j] = u
            if tight[j] and slots[j] - u >= kthr[j]:
                tight[j] = False
                n_tight -= 1
        if state_free or n_tight == 0:
            info = _base_decision(c)
            n_fast += 1
        else:
            n_slow += 1
            if alg == "proposed":
                route, _, _ = ws_rr(problem, placement, c,
                                    tl.states_arrays_at(t), cache=route_cache)
            else:  # optimized_rr
                waiting = edge_waiting_times(
                    problem, placement, tl.states_arrays_at(t),
                    cache=route_cache)
                route, _ = solve_online_routing(problem, placement, c,
                                                waiting)
                if route is None:
                    route = route_cache.petals(c)
            info = _route_info(c, route) if route is not None else False
        if info is False:
            n_drop += 1
            if collect:
                rows.append(dict(drop=True))
            continue
        route, hops, prefill, per_tok, dur, n_hops = info
        fits_now = True
        for j, k in hops:
            if used[j] + k > cap[j]:
                fits_now = False
                break
        if fits_now:
            start = t
        else:
            earliest = tl.earliest_start(route, t, dur)
            if not isfinite(earliest):
                n_drop += 1
                if collect:
                    rows.append(dict(drop=True))
                continue
            if alg == "proposed":
                start = earliest
            else:
                start = inf
                for u in _backoff_attempts(t, horizon=earliest - t + 130.0,
                                           cap=cfg.backoff_max):
                    if u >= earliest and tl.fits(route, u, dur):
                        start = u
                        break
                if not isfinite(start):
                    start = earliest
        end = start + dur
        tl.commit(route, start, dur)
        for j, k in hops:
            u = used[j] + k
            used[j] = u
            if not tight[j] and slots[j] - u < kthr[j]:
                tight[j] = True
                n_tight += 1
            heappush(heap, (end, j, k))
        wait = start - t
        if collect:
            rows.append(dict(
                drop=False, wait=wait, first_token=wait + prefill,
                per_token_rest=per_tok, total=wait + dur,
                per_token_all=(wait + dur) / l_out,
                hops=n_hops))
        else:
            m_wait[n_ok] = wait
            m_ft[n_ok] = wait + prefill
            m_ptr[n_ok] = per_tok
            m_pta[n_ok] = (wait + dur) / l_out
        n_ok += 1

    decision_time = _time.perf_counter() - t_loop
    stats = dict(fast_routes=n_fast, slow_routes=n_slow, drops=n_drop,
                 compactions=tl.compactions)
    if collect:
        return rows, None, decision_time, stats
    arrays = (n_ok, N, m_wait, m_ft, m_ptr, m_pta)
    return None, arrays, decision_time, stats


def simulate(problem: Problem, cfg: SimConfig,
             requests: Optional[Trace] = None) -> SimResult:
    if cfg.sim_mode not in SIM_MODES:
        raise ValueError(f"sim_mode must be one of {SIM_MODES}, "
                         f"got {cfg.sim_mode!r}")
    rng = np.random.default_rng(cfg.seed + 1)
    join_order = rng.permutation(problem.n_servers)  # random join (§4.1)
    placement, R, place_time = _make_placement(problem, cfg, join_order)
    if requests is None:
        requests = poisson_requests(cfg.n_requests, cfg.rate,
                                    client=cfg.client, seed=cfg.seed,
                                    n_clients=cfg.n_clients)
    tl = _Timeline(problem, placement)
    # placement is fixed for the whole trace: memoize the routing graph /
    # edge costs / slot capacities across arrivals (same cache the online
    # controller uses)
    route_cache = RouteCostCache(problem, placement)

    out = None
    if cfg.sim_mode == "fast":
        out = _fast_loop(problem, cfg, placement, requests, tl, route_cache)
    fast_stats = None
    arrays = None
    if out is None:  # reference mode, or fast fell back (unsorted trace)
        rows, decision_time = _reference_loop(problem, cfg, placement,
                                              requests, tl, route_cache)
    else:
        rows, arrays, decision_time, fast_stats = out
    decision_time += place_time

    if rows is not None:
        ok = [r for r in rows if not r.get("drop")]
        drop_rate = 1.0 - len(ok) / max(1, len(rows))
        mean = lambda k: float(np.mean([r[k] for r in ok])) if ok else np.inf
        per_token_all = mean("per_token_all")
        first_token = mean("first_token")
        per_token_rest = mean("per_token_rest")
        wait = mean("wait")
    else:
        n_ok, n_total, m_wait, m_ft, m_ptr, m_pta = arrays
        drop_rate = 1.0 - n_ok / max(1, n_total)
        # identical reduction to the rows path: np.mean over the same
        # float sequence (pairwise summation depends only on the values)
        mean = lambda a: float(np.mean(a[:n_ok])) if n_ok else np.inf
        per_token_all = mean(m_pta)
        first_token = mean(m_ft)
        per_token_rest = mean(m_ptr)
        wait = mean(m_wait)
        rows = []
    return SimResult(
        algorithm=cfg.algorithm,
        per_token_all=per_token_all,
        first_token=first_token,
        per_token_rest=per_token_rest,
        wait=wait,
        drop_rate=drop_rate,
        decision_time_s=decision_time / max(1, len(requests)),
        placement=placement,
        requests=rows,
        # the EXECUTED mode: "reference" when fast fell back (unsorted)
        sim_mode="fast" if out is not None else "reference",
        fast_stats=fast_stats,
    )


def run_comparison(problem: Problem, algorithms=("petals", "proposed"),
                   n_requests: int = 100, rate: float = 0.1,
                   seeds=(0, 1, 2, 3, 4), R: Optional[int] = None,
                   n_clients: Optional[int] = None,
                   sim_mode: str = "reference"
                   ) -> Dict[str, Dict[str, float]]:
    """Monte-Carlo comparison (paper: 5 experiment / 20 sim runs).

    Every metric column comes with a ``<metric>_std`` companion — the
    across-seed standard deviation matching the paper's reported
    Monte-Carlo spreads.  ``n_clients`` draws each request's issuing
    client uniformly (multi-client traces in one call); ``sim_mode``
    selects the event engine (results are identical, see ``SimConfig``).
    """
    out = {}
    metric_names = ("per_token_all", "first_token", "per_token_rest",
                    "wait", "decision_time_s", "drop_rate")
    for alg in algorithms:
        metrics = []
        for seed in seeds:
            res = simulate(problem, SimConfig(
                algorithm=alg, n_requests=n_requests, rate=rate, seed=seed,
                R=R, n_clients=n_clients, sim_mode=sim_mode))
            metrics.append(res)
        row: Dict[str, float] = {}
        for name in metric_names:
            vals = [getattr(m, name) for m in metrics]
            row[name] = float(np.mean(vals))
            row[name + "_std"] = float(np.std(vals))
        out[alg] = row
    return out


# ---------------------------------------------------------------------------
# Churn studies: join/leave storms through the online controller
# ---------------------------------------------------------------------------


@dataclass
class ChurnResult:
    """Outcome of :func:`simulate_churn` — fleet-health metrics for the
    join/leave-storm studies (``sim.churn`` in BENCH_engine.json)."""

    n_requests: int
    n_storms: int
    n_replacements: int  # CG-BP re-runs == RouteCostCache invalidations
    drop_rate: float
    wait: float
    per_token_all: float
    alive_min: int  # smallest fleet the controller placed over
    # per-storm recovery metrics (index-aligned with the sorted schedule):
    # time from the storm to the first successfully routed admission after
    # it (inf when the trace ends first), and the controller's in-flight
    # session count at the instant the storm lands
    time_to_reroute: Tuple[float, ...] = ()
    in_flight_at_kill: Tuple[int, ...] = ()


def _problem_with_dead(problem: Problem, dead) -> Problem:
    """Model departed servers as 0-memory hosts: CG-BP then places no
    blocks on them (the same modeling tests/test_routing_online.py uses
    for elastic replacement)."""
    import dataclasses

    servers = [dataclasses.replace(s, mem_bytes=0.0) if j in dead else s
               for j, s in enumerate(problem.servers)]
    return Problem(problem.llm, servers, problem.n_clients,
                   problem.rtt_token, problem.rtt_prefill, problem.workload)


def simulate_churn(problem: Problem, requests: Trace,
                   schedule: Sequence[ChurnEvent], R: Optional[int] = None,
                   reopt_min_interval: float = 0.0) -> ChurnResult:
    """Drive :class:`repro_torch.core.OnlineBPRR` through a request trace while
    ``schedule``'s join/leave storms mutate the fleet.

    Each storm marks the fleet dirty; at the next arrival at least
    ``reopt_min_interval`` after the previous re-optimization, the
    controller re-runs CG-BP over the surviving servers via
    ``replace_servers`` — which REPLACES its ``RouteCostCache``, the
    cache-invalidation path this study exists to exercise (storms landing
    within the cadence window coalesce into one re-placement).  Requests
    the WS-RR DP cannot route on the current placement are drops.
    """
    from repro_torch.core.online import OnlineBPRR

    ctl = OnlineBPRR(problem, R=R)
    events = sorted(schedule, key=lambda ev: ev.time)
    l_out = problem.workload.l_out
    dead: set = set()
    ei = 0
    dirty = False
    last_reopt = -np.inf
    n_repl = 0
    alive_min = problem.n_servers
    n_total = 0
    n_ok = 0
    sum_wait = 0.0
    sum_pta = 0.0
    storm_t: List[float] = []
    storm_inflight: List[int] = []
    reroute: List[float] = []
    rerouted = 0  # storms whose first post-storm success has been seen
    for req in requests:
        t = req.arrival
        n_total += 1
        while ei < len(events) and events[ei].time <= t:
            ev = events[ei]
            ei += 1
            dead.difference_update(ev.join)
            dead.update(ev.leave)
            dirty = True
            ctl.gc(ev.time)
            storm_t.append(ev.time)
            storm_inflight.append(ctl.concurrency())
            reroute.append(np.inf)
        if dirty and t - last_reopt >= reopt_min_interval:
            ctl.replace_servers(_problem_with_dead(problem, dead))
            n_repl += 1
            last_reopt = t
            dirty = False
            alive_min = min(alive_min, problem.n_servers - len(dead))
        ctl.gc(t)
        route, start, end, _ = ctl.admit(req.client, t)
        if route is None or not np.isfinite(start):
            continue
        n_ok += 1
        sum_wait += start - t
        sum_pta += (end - t) / l_out
        while rerouted < len(storm_t):
            reroute[rerouted] = t - storm_t[rerouted]
            rerouted += 1
    return ChurnResult(
        n_requests=n_total,
        n_storms=ei,
        n_replacements=n_repl,
        drop_rate=1.0 - n_ok / max(1, n_total),
        wait=sum_wait / n_ok if n_ok else np.inf,
        per_token_all=sum_pta / n_ok if n_ok else np.inf,
        alive_min=alive_min,
        time_to_reroute=tuple(reroute),
        in_flight_at_kill=tuple(storm_inflight),
    )


# ---------------------------------------------------------------------------
# Chaos studies: fault plans through the analytic reference loop
# ---------------------------------------------------------------------------


@dataclass
class FaultSimResult:
    """Outcome of :func:`simulate_faults` — the analytic twin of the
    engine's chaos accounting (``chaos.recovery`` in BENCH_engine.json)."""

    n_requests: int
    n_served: int
    n_failed: int
    n_detections: int
    n_replays: int
    detect_time: float
    backoff_time: float
    replay_time: float
    fail_reasons: Dict[str, int]
    wait: float
    per_token_all: float

    @property
    def recovery_time(self) -> float:
        """Total billed recovery: detection + backoff + replay."""
        return self.detect_time + self.backoff_time + self.replay_time

    @property
    def goodput(self) -> float:
        return self.n_served / max(1, self.n_requests)


def _problem_with_faults(problem: Problem, dead, slow) -> Problem:
    """Dead servers become 0-memory hosts; stragglers carry scaled taus —
    the same single-carrier slowdown model as the engine's
    ``set_slowdown`` (the problem tau is the one source of truth)."""
    import dataclasses

    servers = []
    for j, s in enumerate(problem.servers):
        if j in dead:
            s = dataclasses.replace(s, mem_bytes=0.0)
        f = slow.get(j)
        if f is not None and f != 1.0:
            s = dataclasses.replace(s, tau=s.tau * f)
        servers.append(s)
    return Problem(problem.llm, servers, problem.n_clients,
                   problem.rtt_token, problem.rtt_prefill, problem.workload)


def subchain_route(problem: Problem, placement: Placement, dead,
                   lo: int, hi: int, client: int) -> Optional[Route]:
    """Min-cost chain of alive servers covering exactly blocks
    ``[lo, hi)`` — the simulator-side mirror of the engine's
    ``GeoServingSystem._subchain`` splice DP (same clipped subproblem,
    same ``shortest_path_route``), used to price failover replay."""
    import dataclasses

    a = np.clip(placement.a, lo, hi)
    end = np.clip(placement.a + placement.m, lo, hi)
    m = np.maximum(end - a, 0)
    m = np.where(placement.m <= 0, 0, m)
    if dead:
        m = m.copy()
        m[np.asarray(sorted(dead), int)] = 0
    sub = Placement(a=a - lo, m=m)
    kw = dict(n_blocks=hi - lo)
    if problem.llm.block_tau is not None:
        kw["block_tau"] = problem.llm.block_tau[lo:hi]
    subproblem = dataclasses.replace(
        problem, llm=dataclasses.replace(problem.llm, **kw))
    route, _ = shortest_path_route(subproblem, sub, client)
    return route


def simulate_faults(problem: Problem, requests: Trace, plan,
                    R: Optional[int] = None, detector=None) -> FaultSimResult:
    """Analytic fault-aware admission loop: drive :class:`OnlineBPRR`
    through a request trace while a :class:`repro_torch.serving.faults.FaultPlan`
    injects crashes, rejoins, stragglers, and dispatch errors — billing
    recovery with the SAME shared pricing the engine uses
    (``FailureDetector.detect_time`` / ``backoff_time`` +
    :func:`recovery_replay_cost` over the :func:`subchain_route` splice).

    Per crash, every in-flight session routed through the victim pays the
    missed deadline (``timeout_factor x`` the eq. (1) expected hop time,
    once per probe), the exponential-backoff sleeps, and the replay of its
    prompt prefill plus generated-so-far tokens on the replacement chain;
    its remaining tokens then run at the spliced route's per-token time.
    Sessions caught mid-prefill fail with ``server_lost_mid_prefill``;
    sessions with no alive replacement chain fail with ``no_route`` —
    every admitted request ends served or failed-with-reason, the same
    conservation law the chaos tests assert on the engine."""
    from repro_torch.core.online import OnlineBPRR
    from repro_torch.serving.faults import FailureDetector, recovery_replay_cost

    det = detector if detector is not None else FailureDetector()
    ctl = OnlineBPRR(problem, R=R)
    lw = problem.workload
    dead: set = set()
    slow: Dict[int, float] = {}
    dispatch_faults: set = set()
    cursor = 0
    live: Dict[int, dict] = {}
    n_total = n_served = n_failed = 0
    n_detections = n_replays = 0
    detect_s = backoff_s = replay_s = 0.0
    fail_reasons: Dict[str, int] = {}
    sum_wait = sum_pta = 0.0

    def _fail(rec: dict, reason: str):
        nonlocal n_failed
        n_failed += 1
        fail_reasons[reason] = fail_reasons.get(reason, 0) + 1
        live.pop(rec["sid"], None)
        ctl.finish(rec["sid"])

    def _retire(now: float):
        nonlocal n_served, sum_wait, sum_pta
        for sid in [sid for sid, r in live.items() if r["end"] <= now]:
            r = live.pop(sid)
            n_served += 1
            sum_wait += r["wait"]
            sum_pta += (r["end"] - r["arrival"]) / lw.l_out

    def _crash(ev):
        nonlocal n_detections, n_replays, detect_s, backoff_s, replay_s
        j = ev.server
        if j in dead:
            return
        _retire(ev.time)
        dead.add(j)
        cur = _problem_with_faults(problem, dead, slow)
        backoff = det.backoff_time()
        for rec in list(live.values()):
            if rec["start"] > ev.time or j not in rec["route"].servers:
                continue
            if ev.time < rec["start"] + rec["prefill"]:
                _fail(rec, "server_lost_mid_prefill")
                continue
            h = rec["route"].servers.index(j)
            lo = int(sum(rec["route"].blocks[:h]))
            hi = lo + int(rec["route"].blocks[h])
            w = problem.llm.tau_weight(lo, hi)
            expected = (problem.rtt_token[rec["client"], j]
                        + w * problem.servers[j].tau * slow.get(j, 1.0))
            repl = subchain_route(cur, ctl.placement, dead, lo, hi,
                                  rec["client"])
            if repl is None:
                _fail(rec, "no_route")
                continue
            n_tok = max(0, min(
                int((ev.time - rec["start"] - rec["prefill"])
                    / max(rec["per_token"], 1e-12)),
                lw.l_out - 1))
            repl_spans = []
            e = lo
            for jj, k in zip(repl.servers, repl.blocks):
                repl_spans.append((jj, e, e + int(k)))
                e += int(k)
            replay = recovery_replay_cost(
                problem, rec["client"], repl_spans, n_tok,
                slowdown_of=lambda jj: slow.get(jj, 1.0))
            detect = det.detect_time(expected)
            spliced = Route(
                servers=tuple(rec["route"].servers[:h]) + tuple(repl.servers)
                + tuple(rec["route"].servers[h + 1:]),
                blocks=tuple(rec["route"].blocks[:h])
                + tuple(int(k) for k in repl.blocks)
                + tuple(rec["route"].blocks[h + 1:]))
            per_tok = route_per_token_time(cur, spliced, rec["client"])
            rec["route"] = spliced
            rec["per_token"] = per_tok
            rec["end"] = (ev.time + detect + backoff + replay
                          + (lw.l_out - 1 - n_tok) * per_tok)
            n_detections += 1
            n_replays += 1
            detect_s += detect
            backoff_s += backoff
            replay_s += replay
        ctl.set_suspicion(j, det.suspicion_penalty)
        ctl.replace_servers(cur, R=ctl.R)

    def _advance(now: float):
        nonlocal cursor
        due, cursor = plan.due(cursor, now)
        for ev in due:
            if ev.kind == "crash":
                _crash(ev)
            elif ev.kind == "rejoin":
                if ev.server in dead:
                    dead.discard(ev.server)
                    ctl.replace_servers(
                        _problem_with_faults(problem, dead, slow), R=ctl.R)
            elif ev.kind == "straggler_start":
                slow[ev.server] = ev.factor
                ctl.replace_servers(
                    _problem_with_faults(problem, dead, slow), R=ctl.R)
            elif ev.kind == "straggler_end":
                if slow.pop(ev.server, None) is not None:
                    ctl.replace_servers(
                        _problem_with_faults(problem, dead, slow), R=ctl.R)
            elif ev.kind == "dispatch_error":
                dispatch_faults.add(ev.server)

    for req in requests:
        t = req.arrival
        n_total += 1
        _advance(t)
        _retire(t)
        ctl.gc(t)
        route, start, end, sid = ctl.admit(req.client, t)
        if route is None or not np.isfinite(start):
            n_failed += 1
            fail_reasons["no_route"] = fail_reasons.get("no_route", 0) + 1
            continue
        faulted = [j for j in route.servers if j in dispatch_faults]
        if faulted:
            dispatch_faults.difference_update(faulted)
            n_failed += 1
            fail_reasons["dispatch_error"] = (
                fail_reasons.get("dispatch_error", 0) + 1)
            ctl.finish(sid)
            continue
        cur = _problem_with_faults(problem, dead, slow)
        prefill = route_prefill_time(cur, route, req.client)
        per_tok = route_per_token_time(cur, route, req.client)
        live[sid] = dict(
            sid=sid, client=req.client, route=route, arrival=t,
            wait=start - t, start=start, prefill=prefill,
            per_token=per_tok,
            end=start + prefill + (lw.l_out - 1) * per_tok)
    _advance(np.inf)
    _retire(np.inf)
    return FaultSimResult(
        n_requests=n_total, n_served=n_served, n_failed=n_failed,
        n_detections=n_detections, n_replays=n_replays,
        detect_time=detect_s, backoff_time=backoff_s, replay_time=replay_s,
        fail_reasons=fail_reasons,
        wait=sum_wait / n_served if n_served else np.inf,
        per_token_all=sum_pta / n_served if n_served else np.inf)
