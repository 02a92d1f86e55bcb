"""Poisson request workload (paper §4.1: N_R requests at rate λ from a
proxy client).

A copy of the reference's ``repro/sim/workload.py``.  The same trace feeds
BOTH the discrete-event simulator (``repro_torch.sim.simulator.simulate(...,
requests=...)``) and the real engine
(``repro_torch.serving.ContinuousBatchingScheduler``) — the engine-vs-
simulator cross-validation (``chip_smoke.py``'s perf-model phase,
tests/test_torch_costs.py) relies on byte-identical arrival processes on
the two paths.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    rid: int
    client: int
    arrival: float


@dataclass(frozen=True)
class RequestBatch:
    """Array-backed request trace — the SoA twin of ``List[Request]``.

    The fast simulator loop (``SimConfig(sim_mode="fast")``) reads the
    ``arrival``/``client`` arrays directly; iterating a batch yields plain
    :class:`Request` objects with the identical float arrivals, so the
    reference loop (and the serving engine's trace replay) consumes the
    same batch unchanged — one trace object, two execution paths."""

    arrival: np.ndarray
    client: np.ndarray
    rid: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "arrival", np.asarray(self.arrival, float))
        object.__setattr__(self, "client", np.asarray(self.client, np.int64))
        object.__setattr__(self, "rid", np.asarray(self.rid, np.int64))
        if not (self.arrival.shape == self.client.shape == self.rid.shape
                and self.arrival.ndim == 1):
            raise ValueError("RequestBatch arrays must be 1-D of equal length")

    def __len__(self) -> int:
        return int(self.arrival.shape[0])

    def __iter__(self):
        for rid, c, t in zip(self.rid.tolist(), self.client.tolist(),
                             self.arrival.tolist()):
            yield Request(rid=rid, client=c, arrival=t)

    def to_requests(self) -> List[Request]:
        return list(self)

    @staticmethod
    def from_requests(requests: Sequence[Request]) -> "RequestBatch":
        return RequestBatch(
            arrival=np.asarray([r.arrival for r in requests], float),
            client=np.asarray([r.client for r in requests], np.int64),
            rid=np.asarray([r.rid for r in requests], np.int64))


def poisson_requests(n_requests: int, rate: float, client: int = 0,
                     seed: int = 0,
                     n_clients: Optional[int] = None) -> List[Request]:
    """Poisson arrivals; with ``n_clients`` the issuing client is drawn
    uniformly per request (multi-client traffic), otherwise all requests
    come from ``client`` (the paper's proxy-client setup)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    times = np.cumsum(gaps)
    if n_clients is not None:
        clients = rng.integers(0, n_clients, size=n_requests)
    else:
        clients = np.full(n_requests, client)
    return [Request(rid=i, client=int(c), arrival=float(t))
            for i, (t, c) in enumerate(zip(times, clients))]


def burst_requests(n_requests: int, at: float = 0.0, client: int = 0
                   ) -> List[Request]:
    """All requests arrive at once — the max-concurrency stress trace."""
    return [Request(rid=i, client=client, arrival=float(at))
            for i in range(n_requests)]


def bursty_requests(n_bursts: int, burst_size: int, spacing: float,
                    client: int = 0, start: float = 0.0,
                    jitter: float = 0.0, seed: int = 0) -> List[Request]:
    """Bursty arrivals: ``burst_size`` same-timestamp requests every
    ``spacing`` seconds — the trace shape that produces coalescable prefill
    groups in the engine (same-time starts admit together and share one
    pooled bucket-group prefill).  ``jitter > 0`` adds an exponential
    within-burst offset (mean ``jitter`` seconds) to each arrival, breaking
    exact simultaneity for robustness studies."""
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    rid = 0
    for b in range(n_bursts):
        t0 = start + b * spacing
        for _ in range(burst_size):
            t = t0 + (float(rng.exponential(jitter)) if jitter > 0 else 0.0)
            out.append(Request(rid=rid, client=client, arrival=t))
            rid += 1
    return out


def diurnal_rate(t, base_rate: float, peak_rate: float,
                 period: float, t0: float = 0.0):
    """λ(t) of the diurnal arrival process: a sinusoidal day curve with
    valley ``base_rate`` at ``t0`` and peak ``peak_rate`` half a period
    later (the planet-scale load shape: overnight trough, midday rush)."""
    x = 2.0 * np.pi * (np.asarray(t, float) - t0) / period
    return base_rate + (peak_rate - base_rate) * 0.5 * (1.0 - np.cos(x))


def diurnal_requests(n_requests: int, base_rate: float, peak_rate: float,
                     period: float = 86400.0, client: int = 0, seed: int = 0,
                     n_clients: Optional[int] = None,
                     t0: float = 0.0) -> RequestBatch:
    """Nonhomogeneous Poisson arrivals with the :func:`diurnal_rate` curve,
    sampled by thinning (Lewis–Shedler): candidate arrivals from a
    homogeneous process at ``peak_rate`` are kept with probability
    λ(t)/peak_rate.  Generated fully vectorized in chunks, so 1M-request
    traces are cheap; returns a :class:`RequestBatch`."""
    if not (0.0 <= base_rate <= peak_rate) or peak_rate <= 0.0:
        raise ValueError("need 0 <= base_rate <= peak_rate, peak_rate > 0")
    rng = np.random.default_rng(seed)
    lam_max = float(peak_rate)
    chunk = int(min(max(1024, 2 * n_requests), 1 << 20))
    kept: List[np.ndarray] = []
    total = 0
    t_cur = float(t0)
    while total < n_requests:
        ts = t_cur + np.cumsum(rng.exponential(1.0 / lam_max, size=chunk))
        t_cur = float(ts[-1])
        accept = (rng.uniform(size=chunk) * lam_max
                  < diurnal_rate(ts, base_rate, peak_rate, period, t0))
        keep = ts[accept]
        kept.append(keep)
        total += len(keep)
    times = np.concatenate(kept)[:n_requests]
    if n_clients is not None:
        clients = rng.integers(0, n_clients, size=n_requests)
    else:
        clients = np.full(n_requests, client)
    return RequestBatch(arrival=times, client=clients,
                        rid=np.arange(n_requests))


@dataclass(frozen=True)
class ChurnEvent:
    """One churn storm: at ``time``, servers in ``join`` come back online
    and servers in ``leave`` drop out (applied join-first, so a server may
    rejoin and immediately leave again in the same storm)."""

    time: float
    leave: Tuple[int, ...] = ()
    join: Tuple[int, ...] = ()


def churn_schedule(n_servers: int, n_storms: int, storm_size: int,
                   first: float = 60.0, spacing: float = 60.0, seed: int = 0,
                   protect: Sequence[int] = ()) -> List[ChurnEvent]:
    """Timed join/leave storms for elastic-fleet studies: each storm
    revives the previous storm's victims and knocks out ``storm_size``
    fresh random servers (never those in ``protect``), keeping the fleet
    size roughly constant between storms.  Feed the schedule to
    ``repro_torch.sim.simulate_churn``, which maps each storm onto
    ``OnlineBPRR.replace_servers`` (the ``RouteCostCache`` invalidation
    path)."""
    rng = np.random.default_rng(seed)
    pool = np.asarray([j for j in range(n_servers) if j not in set(protect)])
    if storm_size > len(pool):
        raise ValueError("storm_size exceeds the non-protected fleet")
    events: List[ChurnEvent] = []
    down: Tuple[int, ...] = ()
    for s in range(n_storms):
        leave = tuple(sorted(int(j) for j in
                             rng.choice(pool, size=storm_size, replace=False)))
        events.append(ChurnEvent(time=first + s * spacing,
                                 leave=leave, join=down))
        down = leave
    return events


def fault_schedule(n_servers: int, seed: int = 0, *, horizon: float = 10.0,
                   n_crashes: int = 1, n_transients: int = 0,
                   n_stragglers: int = 0, n_dispatch_errors: int = 0,
                   rejoin_after: float = 2.0, straggler_len: float = 2.0,
                   max_factor: float = 6.0, protect: Sequence[int] = ()):
    """Deterministic randomized fault plan for chaos studies — the fault
    analogue of :func:`churn_schedule`.  Returns a
    :class:`repro_torch.serving.faults.FaultPlan` drawing fail-stop crashes,
    crash-then-rejoin transients, straggler slowdown intervals, and
    admission-time dispatch errors from ``seed``.  The same plan drives
    the engine (``GeoServingSystem(fault_plan=...)``) and the analytic
    reference (``repro_torch.sim.simulate_faults``), so chaos tests can assert
    engine/simulator agreement under identical fault timelines."""
    from repro_torch.serving.faults import FaultPlan  # lazy: no torch at import
    return FaultPlan.random(
        n_servers, seed, horizon=horizon, n_crashes=n_crashes,
        n_transients=n_transients, n_stragglers=n_stragglers,
        n_dispatch_errors=n_dispatch_errors, rejoin_after=rejoin_after,
        straggler_len=straggler_len, max_factor=max_factor,
        protect=protect)


def prompts_for(requests: Sequence[Request], l_in: int, vocab_size: int,
                seed: int = 0) -> List[np.ndarray]:
    """Deterministic per-request prompt tokens (ids >= 2) of length l_in."""
    return prompts_for_lengths(requests, [l_in], vocab_size, seed=seed)


def prompts_for_lengths(requests: Sequence[Request], lengths: Sequence[int],
                        vocab_size: int, seed: int = 0) -> List[np.ndarray]:
    """Deterministic per-request prompts cycling through ``lengths`` —
    mixed-length traffic that exercises multi-bucket prefill groups."""
    rng = np.random.default_rng(seed + 7)
    return [rng.integers(2, vocab_size, size=int(lengths[i % len(lengths)]))
            for i in range(len(requests))]
