"""Deterministic fault injection + failure-detection cost model.

PETALS-style geo-distributed serving treats server failure as a routine
event, not an exception: servers crash and rejoin, stragglers slow down,
and the client detects all of it by *timeout* — there is no oracle that
flips an ``alive`` bit the instant a machine dies (Borzunov et al.,
2209.01188; 2312.08361).  This module provides the pieces shared by the
real engine and the discrete-event simulator so both bill recovery the
same way on the virtual clock:

- :class:`FaultPlan` — a seedable, immutable schedule of fault events
  (fail-stop crashes, crash-then-rejoin transients, straggler slowdown
  intervals, admission-time dispatch errors).  The engine and the
  simulator replay the *same* plan, which is what makes the
  ``chaos.recovery`` bench row's engine-vs-sim cross-validation
  meaningful.
- :class:`FailureDetector` — the timeout/backoff policy: a hop dispatch
  that misses ``timeout_factor x`` the route's expected hop time marks
  the server *suspected*; ``max_probes`` retries follow with binary
  exponential backoff (mirroring ``sim.simulator._backoff_attempts``),
  and only then does the client splice the route.  Detection wait and
  backoff are both billed.
- :func:`recovery_replay_cost` — the eq. (1)-consistent price of
  rebuilding KV state on a replacement chain: per replaced hop, one
  input round-trip plus weighted prefill compute over the prompt, plus
  ``k*tau`` per replayed generated token.
- :class:`NoCapacityError` — typed "no free cache slots" failure so the
  scheduler can defer instead of hard-failing a session.

No jax imports here: the simulator side must stay importable without
pulling in the engine's device stack.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("crash", "rejoin", "straggler_start", "straggler_end",
               "dispatch_error")


class NoCapacityError(RuntimeError):
    """Failover/resume target set has no free cache slots right now.

    Transient by construction — capacity frees up as co-resident
    sessions retire — so callers (the scheduler, ``decode_round``'s
    resume path) should defer and retry rather than fail the session.
    """


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``factor`` is the tau multiplier for
    ``straggler_start`` events (ignored elsewhere)."""

    time: float
    kind: str
    server: int
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.kind == "straggler_start" and self.factor <= 1.0:
            raise ValueError("straggler_start needs factor > 1, got "
                             f"{self.factor}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted schedule of :class:`FaultEvent`.

    The plan itself is pure data; consumers keep their own cursor and
    call :meth:`due` to pop events, so one plan can drive the engine and
    the simulator independently.
    """

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.time, e.server))))

    def __len__(self) -> int:
        return len(self.events)

    def due(self, cursor: int, now: float) -> Tuple[List[FaultEvent], int]:
        """Events with ``time <= now`` starting at ``cursor``; returns
        ``(events, new_cursor)``."""
        out = []
        while cursor < len(self.events) and self.events[cursor].time <= now:
            out.append(self.events[cursor])
            cursor += 1
        return out, cursor

    @property
    def affected_servers(self) -> Tuple[int, ...]:
        return tuple(sorted({e.server for e in self.events}))

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    @staticmethod
    def random(n_servers: int, seed: int, *, horizon: float = 10.0,
               n_crashes: int = 1, n_transients: int = 0,
               n_stragglers: int = 0, n_dispatch_errors: int = 0,
               rejoin_after: float = 2.0, straggler_len: float = 2.0,
               max_factor: float = 6.0,
               protect: Sequence[int] = ()) -> "FaultPlan":
        """Seedable random plan over ``n_servers`` servers.

        ``n_crashes`` fail-stop crashes, ``n_transients`` crash+rejoin
        pairs, ``n_stragglers`` slowdown intervals, and
        ``n_dispatch_errors`` one-shot admission faults, all at uniform
        times in ``[horizon/10, horizon)``.  Servers in ``protect`` are
        never touched (keeps at least one chain coverable).  Distinct
        crash victims are preferred while enough servers exist.
        """
        rng = np.random.default_rng(seed)
        pool = [j for j in range(n_servers) if j not in set(protect)]
        if not pool:
            raise ValueError("every server is protected; nothing to fault")

        def pick(n: int, distinct_from: set) -> List[int]:
            fresh = [j for j in pool if j not in distinct_from]
            src = fresh if len(fresh) >= n else pool
            return [int(j) for j in
                    rng.choice(src, size=n, replace=len(src) < n)]

        def t() -> float:
            return float(rng.uniform(horizon / 10.0, horizon))

        events: List[FaultEvent] = []
        crashed: set = set()
        for j in pick(n_crashes, crashed):
            crashed.add(j)
            events.append(FaultEvent(t(), "crash", j))
        for j in pick(n_transients, crashed):
            crashed.add(j)
            t0 = t()
            events.append(FaultEvent(t0, "crash", j))
            events.append(FaultEvent(
                t0 + float(rng.uniform(0.5, 1.0)) * rejoin_after,
                "rejoin", j))
        for j in pick(n_stragglers, crashed):
            t0 = t()
            factor = float(rng.uniform(2.0, max_factor))
            events.append(FaultEvent(t0, "straggler_start", j, factor))
            events.append(FaultEvent(
                t0 + float(rng.uniform(0.5, 1.0)) * straggler_len,
                "straggler_end", j))
        for j in pick(n_dispatch_errors, set()):
            events.append(FaultEvent(t(), "dispatch_error", j))
        return FaultPlan(tuple(events))


@dataclasses.dataclass(frozen=True)
class FailureDetector:
    """Timeout + binary-exponential-backoff failure detection policy.

    A hop whose reply misses ``timeout_factor x`` the expected hop time
    is *suspected*; the client retries ``max_probes`` times, sleeping
    ``backoff_base, 2*backoff_base, ...`` (capped at ``backoff_cap``,
    the same shape as ``sim.simulator._backoff_attempts``) between
    probes, each probe again waiting out the deadline.  Only after the
    last probe fails is the server declared dead and the route spliced.
    ``suspicion_penalty`` is the additive routing-cost penalty a
    once-suspected server keeps until it proves itself again
    (flap avoidance in :class:`repro_torch.core.routing.RouteCostCache`).
    """

    timeout_factor: float = 3.0
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    max_probes: int = 3
    suspicion_penalty: float = 1.0

    def __post_init__(self):
        if self.timeout_factor <= 1.0:
            raise ValueError("timeout_factor must exceed 1")
        if self.max_probes < 0:
            raise ValueError("max_probes must be >= 0")

    def probe_delays(self) -> List[float]:
        """Backoff sleeps between the ``max_probes`` retries."""
        out, delay = [], self.backoff_base
        for _ in range(self.max_probes):
            out.append(delay)
            delay = min(delay * 2.0, self.backoff_cap)
        return out

    def detect_time(self, expected_hop: float) -> float:
        """Deadline waits: the initial miss plus one per probe."""
        return (1 + self.max_probes) * self.timeout_factor * expected_hop

    def backoff_time(self) -> float:
        return float(sum(self.probe_delays()))


def recovery_replay_cost(problem, client: int,
                         repl_routes: Iterable[Tuple[int, int, int]],
                         n_tokens: int,
                         slowdown_of=None,
                         l_in: Optional[int] = None) -> float:
    """Virtual-clock cost of rebuilding KV state on a replacement chain.

    ``repl_routes`` is the ``(server, lo, hi)`` block-range list a
    failover spliced in.  Per hop the client pays one input round-trip
    (``rtt_prefill``), the eq. (1)-weighted prefill compute over the
    prompt, and ``k*tau`` per replayed generated token — the same terms
    the engine bills for first-time prefill/decode, because replay *is*
    re-execution.  ``slowdown_of(j)`` supplies the live straggler
    multiplier (defaults to 1).
    """
    if l_in is None:
        l_in = problem.workload.l_in
    slow = slowdown_of if slowdown_of is not None else (lambda j: 1.0)
    cost = 0.0
    for j, lo, hi in repl_routes:
        w = problem.llm.tau_weight(lo, hi)
        s = float(slow(j))
        cost += (problem.rtt_prefill[client, j]
                 + w * problem.servers[j].tau_prefill(l_in) * s
                 + n_tokens * w * problem.servers[j].tau * s)
    return float(cost)
