"""Continuous-batching scheduler: OnlineBPRR (Alg. 2) driving the geo engine
with interleaved sessions — a copy of the reference's
``repro/serving/scheduler.py`` driving the port's engine.

The controller decides WHEN a request may start — WS-RR waiting under the
design concurrency |R| (eq. (20)) on the virtual clock — while the engine
executes the actual block-level computation with all temporally-overlapping
sessions sharing the per-server cache pools (one jitted step per server per
round).  The event loop:

  arrival  →  OnlineBPRR.admit (WS-RR route + committed start)
  start    →  same-timestamp starts are COALESCED into one batch:
              engine.try_admit_sessions claims slots and groups the
              admitted sessions by (route, prompt-length bucket) for
              batched prefill; chunk rounds then interleave with decode
              rounds so long prompts never head-of-line block resident
              sessions.  A start that would overbook cache slots is
              DEFERRED and re-admitted at the next retirement
              (no-overbooking invariant)
  end      →  co-resident sessions decode in shared batched rounds until the
              ending session has all its tokens; it then retires, frees its
              block-slots, and deferred sessions are re-admitted

Every decode round the loop drives is device-resident by default
(``GeoServingSystem.decode_round`` with ``decode_mode="fused"``): the
round costs one batched embed, one fused dispatch per (hop, server), one
lm_head+argmax tail, and exactly one host sync — the scheduler's
per-round Python overhead is bookkeeping, not data movement
(``round_stats`` surfaces the engine's dispatch accounting).

Within a client, starts are FIFO (a later arrival never overtakes an
earlier one of the same client).  Used by chip_smoke.py and the port's
parity tests.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.online import OnlineBPRR
from repro_torch.serving.engine import GeoServingSystem
from repro_torch.serving.kv_cache import pages_for
from repro_torch.serving.sampling import SamplingSpec


@dataclass
class ServedRequest:
    """Per-request result record: the §4.1 latency metrics on the virtual
    clock (wait, first-token, per-token) plus the generated tokens and the
    deferral/drop bookkeeping."""

    rid: int
    arrival: float
    start: float
    first_token: float  # wait + prefill (virtual)
    per_token: float  # (wait + total service) / n_new — paper's §4.1 metric
    total: float  # wait + service
    tokens: np.ndarray
    wait: float = 0.0
    per_token_rest: float = 0.0  # decode-phase per-token time
    dropped: bool = False
    # machine-readable reason when dropped ("no_route", "no_capacity",
    # "server_lost_mid_prefill", "admission_rejected", ...); None otherwise
    fail_reason: Optional[str] = None
    n_deferrals: int = 0
    # times the session was swapped out mid-generation (page pressure on
    # the paged layout, or a capacity-starved failover deferral)
    n_preemptions: int = 0
    # failure-recovery accounting mirrored off the engine session (see
    # docs/concurrency.md "Failure model"): timeout detections, backoff
    # probes, billed cache replays, and their virtual-clock costs
    n_detections: int = 0
    n_retries: int = 0
    n_replays: int = 0
    detect_time: float = 0.0
    backoff_time: float = 0.0
    replay_time: float = 0.0

    @property
    def recovery_time(self) -> float:
        return self.detect_time + self.backoff_time + self.replay_time


@dataclass
class _Pending:
    rid: int
    tokens: np.ndarray
    arrival: float
    n_new: int
    client: int
    frames: Optional[np.ndarray] = None  # encoder input (enc-dec stacks)
    sampling: Optional[SamplingSpec] = None  # None = greedy
    sid: int = -1
    sid_ctl: int = -1
    deferrals: int = 0


def _slot_scale(system: GeoServingSystem) -> float:
    """Page-granular eq. (20) capacity multiplier for the controller.

    The slab layout books a worst-case slot of ``s_c`` bytes (``l_in +
    l_out`` tokens) per block, so the controller's ⌊(M_j − s_m·m_j)/s_c⌋
    capacity is exact (scale 1).  Paged admission books only the PROMPT's
    pages — ``pages_for(l_in) · page_size`` tokens — and sessions grow
    page by page afterwards, preempting under pressure; the controller's
    CG-BP reservation and eq. (20) waiting times see that admission
    footprint, so ``s_c`` shrinks by ``total_tokens /
    prompt_page_tokens``."""
    if system.cache_layout != "paged":
        return 1.0
    wl = system.problem.workload
    booked_tokens = pages_for(min(int(wl.l_in), system.max_seq_len),
                              system.page_size) * system.page_size
    return wl.total_tokens / max(1, booked_tokens)


class ContinuousBatchingScheduler:
    """Admission + continuous batching over a :class:`GeoServingSystem`."""

    # event-kind priorities at equal timestamps: retire first (freed slots
    # visible to later decisions), then ALL arrivals, then starts.  Arrivals
    # only touch controller bookkeeping — never engine slots — so admitting
    # them before same-time starts changes no decision, and it guarantees a
    # same-timestamp burst's zero-wait starts are all in the heap before the
    # first one pops: they coalesce into one bucket-group admission batch.
    _END, _ARRIVAL, _START = 0, 1, 2

    def __init__(self, system: GeoServingSystem, R: Optional[int] = None,
                 arrival_rate: float = 0.1):
        self.system = system
        self.controller = OnlineBPRR(system.problem, R=R,
                                     arrival_rate=arrival_rate,
                                     slot_scale=_slot_scale(system),
                                     placement=system.placement)
        # fault sync state: servers the controller already knows are dead /
        # suspected (diffed against the engine at every event)
        self._known_dead: frozenset = frozenset()
        self._known_suspected: frozenset = frozenset()
        self._events: List[Tuple[float, int, int, int]] = []  # (t,prio,seq,i)
        self._seq = itertools.count()
        self._requests: List[_Pending] = []
        self._deferred: List[int] = []  # indices into _requests
        self._last_start: Dict[int, float] = {}  # FIFO-within-client clamp
        self.results: Dict[int, ServedRequest] = {}
        self.max_concurrency = 0

    @property
    def round_stats(self) -> Dict[str, int]:
        """The engine's per-round dispatch accounting (rounds driven, embed
        / round-tail / fused-hop dispatches) — the device-resident round
        contract chip_smoke.py and the parity tests check."""
        return self.system.round_stats

    # ------------------------------------------------------------------
    def submit(self, rid: int, tokens: np.ndarray, arrival: float,
               n_new: int, client: int = 0, frames=None, sampling=None):
        """Enqueue one request (no compute until ``run``).

        ``frames``: encoder input for enc-dec stacks; ``sampling``: the
        session's ``SamplingSpec`` (None = greedy)."""
        idx = len(self._requests)
        self._requests.append(_Pending(rid, np.asarray(tokens),
                                       float(arrival), int(n_new),
                                       int(client), frames=frames,
                                       sampling=sampling))
        heapq.heappush(self._events,
                       (float(arrival), self._ARRIVAL, next(self._seq), idx))

    # ------------------------------------------------------------------
    def run(self) -> List[ServedRequest]:
        """Drive the event loop until every submitted request completes.
        Returns ServedRequests in rid order."""
        while self._events:
            t, prio, _, idx = heapq.heappop(self._events)
            self._sync_faults(t)
            if prio == self._ARRIVAL:
                self._on_arrival(t, idx)
            elif prio == self._START:
                # coalesce same-timestamp starts into one admission batch —
                # they form the engine's bucket groups for batched prefill
                idxs = [idx]
                while (self._events and self._events[0][0] == t
                       and self._events[0][1] == self._START):
                    idxs.append(heapq.heappop(self._events)[3])
                self._on_start(t, idxs)
            else:
                self._on_end(t, idx)
        # nothing left to retire: permanently-deferred sessions can never be
        # re-admitted — surface them as drops instead of vanishing
        for didx in self._deferred:
            req = self._requests[didx]
            sess = self.system.retire_session(req.sid)
            self.controller.finish(req.sid_ctl)
            self._drop(req, reason="no_capacity", sess=sess)
        self._deferred = []
        return [self.results[r.rid] for r in
                sorted(self._requests, key=lambda r: r.rid)
                if r.rid in self.results]

    def _sync_faults(self, t: float):
        """Mirror the engine's fault state into the controller: apply
        FaultPlan events due by the event clock, re-place over the
        surviving fleet when the dead set changes (``replace_servers``
        with 0-memory dead hosts — a rejoined server re-enters with an
        empty pool engine-side), and keep suspicion penalties on every
        server ever declared dead by timeout (flap-avoidance routing)."""
        system = self.system
        if (system.fault_plan is None and not self._known_dead
                and not self._known_suspected):
            return  # fault-free run: keep the hot path free of diffing
        system.apply_faults(t)
        dead = frozenset(j for j, srv in system.servers.items()
                         if not srv.alive)
        suspected = frozenset(system.suspected_servers())
        for j in suspected - self._known_suspected:
            self.controller.set_suspicion(
                j, system.detector.suspicion_penalty)
        if dead != self._known_dead:
            from repro_torch.sim.simulator import _problem_with_dead
            self.controller.replace_servers(
                _problem_with_dead(system.problem, dead),
                placement=system.alive_placement())
        self._known_dead = dead
        self._known_suspected = suspected

    def _drop(self, req: _Pending, reason: Optional[str] = None,
              sess=None):
        rec = ServedRequest(
            rid=req.rid, arrival=req.arrival, start=np.inf,
            first_token=np.inf, per_token=np.inf, total=np.inf,
            tokens=np.asarray(req.tokens), wait=np.inf, dropped=True,
            fail_reason=reason, n_deferrals=req.deferrals)
        if sess is not None:
            self._copy_failure_counters(rec, sess)
        self.results[req.rid] = rec

    @staticmethod
    def _copy_failure_counters(rec: ServedRequest, sess):
        rec.n_preemptions = sess.n_preemptions
        rec.n_detections = sess.n_detections
        rec.n_retries = sess.n_retries
        rec.n_replays = sess.n_replays
        rec.detect_time = sess.detect_time
        rec.backoff_time = sess.backoff_time
        rec.replay_time = sess.replay_time

    # ------------------------------------------------------------------
    def _on_arrival(self, t: float, idx: int):
        req = self._requests[idx]
        route, start, _end, sid_ctl = self.controller.admit(req.client, t)
        if route is None:
            self._drop(req, reason="no_route")
            return
        # FIFO within client: never overtake an earlier same-client start
        start = max(start, self._last_start.get(req.client, -np.inf))
        self._last_start[req.client] = start
        req.sid_ctl = sid_ctl
        req.sid = self.system.create_session(req.tokens, req.client, route,
                                             req.n_new, arrival=req.arrival,
                                             frames=req.frames,
                                             sampling=req.sampling)
        heapq.heappush(self._events,
                       (float(start), self._START, next(self._seq), idx))

    def _drain_prefill_interleaved(self):
        """Advance pending prompt chunks one round at a time, giving the
        resident active sessions a decode round between chunks (no
        head-of-line blocking by long prompts)."""
        while self.system.has_pending_prefill():
            self.system.prefill_round()
            if self.system.has_pending_prefill():
                self.system.decode_round()

    def _on_start(self, t: float, idxs: List[int]):
        """Admit a batch of same-timestamp starts.  The engine coalesces
        the fitting ones into (route, bucket) prefill groups."""
        cands: List[int] = []
        for idx in idxs:
            req = self._requests[idx]
            # FIFO within client is head-of-line: while an earlier
            # same-client request sits deferred, later ones queue behind it
            # instead of overtaking via a different route
            if any(self._requests[d].client == req.client
                   for d in self._deferred):
                req.deferrals += 1
                self._deferred.append(idx)
            else:
                cands.append(idx)
        if not cands:
            return
        admitted = set(self.system.try_admit_sessions(
            [self._requests[i].sid for i in cands], now=t))
        self._drain_prefill_interleaved()
        for idx in cands:
            req = self._requests[idx]
            if req.sid in admitted:
                sess = self.system.sessions[req.sid]
                heapq.heappush(
                    self._events,
                    (float(sess.end), self._END, next(self._seq), idx))
                self.max_concurrency = max(self.max_concurrency,
                                           self.system.concurrency())
            else:
                # cache-slot budget exhausted (or queued behind a same-batch
                # predecessor): defer, re-admit on retirement
                req.deferrals += 1
                self._deferred.append(idx)

    def _on_end(self, t: float, idx: int):
        req = self._requests[idx]
        sess = self.system.sessions[req.sid]
        # continuous batching: co-resident sessions share decode rounds until
        # the ending session has produced all its tokens.  A session may
        # sit swapped out ("preempted": page pressure or a failover
        # deferral) between rounds — keep driving rounds; the engine's
        # resume queue brings it back.
        while (sess.state in ("active", "preempted")
               and sess.n_generated < sess.n_new):
            self.system.decode_round()
        done = self.system.retire_session(req.sid)
        self.controller.finish(req.sid_ctl)
        self._sync_faults(t)  # rounds above may have detected crashes
        if done.state == "failed":  # unservable failover mid-generation
            self._drop(req, reason=done.fail_reason or "no_route",
                       sess=done)
        else:
            wait = done.start - req.arrival
            # virtual_time is the accumulated TRUE service time — equals
            # prefill + (n_new-1)*per_token on a stable route plus any
            # billed recovery (detection + backoff + replay), and stays
            # correct when failover mid-generation changes the route cost
            service = done.virtual_time
            rec = ServedRequest(
                rid=req.rid, arrival=req.arrival, start=done.start,
                first_token=wait + done.prefill_time,
                per_token=(wait + service) / max(1, done.n_new),
                total=wait + service,
                tokens=np.asarray(done.tokens), wait=wait,
                per_token_rest=done.per_token_time,
                n_deferrals=req.deferrals)
            self._copy_failure_counters(rec, done)
            self.results[req.rid] = rec
        # re-admission: retry deferred sessions in FIFO order; a client whose
        # head-of-line request stays deferred keeps its later ones queued.
        # Admission goes one session at a time (exact FIFO semantics), but
        # chunked prompts still interleave their chunks with decode rounds.
        still: List[int] = []
        blocked_clients: set = set()
        for didx in self._deferred:
            dreq = self._requests[didx]
            if dreq.client not in blocked_clients and \
                    self.system.try_admit_sessions([dreq.sid], now=t):
                self._drain_prefill_interleaved()
                dsess = self.system.sessions[dreq.sid]
                heapq.heappush(
                    self._events,
                    (float(dsess.end), self._END, next(self._seq), didx))
                self.max_concurrency = max(self.max_concurrency,
                                           self.system.concurrency())
            else:
                blocked_clients.add(dreq.client)
                still.append(didx)
        self._deferred = still


# Backwards-compatible name: the old serial AdmissionScheduler is subsumed —
# one request at a time is just the R=1 special case of the event loop.
AdmissionScheduler = ContinuousBatchingScheduler
