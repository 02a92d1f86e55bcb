"""One run of one cell: weights from the seed, the port's serving system over
the cell's deployment, warm-up of the cell's own prefill buckets, then the
seeded trace driven through the port's scheduler with every engine call
stamped on the host clock, until the window closes.

The window opens at the round boundary after ``open_after_rounds`` rounds
of the trace and closes at the first round boundary ``seconds`` later,
which stops the event loop.  Each round of the port ends in its token
readback (the round's one host sync); the stamp after it also waits for
the stream, so a stamp is never earlier than the work it closes.
"""
from __future__ import annotations

import gc
import importlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROUNDS = ("prefill_round", "decode_round")
ENGINE_CALLS = ("try_admit_sessions",) + ROUNDS


def load_config(name: str) -> Dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def family(c: Dict):
    return importlib.import_module(f"families.{c['family']}")


def dims(c: Dict) -> Dict:
    return family(c).dims(c)


def put(tree: Dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def make_weights(c: Dict, seed: int, device) -> Dict:
    """The cell's weights, drawn on ``device`` from ``seed`` in the dtype
    they are served in: one ``randn`` per stacked leaf."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    tree: Dict = {}
    for path, shape, dtype, kind, std in family(c).weight_spec(c):
        t = torch.randn(shape, generator=g, device=device,
                        dtype=getattr(torch, dtype))
        t.mul_(std)
        if kind == "one":
            t.add_(1.0)
        put(tree, path, t)
    return tree


def deployment(c: Dict, t: Dict, rows: int):
    """The cell's BPRR problem: the configuration's servers (τ, RTT, block
    shares) with memory scaled for the traffic's nominal request, so that
    CG-BP at R = rows gives each server its block share and its pool rows:
    M_j = blocks_j (s_m + s_c rows) + s_c / 2."""
    import repro_torch.core as C

    dep = c["deployment"]
    n = dims(c)
    wl = C.Workload(int(t["nominal"]["l_in"]), int(t["nominal"]["l_out"]))
    s_c = dep["cache_bytes_per_token"] * wl.total_tokens
    mem = [b * (dep["block_bytes"] + s_c * rows) + 0.5 * s_c
           for b in dep["blocks"]]
    servers = [C.ServerSpec(j, m, tau) for j, (m, tau) in
               enumerate(zip(mem, dep["tau"]))]
    rtt = np.array([dep["rtt"]], dtype=float)
    llm = C.LLMSpec(c["model_type"], n["layers"],
                    block_bytes=dep["block_bytes"],
                    cache_bytes_per_token=dep["cache_bytes_per_token"])
    return C.Problem(llm, servers, 1, rtt, dep["prefill_rtt_factor"] * rtt,
                     workload=wl)


def build_system(c: Dict, t: Dict, rows: int, weights: Dict, device):
    """``GeoServingSystem`` over the cell's deployment, on the kernels,
    slab pools, fused decode rounds and batched prefill."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import GeoServingSystem

    cfg = family(c).port_config(c, ModelConfig)
    system = GeoServingSystem(
        cfg, weights, deployment(c, t, rows), algorithm="proposed", R=rows,
        max_new_tokens=int(t["new_tokens"]["max"]), max_sessions=rows,
        max_seq_len=int(t["max_seq_len"]), prefill_mode="batched",
        decode_mode="fused", backend="kernel", cache_layout="slab",
        device=device)
    n_rows = {j: s.pool.n_rows for j, s in system.servers.items()}
    m = [int(x) for x in system.placement.m]
    if m != list(c["deployment"]["blocks"]) or \
            min(n_rows.values()) != rows:
        raise RuntimeError(
            f"deployment: placement a={system.placement.a.tolist()} m={m} "
            f"rows {n_rows}: blocks {c['deployment']['blocks']} and {rows} "
            "rows a server expected")
    return system


def warm_up(system, t: Dict, vocab: int, device) -> List[int]:
    """One request at each prefill bucket the trace uses (one coalesced
    admission, then its decode rounds), through the same system: a prefill
    round runs every pool row at the bucket's length and a decode round
    the whole round width, so these are the shapes the window drives.
    Nothing else is warmed."""
    from repro_torch.serving import ContinuousBatchingScheduler

    buckets = traffic_mod.buckets_used(t, system.prefill_buckets)
    top = int(t["prompt_tokens"]["max"])
    rng = np.random.default_rng(0)
    sched = ContinuousBatchingScheduler(system, R=system.max_sessions)
    for i, b in enumerate(buckets):
        sched.submit(i, rng.integers(2, vocab, min(b, top)), 0.0, n_new=2)
    sched.run()
    sync(device)
    return buckets


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class WindowClosed(Exception):
    """Raised at the round boundary that closes the window: ends the event
    loop."""


@dataclass
class Session:
    prompt: List[int]
    n_new: int
    taken_up: float  # host stamp: the scheduler took up its arrival
    times: List[float] = field(default_factory=list)  # token stamps
    tokens: List[int] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return len(self.tokens) >= self.n_new


@dataclass
class Window:
    """What one run recorded: the stamps, the sessions, the rounds and
    (traced run) the kernel calls and the device trace.  The metric
    readers read it."""

    dims: Dict
    rows: int
    open_after: int
    seconds: float
    t_open: Optional[float] = None
    t_close: Optional[float] = None
    setup_s: float = 0.0
    n_rounds: int = 0
    # every engine call: (name, t0, t1, n) — n: sessions decoded (decode
    # round), live prompt tokens (prefill round), sessions admitted
    spans: List[tuple] = field(default_factory=list)
    # each prefill round's chunks: (t1, [(sid, offset, span, completes)])
    chunks: List[tuple] = field(default_factory=list)
    sessions: Dict[int, Session] = field(default_factory=dict)
    admitted: List[int] = field(default_factory=list)  # sids given rows
    k1: List[tuple] = field(default_factory=list)  # (flops, bytes)
    k2: List[tuple] = field(default_factory=list)
    device: Optional[object] = None  # devtrace.DeviceTrace (traced run)

    @property
    def wall(self) -> float:
        return self.t_close - self.t_open

    def inside(self, ts: float) -> bool:
        return self.t_open < ts <= self.t_close

    def round_spans(self, kind: str) -> List[tuple]:
        """The rounds of ``kind`` that ended inside the window."""
        return [s for s in self.spans if s[0] == kind and self.inside(s[2])]


def prefill_chunks(system) -> List[tuple]:
    """The chunk each pending prefill group runs in the next
    ``prefill_round``: [(sid, offset, live tokens, completes)], from the
    engine's groups and its chunk plan (padding excluded)."""
    out = []
    for g in system._prefill_groups:
        active = [s for s in g.members
                  if s.state == "prefilling" and s.prompt_len > g.offset]
        if not active:
            continue
        ref_len = max(s.prompt_len for s in active)
        t_pad = next(tp for off, _, tp in system._prefill_plan(ref_len)
                     if off == g.offset)
        for s in active:
            span = min(s.prompt_len - g.offset, t_pad)
            out.append((s.sid, g.offset, span,
                        g.offset + span >= s.prompt_len))
    return out


class Stamps:
    """Wraps the system's engine calls: stamps each on the host clock,
    records each session's tokens and each prefill round's chunks, and
    opens and closes the window."""

    def __init__(self, system, w: Window, device,
                 on_open: Callable = lambda: None,
                 clock: Callable = time.perf_counter):
        self.system, self.w, self.device = system, w, device
        self.on_open, self.clock = on_open, clock
        for name in ("create_session",) + ENGINE_CALLS:
            setattr(system, name, self._wrap(name, getattr(system, name)))

    def _wrap(self, name: str, fn):
        w, system = self.w, self.system

        def call(*a, **kw):
            if name in ROUNDS and w.t_open is None and \
                    w.n_rounds >= w.open_after:
                self.on_open()
                w.t_open = self.clock()
            chunks = prefill_chunks(system) if name == "prefill_round" \
                else None
            t0 = self.clock()
            out = fn(*a, **kw)
            if name == "create_session":
                n_new = a[3] if len(a) > 3 else kw["n_new"]
                w.sessions[out] = Session([int(x) for x in a[0]],
                                          int(n_new), t0)
                return out
            if name in ROUNDS:
                sync(self.device)
            t1 = self.clock()
            n = len(out)
            if name == "try_admit_sessions":
                w.admitted.extend(out)
            elif name == "decode_round":
                for sid, tok in out.items():
                    w.sessions[sid].times.append(t1)
                    w.sessions[sid].tokens.append(int(tok))
            elif name == "prefill_round":
                for sid in out:
                    w.sessions[sid].times.append(t1)
                    w.sessions[sid].tokens.append(
                        int(system.sessions[sid].tokens[-1]))
                w.chunks.append((t1, chunks))
                n = sum(span for _, _, span, _ in chunks)
            w.spans.append((name, t0, t1, n))
            if name in ROUNDS:
                w.n_rounds += 1
                if w.t_open is not None and t1 - w.t_open >= w.seconds:
                    w.t_close = t1
                    raise WindowClosed()
            return out

        return call


class KernelCalls:
    """Traced runs: the K1 / K2 calls of the window, read from a wrapper on
    the attributes the port's attention calls (``repro_torch.models.
    attention.decode_attention`` / ``flash_attention``).  A call's shapes
    and flags are kept at once; its per-row positions are copied on the
    device and read after the window, so the wrapper adds no host sync."""

    def __init__(self):
        from repro_torch.models import attention

        self.mod = attention
        self.real = (attention.decode_attention, attention.flash_attention)
        self.active = False
        self.k1: List[tuple] = []
        self.k2: List[tuple] = []

    def __enter__(self):
        real_k1, real_k2 = self.real

        def k1(q, ck, cv, pos, **kw):
            if self.active:
                kv_len = kw.get("kv_len")
                self.k1.append((
                    tuple(q.shape), tuple(ck.shape), tuple(cv.shape),
                    q.element_size(),
                    pos.clone() if torch.is_tensor(pos) else int(pos),
                    kw.get("window"),
                    kv_len.clone() if torch.is_tensor(kv_len) else kv_len,
                    kw.get("causal", True),
                    0 if kw.get("slopes") is None else kw["slopes"].numel(),
                    cv.data_ptr() == ck.data_ptr()))
            return real_k1(q, ck, cv, pos, **kw)

        def k2(q, k, v, **kw):
            if self.active:
                self.k2.append((
                    tuple(q.shape), tuple(k.shape), tuple(v.shape),
                    q.element_size(), kw.get("q_start", 0),
                    kw.get("window"), kw.get("causal", True),
                    0 if kw.get("slopes") is None else kw["slopes"].numel()))
            return real_k2(q, k, v, **kw)

        self.mod.decode_attention, self.mod.flash_attention = k1, k2
        return self

    def __exit__(self, *exc):
        self.mod.decode_attention, self.mod.flash_attention = self.real
        self.active = False

    def costs(self):
        """[(flops, bytes)] of every K1 and every K2 call (bench/costs.py),
        the positions read in one transfer."""
        import costs

        def rows(x, B):
            return [int(x)] * B if isinstance(x, int) else None

        dev_vals = [x for call in self.k1 for x in (call[4], call[6])
                    if torch.is_tensor(x)]
        flat = torch.cat([x.reshape(-1).to(torch.int64) for x in dev_vals]
                         ).tolist() if dev_vals else []
        it = iter(flat)
        k1 = []
        for (qs, ks, vs, es, pos, win, kvl, causal, ns, same) in self.k1:
            B = qs[0]
            p = rows(pos, B) or [next(it) for _ in range(B)]
            kl = None if kvl is None else (
                rows(kvl, B) or [next(it) for _ in range(B)])
            k1.append(costs.k1_cost(qs, ks, vs, p, es, window=win,
                                    kv_len=kl, causal=causal, n_slopes=ns,
                                    v_is_k=same))
        k2 = [costs.k2_cost(qs, ks, vs, es, q_start=qst, window=win,
                            causal=causal, n_slopes=ns)
              for (qs, ks, vs, es, qst, win, causal, ns) in self.k2]
        return k1, k2


def drive(system, t: Dict, requests, w: Window, device,
          on_open: Callable = lambda: None):
    """Submit the trace to the port's scheduler and drive ``run()`` until
    the window closes; returns the scheduler (its records of dropped
    requests).

    A closed-loop mix (``arrivals.closed_loop``) hands the scheduler its
    first ``rows`` requests at time 0 and each later one at the virtual
    time a session retires (its end), so the queue waits at the client and
    every retirement is refilled at the next admission; other mixes are
    submitted whole."""
    from repro_torch.serving import ContinuousBatchingScheduler

    Stamps(system, w, device, on_open=on_open)
    sched = ContinuousBatchingScheduler(system, R=w.rows)
    queue = list(requests)
    if t["arrivals"].get("closed_loop"):
        retire = system.retire_session

        def retire_and_refill(sid):
            done = retire(sid)
            if queue:
                r = queue.pop(0)
                sched.submit(r.rid, r.prompt, done.end, n_new=r.n_new)
            return done

        system.retire_session = retire_and_refill
        queue, first = queue[w.rows:], queue[:w.rows]
    else:
        queue, first = [], queue
    for r in first:
        sched.submit(r.rid, r.prompt, r.arrival, n_new=r.n_new)
    try:
        sched.run()
    except WindowClosed:
        return sched
    raise RuntimeError(
        f"the trace ran out before the window closed ({w.n_rounds} rounds, "
        f"window open: {w.t_open is not None}); it has to outlast the "
        "window")


def free() -> None:
    """Return what the dropped objects held to the card (the program's
    state goes before the reference runs)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
