"""The port's geo serving engine against the JAX reference engine, on the
reduced llama3 with bridged weights, on the CPU.

* the examples/geo_serve.py scenario: identical ServedRequest tokens,
  start / wait / per-token virtual clocks and round_stats;
* analogs of tests/test_engine.py (engine vs monolithic, exact failover,
  dead-server avoidance, elastic join, straggler avoidance);
* solo-vs-grouped bit-exactness; fused == serial tokens and clocks;
  chunked prompts; contended admission; timeout-detected crashes.

Like the reference tests, nothing here holds the padded-bucket logits to
the serial ones bit for bit (the reference's own bucket tests are red):
streams are held to the monolithic streams instead.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro import serving as RS
from repro.configs import get_reduced_config
from repro.models import NULL_SH
from repro.models import decode_step as r_decode_step
from repro.models import init_params
from repro.models import prefill as r_prefill
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.sim.workload import poisson_requests
from repro_torch.weights import from_reference

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def model(n_layers=None):
    cfg = get_reduced_config("llama3_2_1b")
    tcfg = t_get_reduced_config("llama3_2_1b")
    if n_layers:
        cfg, tcfg = cfg.replace(n_layers=n_layers), \
            tcfg.replace(n_layers=n_layers)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, tcfg, from_reference(
        jax.tree.map(np.asarray, params), "cpu")


def geo_problem(C, cfg, mem=(500.0, 500.0, 220.0, 220.0, 220.0),
                cache=0.5, wl=(8, 16)):
    """examples/geo_serve.py's heterogeneous 5-server cluster."""
    llm = C.LLMSpec("llama3.2-reduced", cfg.n_layers, block_bytes=50.0,
                    cache_bytes_per_token=cache)
    taus = (0.004, 0.004, 0.020, 0.020, 0.020)
    servers = [C.ServerSpec(j, m, t) for j, (m, t) in enumerate(zip(mem,
                                                                    taus))]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
    return C.Problem(llm, servers, 1, rtt, 3 * rtt,
                     workload=C.Workload(*wl))


def engines(problem_fn, n_layers=8, **kw):
    """(reference system, port system) over the same problem."""
    cfg, params, tcfg, tparams = model(n_layers)
    ref = RS.GeoServingSystem(cfg, params, problem_fn(RC, cfg), **kw)
    port = TS.GeoServingSystem(tcfg, tparams, problem_fn(TC, tcfg),
                               device="cpu", **kw)
    return ref, port


def serve(system, sched_cls, reqs, R=4):
    sched = sched_cls(system, R=R)
    for rid, toks, arrival, n_new in reqs:
        sched.submit(rid, toks, arrival, n_new=n_new)
    return sched.run(), sched


def geo_requests(vocab, n=8, plen=8, n_new=12, rate=2.0):
    rng = np.random.RandomState(0)
    return [(r.rid, rng.randint(2, vocab, plen), r.arrival, n_new)
            for r in poisson_requests(n, rate=rate, seed=1)]


RECORD_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped", "n_deferrals",
                 "n_replays", "n_detections", "replay_time", "detect_time")


def assert_same_results(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for a, b in zip(ref_out, port_out):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RECORD_FIELDS:  # virtual clocks: bit-identical floats
            assert getattr(a, f) == getattr(b, f), (a.rid, f)


def test_geo_serve_scenario_identical():
    """examples/geo_serve.py on both engines: tokens, clocks, admission and
    the round dispatch accounting are identical."""
    ref, port = engines(lambda C, c: geo_problem(C, c), R=4,
                        max_new_tokens=16, max_sessions=8)
    assert list(ref.placement.a) == list(port.placement.a)
    assert list(ref.placement.m) == list(port.placement.m)
    reqs = geo_requests(64)
    r_out, r_sched = serve(ref, RS.ContinuousBatchingScheduler, reqs)
    p_out, p_sched = serve(port, TS.ContinuousBatchingScheduler, reqs)
    assert_same_results(r_out, p_out)
    assert ref.round_stats == port.round_stats
    assert r_sched.max_concurrency == p_sched.max_concurrency > 1
    assert port.slot_usage() == ref.slot_usage()


def test_contended_admission_deferrals_identical():
    """Tight block-slot budgets at a high arrival rate (the setup of
    tests/test_serving_batch.py::test_scheduler_invariants_under_load):
    both engines wait / defer the same sessions and drain to (0, cap)."""
    def prob(C, cfg):
        llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=50.0,
                        cache_bytes_per_token=1.0)
        servers = [C.ServerSpec(j, mem_bytes=180.0, tau=0.01 * (j + 1),
                                tau_prefill_base=0.002,
                                tau_prefill_per_token=0.0005)
                   for j in range(4)]
        rtt = np.full((1, 4), 0.02)
        return C.Problem(llm, servers, 1, rtt, 3 * rtt,
                         workload=C.Workload(4, 6))

    ref, port = engines(prob, n_layers=None, R=1, max_new_tokens=6,
                        max_sessions=4)
    rng = np.random.RandomState(3)
    reqs = [(r.rid, rng.randint(2, 256, 4), r.arrival, 6)
            for r in poisson_requests(8, rate=20.0, seed=4)]
    r_out, _ = serve(ref, RS.ContinuousBatchingScheduler, reqs, R=1)
    p_out, _ = serve(port, TS.ContinuousBatchingScheduler, reqs, R=1)
    assert_same_results(r_out, p_out)
    assert any(o.wait > 0 or o.n_deferrals for o in p_out)
    assert all(used == 0 for used, _ in port.slot_usage().values())


# ---------------------------------------------------------------------------
# analogs of tests/test_engine.py
# ---------------------------------------------------------------------------


def _setup(n_servers=4, R=2, **kw):
    cfg, params, tcfg, tparams = model()
    llm = TC.LLMSpec("toy", tcfg.n_layers, block_bytes=100.0,
                     cache_bytes_per_token=1.0)
    servers = [TC.ServerSpec(j, mem_bytes=500.0, tau=0.01 * (j + 1))
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    prob = TC.Problem(llm, servers, 1, rtt, rtt * 3,
                      workload=TC.Workload(4, 8))
    system = TS.GeoServingSystem(tcfg, tparams, prob, algorithm="proposed",
                                 R=R, device="cpu", **kw)
    return cfg, params, prob, system


def _reference_tokens(cfg, params, toks, n_new):
    """The reference's monolithic greedy stream."""
    logits, caches = r_prefill(params, cfg, NULL_SH,
                               {"tokens": jnp.asarray(toks)[None]},
                               cache_len=len(toks) + n_new + 4)
    seq = [int(jnp.argmax(logits[0]))]
    pos = len(toks)
    for _ in range(n_new - 1):
        lg, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), pos)
        seq.append(int(jnp.argmax(lg[0])))
        pos += 1
    return seq


def test_engine_matches_monolithic():
    cfg, params, prob, system = _setup()
    toks = np.random.RandomState(0).randint(2, cfg.vocab_size, 7)
    out, vt = TS.generate(system, toks, 5)
    assert list(out[len(toks): len(toks) + 5]) == \
        _reference_tokens(cfg, params, toks, 5)
    ref_sys = RS.GeoServingSystem(cfg, params, geo_prob_of(prob),
                                  algorithm="proposed", R=2)
    r_out, r_vt = RS.generate(ref_sys, toks, 5)
    assert vt == r_vt and list(out) == list(r_out)


def geo_prob_of(tprob):
    """The same Problem built with the reference's core."""
    llm = RC.LLMSpec(tprob.llm.name, tprob.llm.n_blocks,
                     block_bytes=tprob.llm.block_bytes,
                     cache_bytes_per_token=tprob.llm.cache_bytes_per_token)
    servers = [RC.ServerSpec(s.sid, s.mem_bytes, s.tau)
               for s in tprob.servers]
    return RC.Problem(llm, servers, tprob.n_clients, tprob.rtt_token,
                      tprob.rtt_prefill,
                      workload=RC.Workload(tprob.workload.l_in,
                                           tprob.workload.l_out))


@pytest.mark.parametrize("decode_mode", ["fused", "serial"])
def test_failover_recovery_exact(decode_mode):
    """Kill the first route server mid-generation: the replayed caches give
    the identical stream, and the clock bills the same replay as the
    reference."""
    cfg, params, prob, system = _setup(decode_mode=decode_mode)
    toks = np.random.RandomState(0).randint(2, cfg.vocab_size, 7)
    ref = _reference_tokens(cfg, params, toks, 5)
    sid, logits = system.submit(toks)
    seq = [int(torch.argmax(logits[0]))]
    lg = system.decode(sid, seq[-1])
    seq.append(int(torch.argmax(lg[0])))
    victim = system.sessions[sid].route.servers[0]
    system.kill_server(victim)
    for _ in range(3):
        lg = system.decode(sid, seq[-1])
        seq.append(int(torch.argmax(lg[0])))
    assert seq == ref, "post-failover generation must be identical"
    assert victim not in system.sessions[sid].route.servers
    assert system.round_stats["replays"] == 1
    rsys = RS.GeoServingSystem(cfg, params, geo_prob_of(prob),
                               algorithm="proposed", R=2)
    rsid, _ = rsys.submit(toks)
    rsys.decode(rsid, seq[0])
    rsys.kill_server(victim)
    for t in seq[1:4]:
        rsys.decode(rsid, t)
    assert rsys.sessions[rsid].virtual_time == \
        system.sessions[sid].virtual_time
    r_route, p_route = rsys.sessions[rsid].route, system.sessions[sid].route
    assert (r_route.servers, r_route.blocks) == \
        (p_route.servers, p_route.blocks)


def test_new_sessions_avoid_dead_servers():
    cfg, params, prob, system = _setup()
    system.kill_server(0)
    sid, _ = system.submit(np.random.RandomState(1).randint(2, 256, 5))
    assert 0 not in system.sessions[sid].route.servers


def test_elastic_join():
    cfg, params, prob, system = _setup(n_servers=2)
    system.join_server(TC.ServerSpec(99, mem_bytes=500.0, tau=0.001),
                       rtt_token_col=[0.02], rtt_prefill_col=[0.06])
    assert system.problem.n_servers == 3
    sid, _ = system.submit(np.random.RandomState(2).randint(2, 256, 5))
    assert 2 in system.sessions[sid].route.servers


def test_straggler_avoidance():
    cfg, params, prob, system = _setup(n_servers=4)
    toks = np.random.RandomState(3).randint(2, 256, 5)
    sid0, _ = system.submit(toks)
    fast_route = system.sessions[sid0].route.servers
    system.finish(sid0)
    system.set_slowdown(int(fast_route[0]), 100.0)
    sid1, _ = system.submit(toks)
    assert system.sessions[sid1].route.servers[0] != fast_route[0]


# ---------------------------------------------------------------------------
# batching invariants of the port itself
# ---------------------------------------------------------------------------


def _port(**kw):
    _, _, tcfg, tparams = model(8)
    return TS.GeoServingSystem(tcfg, tparams, geo_problem(TC, tcfg), R=4,
                               max_new_tokens=16, max_sessions=8,
                               device="cpu", **kw)


def _run_rounds(system, prompts, n_rounds):
    route, _ = TC.shortest_path_route(system.problem, system.placement, 0)
    sids = [system.create_session(p, 0, route, n_new=n_rounds + 1)
            for p in prompts]
    assert system.try_admit_sessions(sids) == sids
    system.drain_prefill()
    for _ in range(n_rounds):
        system.decode_round()
    return [system.sessions[s] for s in sids]


def test_solo_vs_grouped_bit_exact():
    """A session's logits are bit-identical whether it is prefilled and
    decoded alone or beside neighbours: fixed-shape pooled steps and round
    buffers, rows computed independently."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(2, 256, n) for n in (7, 5, 8, 6)]
    solo = _run_rounds(_port(), prompts[:1], 4)[0]
    grouped = _run_rounds(_port(), prompts, 4)[0]
    assert solo.tokens == grouped.tokens
    assert torch.equal(solo.last_logits, grouped.last_logits)
    assert solo.virtual_time == grouped.virtual_time


def test_fused_equals_serial():
    """decode_mode fused == serial: identical tokens and virtual clocks;
    logits to float rounding (one GEMM over W slots vs width 1)."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, 256, n) for n in (7, 5, 8)]
    fused = _run_rounds(_port(decode_mode="fused"), prompts, 5)
    serial = _run_rounds(_port(decode_mode="serial"), prompts, 5)
    for a, b in zip(fused, serial):
        assert a.tokens == b.tokens and a.virtual_time == b.virtual_time
        np.testing.assert_allclose(a.last_logits.numpy(),
                                   b.last_logits.numpy(), rtol=2e-4,
                                   atol=1e-5)
    sf = _port(decode_mode="fused")
    _run_rounds(sf, prompts, 3)
    rs = sf.round_stats
    assert rs["embed_dispatches"] == rs["tail_dispatches"] == rs["rounds"] \
        == 3


@pytest.mark.parametrize("prefill_mode,buckets", [("serial", None),
                                                  ("batched", (4,))])
def test_prefill_modes_match_monolithic(prefill_mode, buckets):
    """Serial exact-length prefill and chunked bucket prefill (prompts
    longer than the largest bucket) give the monolithic streams."""
    cfg, params, tcfg, tparams = model(8)
    system = TS.GeoServingSystem(tcfg, tparams, geo_problem(TC, tcfg), R=4,
                                 max_new_tokens=16, device="cpu",
                                 prefill_mode=prefill_mode,
                                 prefill_buckets=buckets)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(2, 256, n) for n in (9, 6)]
    sess = _run_rounds(system, prompts, 4)
    for s, p in zip(sess, prompts):
        assert s.tokens[len(p):] == _reference_tokens(cfg, params, p, 5)


def test_inject_crash_detection_identical():
    """A timeout-detected crash mid-run: both engines bill the same
    detection, backoff and replay and keep the streams."""
    ref, port = engines(lambda C, c: geo_problem(C, c), R=4,
                        max_new_tokens=16, max_sessions=8)
    reqs = geo_requests(64, n=3, n_new=8, rate=50.0)
    outs = []
    for system, S in ((ref, RS), (port, TS)):
        sched = S.ContinuousBatchingScheduler(system, R=4)
        for rid, toks, arrival, n_new in reqs:
            sched.submit(rid, toks, arrival, n_new=n_new)
        route, _ = (RC if S is RS else TC).shortest_path_route(
            system.problem, system.placement, 0)
        system.inject_crash(int(route.servers[0]))
        outs.append(sched.run())
    assert_same_results(*outs)
    assert ref.round_stats == port.round_stats
    assert port.round_stats["detections"] > 0


def test_fault_plan_identical():
    """The same seeded FaultPlan (a crash with rejoin, a straggler, an
    admission dispatch error) on both engines: identical streams, drops,
    clocks and round_stats."""
    from repro.serving.faults import FaultPlan as RPlan
    from repro_torch.serving.faults import FaultPlan as TPlan

    kw = dict(horizon=4.0, n_crashes=0, n_transients=1, n_stragglers=1,
              n_dispatch_errors=1, rejoin_after=1.0)
    ref, port = engines(lambda C, c: geo_problem(C, c), R=4,
                        max_new_tokens=16, max_sessions=8)
    ref.fault_plan, port.fault_plan = RPlan.random(5, 1, **kw), \
        TPlan.random(5, 1, **kw)
    reqs = geo_requests(64, n=6, n_new=10)
    r_out, _ = serve(ref, RS.ContinuousBatchingScheduler, reqs)
    p_out, _ = serve(port, TS.ContinuousBatchingScheduler, reqs)
    assert_same_results(r_out, p_out)
    assert [o.fail_reason for o in r_out] == [o.fail_reason for o in p_out]
    assert ref.round_stats == port.round_stats
    assert port.round_stats["rejoins"] == 1
    assert port.round_stats["dispatch_errors"] == 1


def test_later_slices_raise():
    """Device groups (ROADMAP A10, serving half) take a ``GroupMesh`` or a
    ``DeviceGroup`` per server (parity in tests/test_torch_groups.py);
    anything else raises ``TypeError``.  τ calibration
    (tests/test_torch_costs.py), paged pools and seeded sampling have
    their parity tests (tests/test_torch_paged.py,
    tests/test_torch_sampling.py)."""
    from repro_torch.launch.mesh import GroupMesh

    for kw in ({"mesh": object()}, {"device_groups": {0: object()}}):
        with pytest.raises(TypeError, match="GroupMesh"):
            _port(**kw)
    mesh = GroupMesh(np.full((1, 2), "cpu", dtype=object))
    for kw in ({"mesh": mesh}, {"device_groups": {0: mesh}}):
        assert _port(**kw).servers[0].n_chips == 2
    taus = _port().calibrate_taus()
    assert all(np.isfinite(t) and t > 0 for t in taus.values())


# ---------------------------------------------------------------------------
# Routes the engine's servers do not host (ROADMAP C1)
# ---------------------------------------------------------------------------


def test_create_session_rejects_unhosted_route():
    """A hop whose block range its server does not host raises, naming
    the hop, the server and the range (the reference's layer masks would
    skip those blocks without a word)."""
    _, port = engines(lambda C, c: geo_problem(C, c), R=4,
                      max_new_tokens=16, max_sessions=8)
    pl, L = port.placement, port.cfg.n_layers
    j = next(j for j in range(len(pl.m)) if 0 < pl.m[j] < L)
    route = TC.Route(servers=(j,), blocks=(L,))
    with pytest.raises(ValueError, match=rf"hop 0: server {j} does not "
                       rf"host blocks \[0, {L}\) \(it hosts "
                       rf"\[{pl.a[j]}, {pl.a[j] + pl.m[j]}\)\)"):
        port.create_session(np.arange(2, 8), 0, route, 4)
    assert not port.sessions
    good, _ = TC.shortest_path_route(port.problem, pl, 0)
    assert port.create_session(np.arange(2, 8), 0, good, 4) == 0


def _recording(system):
    """Wrap ``create_session`` to record (any server dead, route hosted by
    the live servers) for every route handed to the engine."""
    seen = []
    create = system.create_session

    def hosted(route):
        pl = system.alive_placement()
        e = 0
        for j, k in zip(route.servers, route.blocks):
            if not (pl.m[j] > 0 and pl.a[j] <= e
                    and e + k <= pl.a[j] + pl.m[j]):
                return False
            e += k
        return True

    def rec(tokens, client, route, *a, **kw):
        seen.append((any(not s.alive for s in system.servers.values()),
                     hosted(route)))
        return create(tokens, client, route, *a, **kw)

    system.create_session = rec
    return seen


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("mem,reference_hosted", [
    ((500.0, 500.0, 220.0, 220.0, 220.0), False),
    ((900.0, 900.0, 400.0, 400.0, 400.0), True),
])
def test_crash_under_scheduler_routes_stay_hosted(layout, mem,
                                                  reference_hosted):
    """Server 0 crashes at t = 1 under the scheduler; after the detection
    the controller re-routes.  The port routes on the engine's placement
    minus the dead server, so every route it hands out is hosted.  On the
    examples/geo_serve.py cluster the reference's CG-BP rerun hands out
    only unhosted routes after the crash; on a roomier cluster its routes
    stay hosted, and there the port's streams, clocks and round_stats equal
    the reference's."""
    from repro.serving.faults import FaultEvent as REvent
    from repro.serving.faults import FaultPlan as RPlan
    from repro_torch.serving.faults import FaultEvent as TEvent
    from repro_torch.serving.faults import FaultPlan as TPlan

    ref, port = engines(lambda C, c: geo_problem(C, c, mem=mem), R=4,
                        max_new_tokens=16, max_sessions=8,
                        cache_layout=layout,
                        page_size=4 if layout == "paged" else None)
    ref.fault_plan = RPlan((REvent(1.0, "crash", 0),))
    port.fault_plan = TPlan((TEvent(1.0, "crash", 0),))
    r_seen, p_seen = _recording(ref), _recording(port)
    reqs = geo_requests(64, n=14, n_new=10, rate=3.0)
    r_out, _ = serve(ref, RS.ContinuousBatchingScheduler, reqs)
    p_out, _ = serve(port, TS.ContinuousBatchingScheduler, reqs)
    assert port.round_stats["detections"] == 1
    assert not port.servers[0].alive
    after = [h for dead, h in p_seen if dead]
    assert after and all(h for _, h in p_seen)
    r_after = [h for dead, h in r_seen if dead]
    assert r_after and all(r_after) == reference_hosted
    if reference_hosted:
        assert_same_results(r_out, p_out)
        assert ref.round_stats == port.round_stats
    else:
        assert not any(r_after)
