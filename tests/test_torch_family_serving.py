"""The port's geo serving engine on RWKV6 and zamba2 stacks against the JAX
reference engine, on the reduced ``rwkv6_7b`` and ``zamba2_7b`` with
bridged weights, on the CPU.

* the scheduler over Poisson requests with prompts of several lengths:
  identical tokens, virtual clocks, admission/deferral and round_stats;
* engine vs the reference's monolithic prefill/decode: identical greedy
  streams, logits within tolerance;
* exact-length prefill groups; a nonzero chunk offset raises for
  recurrent state; solo-vs-grouped bit-exactness; fused == serial;
* a kill_server failover drill that replays exactly, against the
  reference engine's route, stream and clock.

Tolerances: logits at rtol 2e-4 / atol 1e-5 (the reference's own between
two compiled programs) for rwkv6; zamba2 at atol 1e-4 with the same rtol
— its recurrences amplify f32 rounding across layers (tests/
test_torch_ssm.py), and the reference's own engine misses atol 1e-5 on
zamba2 by 1.4e-5 (ROADMAP C).
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

ARCHS = ["rwkv6_7b", "zamba2_7b"]
LOGIT_TOL = {"rwkv6_7b": dict(rtol=2e-4, atol=1e-5),
             "zamba2_7b": dict(rtol=2e-4, atol=1e-4)}


@functools.lru_cache(maxsize=None)
def model(arch):
    cfg = get_reduced_config(arch)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, t_get_reduced_config(arch), from_reference(
        jax.tree.map(np.asarray, params), "cpu")


def problem(C, cfg, n_servers=4, mem=1000.0, wl=(4, 8)):
    """tests/test_family_pools.py's cluster: uniform memory, τ rising by
    server, prefill τ with a per-token term."""
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=mem, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3, workload=C.Workload(*wl))


def engines(arch, **kw):
    """(reference system, port system) over the same problem."""
    cfg, params, tcfg, tparams = model(arch)
    pkw = dict(kw.pop("problem_kw", {}))
    ref = RS.GeoServingSystem(cfg, params, problem(RC, cfg, **pkw), **kw)
    port = TS.GeoServingSystem(tcfg, tparams, problem(TC, tcfg, **pkw),
                               device="cpu", **kw)
    return ref, port


RECORD_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped", "n_deferrals",
                 "n_replays", "n_detections", "replay_time", "detect_time")


def serve(system, sched_cls, reqs, R):
    sched = sched_cls(system, R=R)
    for rid, toks, arrival, n_new in reqs:
        sched.submit(rid, toks, arrival, n_new=n_new)
    return sched.run(), sched


def _requests(vocab, lengths, n_new, rate, seed=0):
    rng = np.random.RandomState(seed)
    return [(r.rid, rng.randint(2, vocab, n), r.arrival, n_new)
            for r, n in zip(poisson_requests(len(lengths), rate=rate,
                                             seed=seed + 1), lengths)]


def _monolithic(cfg, params, toks, n_new):
    logits, caches = r_prefill(params, cfg, NULL_SH,
                               {"tokens": jnp.asarray(toks)[None]},
                               cache_len=len(toks) + n_new + 4)
    seq = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        lg, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), len(toks) + i)
        seq.append(int(jnp.argmax(lg[0])))
    return seq


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_identical_to_reference(arch):
    """Poisson requests with prompts of several lengths (exact-length
    groups) on a 4-server cluster: tokens, clocks, admission and round
    dispatch accounting identical; every stream equals the monolithic
    one."""
    ref, port = engines(arch, R=2, max_new_tokens=8, max_sessions=8)
    assert list(ref.placement.a) == list(port.placement.a)
    assert list(ref.placement.m) == list(port.placement.m)
    cfg, params, _, _ = model(arch)
    reqs = _requests(cfg.vocab_size, (5, 7, 5, 7, 5), 6, rate=4.0)
    r_out, r_sched = serve(ref, RS.ContinuousBatchingScheduler, reqs, R=2)
    p_out, p_sched = serve(port, TS.ContinuousBatchingScheduler, reqs, R=2)
    assert len(r_out) == len(p_out) == len(reqs)
    for a, b in zip(r_out, p_out):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert ref.round_stats == port.round_stats
    assert r_sched.max_concurrency == p_sched.max_concurrency > 1
    assert port.slot_usage() == ref.slot_usage()
    for (_, toks, _, n_new), out in list(zip(reqs, p_out))[:2]:
        assert list(out.tokens[len(toks):]) == \
            _monolithic(cfg, params, toks, n_new)


@pytest.mark.parametrize("arch", ARCHS)
def test_contended_admission_identical(arch):
    """Tight block-slot budgets at a high arrival rate: both engines wait
    and defer the same sessions, and drain to (0, cap)."""
    ref, port = engines(arch, R=1, max_new_tokens=6, max_sessions=4,
                        problem_kw=dict(mem=180.0 if arch == "rwkv6_7b"
                                        else 420.0))
    cfg = model(arch)[0]
    reqs = _requests(cfg.vocab_size, (4, 4, 6, 4, 6, 4, 4, 6), 5,
                     rate=20.0, seed=3)
    r_out, _ = serve(ref, RS.ContinuousBatchingScheduler, reqs, R=1)
    p_out, _ = serve(port, TS.ContinuousBatchingScheduler, reqs, R=1)
    for a, b in zip(r_out, p_out):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert any(o.wait > 0 or o.n_deferrals for o in p_out)
    assert all(used == 0 for used, _ in port.slot_usage().values())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_logits_match_reference(arch):
    """The legacy submit/decode API: first-step and decode logits against
    the reference engine's and the reference's monolithic
    prefill/decode_step; identical tokens and virtual clocks."""
    cfg, params, _, _ = model(arch)
    ref, port = engines(arch, R=2, max_new_tokens=8)
    toks = np.random.RandomState(0).randint(2, cfg.vocab_size, 6)
    sid, logits = port.submit(toks)
    rsid, r_logits = ref.submit(toks)
    rl, caches = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)[None]},
                           cache_len=len(toks) + 9)
    for want in (rl, r_logits):
        np.testing.assert_allclose(logits[0].numpy(), np.asarray(want[0]),
                                   **LOGIT_TOL[arch])
    seq = [int(jnp.argmax(rl[0]))]
    for i in range(4):
        rl, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), len(toks) + i)
        lg = port.decode(sid, seq[-1])
        r_lg = ref.decode(rsid, seq[-1])
        for want in (rl, r_lg):
            np.testing.assert_allclose(lg[0].numpy(), np.asarray(want[0]),
                                       **LOGIT_TOL[arch])
        seq.append(int(jnp.argmax(rl[0])))
        assert int(torch.argmax(lg[0])) == seq[-1]
    assert port.sessions[sid].virtual_time == ref.sessions[rsid].virtual_time
    port.finish(sid)


def _run_rounds(system, prompts, n_new, coalesce=True):
    """Admit (as one batch, or one by one), decode to ``n_new`` tokens;
    returns each session's (tokens, per-step logits)."""
    sids = []
    for p in prompts:
        route, _ = TC.shortest_path_route(system.problem,
                                          system.alive_placement(), 0)
        sids.append(system.create_session(p, 0, route, n_new))
    hist = {}
    order = [sids] if coalesce else [[s] for s in sids]
    for batch in order:
        assert system.try_admit_sessions(batch) == batch
        system.drain_prefill()
        for sid in batch:
            hist[sid] = [system.sessions[sid].last_logits.clone()]
        while True:
            todo = [s for s in batch
                    if system.sessions[s].n_generated < n_new]
            if not todo:
                break
            system.decode_round(todo)
            for sid in todo:
                hist[sid].append(system.sessions[sid].last_logits.clone())
    return [(list(system.sessions[s].tokens), hist[s]) for s in sids]


@pytest.mark.parametrize("arch", ARCHS)
def test_solo_vs_grouped_bit_exact(arch):
    """A session's logits are bit-identical whether it runs alone or beside
    neighbours of other lengths: fixed-shape pooled steps."""
    cfg = model(arch)[0]
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (4, 6, 4)]
    _, solo_sys = engines(arch, R=2, max_new_tokens=8)
    _, grp_sys = engines(arch, R=2, max_new_tokens=8)
    solo = _run_rounds(solo_sys, prompts, 4, coalesce=False)
    grouped = _run_rounds(grp_sys, prompts, 4, coalesce=True)
    for (ts, ls), (tg, lg) in zip(solo, grouped):
        assert ts == tg
        assert len(ls) == len(lg) == 4
        for a, b in zip(ls, lg):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_length_groups_and_offset_guard(arch):
    """Recurrent stacks never pad: equal lengths coalesce into one group,
    each a single exact-length shot — and a pooled prefill at a nonzero
    offset raises."""
    cfg = model(arch)[0]
    _, system = engines(arch, R=2, max_new_tokens=8)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (4, 7, 4)]
    sids = []
    for p in prompts:
        route, _ = TC.shortest_path_route(system.problem,
                                          system.alive_placement(), 0)
        sids.append(system.create_session(p, 0, route, 4))
    assert system.try_admit_sessions(sids) == sids
    groups = {(g.bucket, tuple(s.sid for s in g.members))
              for g in system._prefill_groups}
    assert groups == {(4, (sids[0], sids[2])), (7, (sids[1],))}
    assert system._prefill_plan(7) == [(0, 7, 7)]
    system.drain_prefill()
    assert all(system.sessions[s].state == "active" for s in sids)
    srv = next(iter(system.servers.values()))
    N = srv.pool.n_rows
    h = torch.zeros((N, 3, cfg.d_model))
    mask = torch.ones((srv.m, N), dtype=torch.bool)
    with pytest.raises(ValueError, match="nonzero chunk offset"):
        srv.prefill_rows(h, mask, offset=4,
                         emb0_rows=h if system._needs_emb0 else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_equals_serial_and_serial_prefill(arch):
    """decode_mode fused == serial, and prefill_mode serial == batched:
    identical tokens and virtual clocks, logits to float rounding."""
    cfg = model(arch)[0]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (7, 5, 7)]
    runs = {}
    for key, kw in {"fused": {}, "serial": dict(decode_mode="serial"),
                    "serial_prefill": dict(prefill_mode="serial")}.items():
        _, system = engines(arch, R=2, max_new_tokens=8, **kw)
        out = _run_rounds(system, prompts, 5)
        runs[key] = (out, [system.sessions[s].virtual_time
                           for s in system.sessions])
        if key == "fused":
            rs = system.round_stats
            assert rs["embed_dispatches"] == rs["tail_dispatches"] == \
                rs["rounds"] == 4
    base_out, base_vt = runs["fused"]
    for key in ("serial", "serial_prefill"):
        out, vt = runs[key]
        assert vt == base_vt, key
        for (ta, la), (tb, lb) in zip(base_out, out):
            assert ta == tb, key
            np.testing.assert_allclose(la[-1].numpy(), lb[-1].numpy(),
                                       **LOGIT_TOL[arch])


@pytest.mark.parametrize("decode_mode", ["fused", "serial"])
@pytest.mark.parametrize("arch", ARCHS)
def test_failover_mid_stream_exact(arch, decode_mode):
    """Kill a route server while two sessions are co-resident mid-stream:
    both streams continue exactly as the no-failure run (the replay
    overwrites the recurrent state whole), and the route and clock equal
    the reference engine's."""
    cfg = model(arch)[0]
    rng = np.random.RandomState(4)
    prompts = [rng.randint(2, cfg.vocab_size, 5) for _ in range(2)]
    n_new = 6
    _, clean = engines(arch, R=2, max_new_tokens=8, decode_mode=decode_mode)
    want = _run_rounds(clean, prompts, n_new)
    ref, port = engines(arch, R=2, max_new_tokens=8, decode_mode=decode_mode)
    sids = {}
    for system, C in ((ref, RC), (port, TC)):
        sids[id(system)] = []
        for p in prompts:
            route, _ = C.shortest_path_route(system.problem,
                                             system.alive_placement(), 0)
            sids[id(system)].append(system.create_session(p, 0, route,
                                                          n_new))
        ss = sids[id(system)]
        assert system.try_admit_sessions(ss) == ss
        system.drain_prefill()
        system.decode_round(ss)
        system.decode_round(ss)
        victim = system.sessions[ss[0]].route.servers[0]
        system.kill_server(victim)
        while any(system.sessions[s].n_generated < n_new for s in ss):
            system.decode_round(
                [s for s in ss if system.sessions[s].n_generated < n_new])
    for i, (toks, _) in enumerate(want):
        ps = port.sessions[sids[id(port)][i]]
        rs = ref.sessions[sids[id(ref)][i]]
        assert victim not in ps.route.servers
        assert list(ps.tokens) == toks == list(rs.tokens)
        assert ps.virtual_time == rs.virtual_time
        assert (ps.route.servers, ps.route.blocks) == \
            (rs.route.servers, rs.route.blocks)
    assert port.round_stats["replays"] == ref.round_stats["replays"] > 0


def test_state_specs_and_pool_trees():
    """StateSpecs, block kinds and pool-tree leaves match the reference."""
    from repro.serving import new_block_cache as r_new_block_cache
    from repro.serving import state_specs as r_state_specs

    for arch in ARCHS:
        cfg, _, tcfg, _ = model(arch)
        assert [(s.kind, s.recurrent, s.needs_emb0)
                for s in TS.state_specs(tcfg)] == \
            [(s.kind, s.recurrent, s.needs_emb0)
             for s in r_state_specs(cfg)]
        for kind in {s.kind for s in TS.state_specs(tcfg)}:
            got = TS.new_block_cache(tcfg, kind, 2, 9, device="cpu")
            want = r_new_block_cache(cfg, kind, 2, 9)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert TS.bucket_for((8, 16), 5, TS.state_specs(
        t_get_reduced_config("rwkv6_7b"))) == 5
    with pytest.raises(ValueError, match="supported kinds: dec, decoder"):
        TS.state_spec_for("diffusion")
