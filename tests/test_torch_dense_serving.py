"""The port's geo serving engine on the four dense stacks that only these
tests serve — BLOOM (ALiBi, LayerNorm with a bias, the GELU MLP, MHA),
Qwen2.5 (QKV bias, GQA), OLMo (the non-parametric norm) and Chameleon
(QK-norm, GQA) — against the JAX reference engine, on the reduced configs
with bridged weights, on the CPU.

``init_params`` sets the QKV biases and every norm's bias to 0 and the
QK-norm and norm scales to 1, where a bias added to the wrong tensor or a
scale applied twice would still agree.  So before bridging, those leaves
get seeded numpy noise (σ 0.3), and both engines take the same values.
One more BLOOM variant has 12 heads: like BLOOM's 112, not a power of
two, so ``alibi_slopes`` takes its second branch through K1/K2's plain
versions in the pooled steps.

* the scheduler over Poisson requests of several prompt lengths, on slab
  and paged (page 2) pools, fused and serial rounds: tokens, virtual
  clocks, admission/deferral records and ``round_stats`` identical to the
  reference's; every stream equals the reference's monolithic greedy
  stream;
* co-resident sessions with a ``kill_server`` drill on each layout:
  streams, routes, session counters, ``round_stats`` and page tables
  identical, per-round logits within rtol 2e-4 / atol 1e-5 (the
  reference's own tolerance between two compiled programs), the replayed
  streams the reference's monolithic ones;
* ROADMAP C5 on the CPU: on the dense paths in bf16, the port's first
  step sits within twice the reference's own bf16-vs-f32 drift of the
  reference's bf16 logits.
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
from repro.models.layers import alibi_slopes as r_alibi_slopes
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models.layers import alibi_slopes
from repro_torch.sim.workload import poisson_requests
from repro_torch.weights import from_reference

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
# the four configs, and BLOOM at 12 heads (n_heads = n_kv_heads)
ARCHS = ["bloom_176b", "qwen2_5_32b", "olmo_1b", "chameleon_34b",
         "bloom_176b_h12"]
# the leaves init sets to 0 or 1 (QKV biases, QK-norm scales, every norm's
# scale and bias, the final norm's among them)
NOISY = frozenset({"bq", "bk", "bv", "q_norm", "k_norm", "scale", "bias"})
SIGMA = 0.3

RECORD_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped", "n_deferrals",
                 "n_replays", "n_detections", "replay_time", "detect_time")
SESSION_FIELDS = ("state", "pos", "n_generated", "n_preemptions",
                  "n_replays", "virtual_time", "end")


def _configs(arch):
    base = arch.replace("_h12", "")
    cfg, tcfg = get_reduced_config(base), t_get_reduced_config(base)
    if arch.endswith("_h12"):
        cfg = cfg.replace(n_heads=12, n_kv_heads=12)
        tcfg = tcfg.replace(n_heads=12, n_kv_heads=12)
    return cfg, tcfg


def perturb(tree, rng):
    """``tree`` (numpy leaves) with N(0, SIGMA) noise added to the leaves
    named in NOISY, in sorted key order."""
    out = {}
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out[key] = perturb(v, rng)
        elif key in NOISY:
            out[key] = (v + rng.normal(0.0, SIGMA, v.shape)).astype(v.dtype)
        else:
            out[key] = v
    return out


@functools.lru_cache(maxsize=None)
def model(arch):
    """(reference cfg, reference params, port cfg, port params): the
    reference's ``init_params(PRNGKey(0))`` with NOISY leaves perturbed,
    the same values on both sides."""
    cfg, tcfg = _configs(arch)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    noisy = perturb(jax.tree.map(np.asarray, params),
                    np.random.RandomState(7))
    return (cfg, jax.tree.map(jnp.asarray, noisy), tcfg,
            from_reference(noisy, "cpu"))


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
    return (RS.GeoServingSystem(cfg, params, problem(RC, cfg), **kw),
            TS.GeoServingSystem(tcfg, tparams, problem(TC, tcfg),
                                device="cpu", **kw))


def layout_kw(layout):
    return dict(cache_layout=layout,
                page_size=2 if layout == "paged" else None)


def monolithic(arch, toks, n_new):
    """The reference's monolithic greedy stream of ``toks``."""
    cfg, params, _, _ = model(arch)
    logits, caches = r_prefill(params, cfg, NULL_SH,
                               {"tokens": jnp.asarray(toks)[None]},
                               cache_len=len(toks) + n_new + 4)
    seq = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        lg, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), len(toks) + i)
        seq.append(int(jnp.argmax(lg[0])))
    return seq


def _requests(vocab, lengths, n_new, rate=4.0, seed=0):
    rng = np.random.RandomState(seed)
    return [(r.rid, rng.randint(2, vocab, n), r.arrival, n_new)
            for r, n in zip(poisson_requests(len(lengths), rate=rate,
                                             seed=seed + 1), lengths)]


def _serve(system, sched_cls, reqs, R=2):
    sched = sched_cls(system, R=R)
    for rid, toks, arrival, n_new in reqs:
        sched.submit(rid, toks, arrival, n_new=n_new)
    return sched.run(), sched


def test_perturbed_leaves_are_off_their_init():
    """Every leaf init sets to 0 or 1 carries noise, on both sides."""
    for arch in ARCHS:
        cfg, params, _, tparams = model(arch)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        noisy = [(jax.tree_util.keystr(k), v) for k, v in flat
                 if k[-1].key in NOISY]
        assert noisy or cfg.norm_kind == "nonparametric", arch
        for name, v in noisy:
            v = np.asarray(v)
            assert np.abs(v - np.round(v)).max() > 0.05, (arch, name)
        t = tparams["segments"]["blocks"]["attn"]
        r = params["segments"]["blocks"]["attn"]
        for key in set(t) & NOISY:
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(r[key]))


@pytest.mark.parametrize("n_heads", [4, 12, 40, 64, 112])
def test_alibi_slopes_match_reference(n_heads):
    """The slopes K1/K2 take (both branches: powers of two and not)."""
    np.testing.assert_array_equal(alibi_slopes(n_heads).numpy(),
                                  np.asarray(r_alibi_slopes(n_heads)))


@pytest.mark.parametrize("decode_mode", ["fused", "serial"])
@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_identical_to_reference(arch, layout, decode_mode):
    """Poisson requests with prompts of several lengths (bucketed prefill
    over padded rows): tokens, virtual clocks, admissions and deferrals,
    round_stats and slot usage identical to the reference's engine on the
    same layout; each stream is the reference's monolithic greedy one."""
    ref, port = engines(arch, R=2, max_new_tokens=8, max_sessions=8,
                        decode_mode=decode_mode, **layout_kw(layout))
    assert list(ref.placement.a) == list(port.placement.a)
    assert list(ref.placement.m) == list(port.placement.m)
    reqs = _requests(ref.cfg.vocab_size, (5, 9, 4, 7, 6), 6)
    r_out, r_sched = _serve(ref, RS.ContinuousBatchingScheduler, reqs)
    p_out, p_sched = _serve(port, TS.ContinuousBatchingScheduler, reqs)
    assert len(r_out) == len(p_out) == len(reqs)
    for a, b in zip(r_out, p_out):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert ref.round_stats == port.round_stats
    assert r_sched.max_concurrency == p_sched.max_concurrency > 1
    assert port.slot_usage() == ref.slot_usage()
    if layout == "slab" and decode_mode == "fused":
        for (_, toks, _, n_new), out in zip(reqs, p_out):
            assert list(out.tokens[len(toks):]) == \
                monolithic(arch, toks, n_new), out.rid


def _drive(system, C, lengths, n_new, kill_after=None, seed=0):
    """Admit ``lengths`` as one batch on shortest-path routes, decode to
    ``n_new`` tokens (killing the first session's first route server after
    ``kill_after`` rounds); returns the sids, each round's logits and the
    prompts."""
    rng = np.random.RandomState(seed)
    sids, prompts = [], []
    for n in lengths:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        prompts.append(rng.randint(2, system.cfg.vocab_size, n))
        sids.append(system.create_session(prompts[-1], 0, route, n_new))
    assert system.try_admit_sessions(sids) == sids
    system.drain_prefill()
    hist = [[np.asarray(system.sessions[s].last_logits) for s in sids]]
    rounds = 0
    while any(system.sessions[s].n_generated < n_new for s in sids):
        if rounds == kill_after:
            system.kill_server(system.sessions[sids[0]].route.servers[0])
        system.decode_round(
            [s for s in sids if system.sessions[s].n_generated < n_new])
        hist.append([np.asarray(system.sessions[s].last_logits)
                     for s in sids])
        rounds += 1
    return sids, hist, prompts


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_failover_drill_matches_reference(arch, layout):
    """Co-resident sessions of mixed lengths and a kill_server drill after
    two rounds: streams, routes, per-session clocks and counters,
    round_stats and page tables identical to the reference's engine on the
    same layout; every round's logits within tolerance; the replayed
    streams are the reference's monolithic ones, as without the
    failure."""
    kw = dict(R=2, max_new_tokens=6, max_sessions=4, **layout_kw(layout))
    ref, port = engines(arch, **kw)
    r_sids, r_hist, _ = _drive(ref, RC, (5, 3, 7), 6, kill_after=2)
    p_sids, p_hist, prompts = _drive(port, TC, (5, 3, 7), 6, kill_after=2)
    assert r_sids == p_sids
    for sid in p_sids:
        a, b = ref.sessions[sid], port.sessions[sid]
        assert list(a.tokens) == list(b.tokens), sid
        assert (a.route.servers, a.route.blocks) == \
            (b.route.servers, b.route.blocks)
        for f in SESSION_FIELDS:
            assert getattr(a, f) == getattr(b, f), (sid, f)
    assert ref.round_stats == port.round_stats
    assert port.round_stats["replays"] > 0
    if layout == "paged":
        for j, srv in port.servers.items():
            np.testing.assert_array_equal(srv.pool.pages.table,
                                          ref.servers[j].pool.pages.table)
    for rr, pr in zip(r_hist, p_hist):
        for a, b in zip(rr, pr):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    for sid, toks in zip(p_sids, prompts):
        assert list(port.sessions[sid].tokens)[len(toks):] == \
            monolithic(arch, toks, 6), sid


@pytest.mark.parametrize("arch", ["llama3_2_1b", "gemma3_4b", "bloom_176b",
                                  "qwen2_5_32b", "olmo_1b", "chameleon_34b"])
def test_bf16_first_step_follows_reference(arch):
    """ROADMAP C5 on the CPU: in bf16 the port's first-step logits sit no
    further from the reference's bf16 logits than twice the reference's
    own bf16-vs-f32 drift — the port's bf16 arithmetic is the reference's
    up to the order of its roundings (scripts/bf16_drift.py prints the
    four distances)."""
    from repro_torch.models import prefill, upcast_prefill_logits

    bf16 = dict(param_dtype="bfloat16", act_dtype="bfloat16")
    cfg = get_reduced_config(arch).replace(**bf16)
    tcfg = t_get_reduced_config(arch).replace(**bf16)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.RandomState(1).randint(2, cfg.vocab_size, (1, 24))
    ref_b = np.asarray(r_prefill(params, cfg, NULL_SH,
                                 {"tokens": jnp.asarray(toks)})[0][0],
                       np.float32)
    up = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if x.dtype == jnp.bfloat16 else x, params)
    ref_f = np.asarray(r_prefill(up, cfg.replace(param_dtype="float32",
                                                 act_dtype="float32"),
                                 NULL_SH, {"tokens": jnp.asarray(toks)})[0][0])
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    tbatch = {"tokens": torch.from_numpy(toks)}
    port_b = prefill(tparams, tcfg, tbatch)[0][0].float().numpy()
    port_f = upcast_prefill_logits(tparams, tcfg, tbatch)[0].numpy()
    live = slice(0, cfg.vocab_size)
    drift = np.abs(ref_b[live] - ref_f[live]).max()
    assert 0 < drift < 0.025 * np.abs(ref_f[live]).max()
    assert np.abs(port_b[live] - ref_b[live]).max() <= 2 * drift
    # gemma3's reduced logits differ by up to ~2.4e-5 in f32 between the
    # two frameworks (tests/test_torch_model.py LOGIT_ATOL)
    np.testing.assert_allclose(port_f, ref_f, rtol=RTOL,
                               atol=5e-5 if arch == "gemma3_4b" else ATOL)
