"""The port's MoE FFN, DeepSeek's MLA attention and the stacks built from
them against the JAX reference, on reduced configs in f32 on the CPU.

* ``apply_moe``: k = 1 and 2, with and without a shared expert, and a
  capacity that drops tokens — output, ``moe_aux_loss`` and
  ``moe_drop_frac``; the per-row dispatch against the reference's
  ``apply_moe`` vmapped over rows (the engine's pooled layout);
* ``apply_mla_full`` with and without a prefix and ``apply_mla_decode``,
  against the reference's XLA path and its Pallas kernels in interpret
  mode, on the port's kernel route (CPU: the kernels' plain versions) and
  its plain route;
* monolithic ``prefill`` / ``decode_step`` of ``deepseek_v2_236b`` and
  ``llama4_scout_17b_a16e``; the reference's param tree and dtypes (the
  router in f32 in a bf16 tree, the padded experts) bridged bit for bit;
* the engine on the slab and paged layouts against the reference's engine
  on the same layout, for deepseek, llama4 and gemma3: token streams,
  admissions, ``round_stats`` and virtual clocks exact, logits within
  rtol 2e-4 / atol 1e-5 (the reference's own tolerance between two
  compiled programs); paged streams equal slab streams; a kill_server
  drill.

Weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``repro_torch.weights.from_reference``; inputs come from a seeded numpy RNG.
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
from repro.configs import get_config, get_reduced_config
from repro.models import NULL_SH
from repro.models import attention as RA
from repro.models import decode_step as r_decode_step
from repro.models import init_params as r_init_params
from repro.models import moe as RM
from repro.models import prefill as r_prefill
from repro_torch import serving as TS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_decode_caches
from repro_torch.models import init_params as t_init_params
from repro_torch.models import moe as TM
from repro_torch.models import prefill as t_prefill
from repro_torch.models.model import layer_params
from repro_torch.weights import from_reference, to_numpy

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
MOE_ARCHS = ["deepseek_v2_236b", "llama4_scout_17b_a16e"]
ENGINE_ARCHS = MOE_ARCHS + ["gemma3_4b"]
# gemma3's reduced logits (scale ~27) differ by up to ~2.4e-5 between the
# two frameworks (tests/test_torch_model.py): atol 5e-5 there
LOGIT_ATOL = {"gemma3_4b": 5e-5}


def close(t, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(r),
                               rtol=rtol, atol=atol)


def T(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def bridged(arch):
    cfg = get_reduced_config(arch)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, t_get_reduced_config(arch), tparams


def ffn_params(arch):
    cfg, params, tcfg, tparams = bridged(arch)
    return (cfg, jax.tree.map(lambda x: x[0], params["segments"]["blocks"]
                              ["ffn"]),
            tcfg, layer_params(tparams["segments"]["blocks"]["ffn"], 0))


def attn_params(arch="deepseek_v2_236b"):
    cfg, params, tcfg, tparams = bridged(arch)
    return (cfg, jax.tree.map(lambda x: x[0], params["segments"]["blocks"]
                              ["attn"]),
            tcfg, layer_params(tparams["segments"]["blocks"]["attn"], 0))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


MOE_CASES = {
    # (arch, top_k, shared experts, capacity factor)
    "k2_shared": ("deepseek_v2_236b", 2, 1, 1.25),
    "k2_no_shared": ("deepseek_v2_236b", 2, 0, 1.25),
    "k1_shared": ("llama4_scout_17b_a16e", 1, 1, 1.25),
    "k1_no_shared": ("llama4_scout_17b_a16e", 1, 0, 1.25),
    "k2_drops": ("deepseek_v2_236b", 2, 1, 0.25),
    "k1_drops": ("llama4_scout_17b_a16e", 1, 1, 0.1),
}


def _moe_setup(case, B=2, S=24):
    arch, k, n_shared, cf = MOE_CASES[case]
    cfg, p, tcfg, tp = ffn_params(arch)
    kw = dict(moe_top_k=k, n_shared_experts=n_shared, capacity_factor=cf)
    cfg, tcfg = cfg.replace(**kw), tcfg.replace(**kw)
    if not n_shared:
        p = {key: v for key, v in p.items() if not key.startswith("s")}
        tp = {key: v for key, v in tp.items() if not key.startswith("s")}
    x = np.random.RandomState(3).randn(B, S, cfg.d_model).astype(np.float32)
    return cfg, p, tcfg, tp, x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case):
    cfg, p, tcfg, tp, x = _moe_setup(case)
    ref, raux = RM.apply_moe(p, cfg, NULL_SH, jnp.asarray(x))
    got, aux = TM.apply_moe(tp, tcfg, T(x))
    close(got, ref)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        close(aux[key], raux[key], atol=1e-6)
    if case.endswith("drops"):
        assert float(aux["moe_drop_frac"]) > 0.1


@pytest.mark.parametrize("case", ["k2_shared", "k1_shared", "k2_drops",
                                  "k1_drops"])
def test_per_row_dispatch_matches_reference_vmap(case):
    """The engine's pooled layout: each row routes alone with its own
    capacity, as the reference's pooled steps vmap batch-1 rows."""
    cfg, p, tcfg, tp, x = _moe_setup(case, B=3, S=16)
    ref, raux = jax.vmap(
        lambda xr: RM.apply_moe(p, cfg, NULL_SH, xr[None]))(jnp.asarray(x))
    got, aux = TM.apply_moe(tp, tcfg, T(x), per_row=True)
    close(got, np.asarray(ref)[:, 0])
    for key in ("moe_aux_loss", "moe_drop_frac"):
        close(aux[key], raux[key], atol=1e-6)


def test_per_row_dispatch_ignores_other_rows():
    """A row's output does not depend on its neighbours (garbage in a
    masked row takes no slot of a real one), bit for bit."""
    cfg, p, tcfg, tp, x = _moe_setup("k2_drops", B=3, S=16)
    a, _ = TM.apply_moe(tp, tcfg, T(x), per_row=True)
    x2 = x.copy()
    x2[0] = 100.0 * np.random.RandomState(9).randn(*x2[0].shape)
    b, _ = TM.apply_moe(tp, tcfg, T(x2), per_row=True)
    assert torch.equal(a[1:], b[1:])


def test_router_top_k_ties_take_the_lower_index():
    """``jax.lax.top_k`` order on ties: the lower expert index first."""
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    _, idx = TM._top_k(probs, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    _, ridx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ridx).tolist()


def test_expert_alloc_and_capacity_match_reference():
    for E in (4, 8, 16, 63, 64, 160, 256, 300):
        assert TM.expert_alloc(E) == RM.expert_alloc(E)
    cfg, tcfg = get_reduced_config("deepseek_v2_236b"), \
        t_get_reduced_config("deepseek_v2_236b")
    for n in (1, 7, 16, 100, 1000, 4096):
        assert TM._capacity(tcfg, n) == RM._capacity(cfg, n)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r_backend", ["xla", "pallas"])
@pytest.mark.parametrize("t_backend", ["kernel", "plain"])
@pytest.mark.parametrize("prefix", [0, 9])
def test_apply_mla_full_matches_reference(r_backend, t_backend, prefix):
    cfg, p, tcfg, tp = attn_params()
    rng = np.random.RandomState(1)
    S = 11
    x = rng.randn(2, S, cfg.d_model).astype(np.float32) * 0.5
    pos = np.arange(prefix, prefix + S)
    pkv = tpkv = None
    if prefix:
        plat = rng.randn(2, prefix, cfg.kv_lora_rank).astype(np.float32)
        pkr = rng.randn(2, prefix, cfg.rope_head_dim).astype(np.float32)
        pkv, tpkv = (jnp.asarray(plat), jnp.asarray(pkr)), (T(plat), T(pkr))
    ry, (rlat, rkr) = RA.apply_mla_full(p, cfg, NULL_SH, jnp.asarray(x),
                                        jnp.asarray(pos), prefix_kv=pkv,
                                        backend=r_backend)
    ty, (tlat, tkr) = TA.apply_mla_full(tp, tcfg, T(x), T(pos),
                                        prefix_kv=tpkv, backend=t_backend)
    close(ty, ry)
    close(tlat, rlat)
    close(tkr, rkr)


@pytest.mark.parametrize("r_backend", ["xla", "pallas"])
@pytest.mark.parametrize("t_backend", ["kernel", "plain"])
def test_apply_mla_decode_matches_reference(r_backend, t_backend):
    """Absorbed decode: the kernel route takes the faithful 1/sqrt(nope +
    rope) scale, the plain route pre-scales q as the reference's XLA
    branch; the cache is written at ``pos`` (joint layout in the port)."""
    cfg, p, tcfg, tp = attn_params()
    rng = np.random.RandomState(2)
    B, Tn, pos = 2, 24, 13
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32) * 0.5
    lat = rng.randn(B, Tn, cfg.kv_lora_rank).astype(np.float32)
    kr = rng.randn(B, Tn, cfg.rope_head_dim).astype(np.float32)
    ry, rlat, rkr = RA.apply_mla_decode(p, cfg, NULL_SH, jnp.asarray(x),
                                        jnp.asarray(lat), jnp.asarray(kr),
                                        pos, backend=r_backend)
    buf = TA.mla_cache_views(T(np.concatenate([lat, kr], -1)),
                             cfg.kv_lora_rank)
    ty, tlat, tkr = TA.apply_mla_decode(
        tp, tcfg, T(x), buf["latent"], buf["krope"],
        torch.full((B,), pos), backend=t_backend)
    close(ty, ry)
    assert tlat.data_ptr() == buf["latent"].data_ptr()  # written in place
    close(tlat, rlat)
    close(tkr, rkr)


def test_mla_keys_view_the_joint_buffer():
    """Decode reads the joint cache as K1's keys through strides, with no
    copy; separate leaves (a copy every step) are refused."""
    buf = torch.randn(3, 10, 40)
    v = TA.mla_cache_views(buf, 32)
    keys = TA.mla_keys(v["latent"], v["krope"])
    assert keys.data_ptr() == buf.data_ptr() and torch.equal(keys, buf)
    row = TA.mla_keys(v["latent"][1], v["krope"][1])  # a layer view
    assert row.data_ptr() == buf[1].data_ptr()
    with pytest.raises(ValueError, match="one"):
        TA.mla_keys(buf[..., :32].clone(), buf[..., 32:].clone())


# ---------------------------------------------------------------------------
# Monolithic stacks and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    cfg, params, tcfg, tparams = bridged(arch)
    toks = np.random.RandomState(0).randint(2, cfg.vocab_size, (2, 19))
    rl, rcache = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, tcache = t_prefill(tparams, tcfg, {"tokens": T(toks)}, cache_len=32)
    close(tl, rl)
    for key, leaf in rcache["blocks"].items():
        close(tcache["blocks"][key], leaf)
    nxt = np.asarray(jnp.argmax(rl, -1))
    for i in range(5):
        rl, rcache = r_decode_step(params, cfg, NULL_SH, rcache,
                                   jnp.asarray(nxt), 19 + i)
        tl, tcache = t_decode_step(tparams, tcfg, tcache, T(nxt), 19 + i)
        close(tl, rl)
        nxt = np.asarray(jnp.argmax(rl, -1))
        assert (tl.argmax(-1).numpy() == nxt).all()


def test_prefill_caches_mla_joint_layout():
    """Monolithic caches hold each MLA layer as one buffer: decode reads
    it without a copy."""
    _, _, tcfg, tparams = bridged("deepseek_v2_236b")
    toks = T(np.random.RandomState(1).randint(2, 200, (1, 5)))
    _, caches = t_prefill(tparams, tcfg, {"tokens": toks}, cache_len=12)
    c = caches["blocks"]
    assert TA.mla_keys(c["latent"], c["krope"]).data_ptr() == \
        c["latent"].data_ptr()
    z = init_decode_caches(tcfg, 2, 12, device="cpu")["blocks"]
    assert z["latent"].shape == (tcfg.n_layers, 2, 12, tcfg.kv_lora_rank)
    assert TA.mla_keys(z["latent"], z["krope"]).data_ptr() == \
        z["latent"].data_ptr()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_matches_reference_tree(arch):
    """The torch init gives the reference's tree, shapes and dtypes — in
    bf16 too, where the router stays f32 and deepseek's 160 experts are
    allocated as 256 (checked on the abstract full config)."""
    cfg, params, tcfg, _ = bridged(arch)
    tp = t_init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert {jax.tree_util.keystr(k) for k, _ in ref} == \
        {jax.tree_util.keystr(k) for k in got}
    for path, leaf in ref:
        assert got[path].shape == leaf.shape, path
        assert got[path].dtype == leaf.dtype, path
    full = get_config(arch).replace(n_layers=1)
    abstract = jax.eval_shape(
        lambda: r_init_params(jax.random.PRNGKey(0), full)[0])
    ffn = abstract["segments"]["blocks"]["ffn"]
    assert ffn["router"].dtype == jnp.float32
    assert ffn["wg"].shape[1] == TM.expert_alloc(full.n_experts)
    tfull = t_get_config(arch).replace(n_layers=1)
    assert TM.expert_alloc(tfull.n_experts) == ffn["wg"].shape[1]


def test_bf16_tree_bridges_bit_for_bit():
    """The bridge carries a bf16 MoE/MLA tree (f32 router, padded expert
    leaves, MLA leaves) bit for bit, both ways."""
    cfg = get_reduced_config("deepseek_v2_236b").replace(
        param_dtype="bfloat16", n_experts=64)
    params, _ = r_init_params(jax.random.PRNGKey(1), cfg)
    host = jax.tree.map(np.asarray, params)
    tp = from_reference(host, "cpu")
    blk = tp["segments"]["blocks"]
    assert blk["ffn"]["router"].dtype == torch.float32
    assert blk["ffn"]["wg"].dtype == torch.bfloat16
    assert blk["ffn"]["wg"].shape[1] == 256  # 64 experts padded to 256
    assert blk["attn"]["wuk"].dtype == torch.bfloat16
    back = to_numpy(tp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(host)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# ---------------------------------------------------------------------------
# Engine: slab and paged against the reference's engine
# ---------------------------------------------------------------------------


def problem(C, cfg, n_servers=4, mem=1000.0, wl=(4, 8)):
    """tests/test_family_pools.py's cluster."""
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=mem, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3, workload=C.Workload(*wl))


def engines(arch, **kw):
    cfg, params, tcfg, tparams = bridged(arch)
    return (RS.GeoServingSystem(cfg, params, problem(RC, cfg), **kw),
            TS.GeoServingSystem(tcfg, tparams, problem(TC, tcfg),
                                device="cpu", **kw))


RECORD_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped", "n_deferrals",
                 "n_replays", "n_detections", "replay_time", "detect_time")
SESSION_FIELDS = ("state", "pos", "n_generated", "n_preemptions",
                  "n_replays", "virtual_time", "end")


def _requests(vocab, lengths, n_new, rate=4.0, seed=0):
    from repro_torch.sim.workload import poisson_requests

    rng = np.random.RandomState(seed)
    return [(r.rid, rng.randint(2, vocab, n), r.arrival, n_new)
            for r, n in zip(poisson_requests(len(lengths), rate=rate,
                                             seed=seed + 1), lengths)]


def _serve(system, sched_cls, reqs, R=2):
    sched = sched_cls(system, R=R)
    for rid, toks, arrival, n_new in reqs:
        sched.submit(rid, toks, arrival, n_new=n_new)
    return sched.run()


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_scheduler_identical_to_reference(arch):
    """Poisson requests with prompts of several lengths (bucketed prefill,
    per-row MoE capacity of the padded rows): tokens, clocks, admissions
    and round_stats identical to the reference's engine."""
    ref, port = engines(arch, R=2, max_new_tokens=8, max_sessions=8)
    assert list(ref.placement.m) == list(port.placement.m)
    reqs = _requests(ref.cfg.vocab_size, (5, 9, 3, 12, 6), 6)
    r_out = _serve(ref, RS.ContinuousBatchingScheduler, reqs)
    p_out = _serve(port, TS.ContinuousBatchingScheduler, reqs)
    assert len(r_out) == len(p_out) == len(reqs)
    for a, b in zip(r_out, p_out):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert ref.round_stats == port.round_stats
    assert port.slot_usage() == ref.slot_usage()


def _drive(system, C, lengths, n_new, kill_after=None, seed=0):
    """Admit ``lengths`` as one batch on shortest-path routes, decode to
    ``n_new`` tokens (killing the first session's first route server after
    ``kill_after`` rounds); returns the sids and each round's logits."""
    rng = np.random.RandomState(seed)
    sids = []
    for n in lengths:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids.append(system.create_session(
            rng.randint(2, system.cfg.vocab_size, n), 0, route, n_new))
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
    return sids, hist


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_layouts_match_reference(arch, layout):
    """Co-resident sessions of mixed lengths on each layout, with a
    kill_server drill: streams, per-session clocks and counters,
    round_stats and page tables identical to the reference's engine on the
    same layout; logits within tolerance."""
    kw = dict(R=2, max_new_tokens=6, max_sessions=4, cache_layout=layout,
              page_size=2 if layout == "paged" else None)
    ref, port = engines(arch, **kw)
    r_sids, r_hist = _drive(ref, RC, (5, 3, 7), 6, kill_after=2)
    p_sids, p_hist = _drive(port, TC, (5, 3, 7), 6, kill_after=2)
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
    atol = LOGIT_ATOL.get(arch, ATOL)
    for rr, pr in zip(r_hist, p_hist):
        for a, b in zip(rr, pr):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_paged_streams_equal_slab_streams(arch):
    """The paged pools (MLA latents paged as one joint buffer) give the
    slab layout's streams and last logits bit for bit."""
    out = {}
    for layout in ("slab", "paged"):
        _, port = engines(arch, R=2, max_new_tokens=6, max_sessions=4,
                          cache_layout=layout,
                          page_size=2 if layout == "paged" else None)
        sids, hist = _drive(port, TC, (6, 2, 9), 6)
        out[layout] = ([list(port.sessions[s].tokens) for s in sids],
                       hist[-1])
    assert out["paged"][0] == out["slab"][0]
    for a, b in zip(out["paged"][1], out["slab"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_matches_monolithic_without_drops(arch):
    """Where no token is dropped (per-row capacity >= every row's load),
    the engine's greedy stream equals the monolithic one."""
    cfg, params, _, _ = bridged(arch)
    _, port = engines(arch, R=2, max_new_tokens=8, max_sessions=4)
    toks = np.random.RandomState(7).randint(2, cfg.vocab_size, 6)
    sid, logits = port.submit(toks)
    rl, caches = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)[None]},
                           cache_len=len(toks) + 9)
    close(logits[0], rl[0])
    seq = [int(jnp.argmax(rl[0]))]
    for i in range(4):
        rl, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), len(toks) + i)
        lg = port.decode(sid, seq[-1])
        close(lg[0], rl[0])
        seq.append(int(jnp.argmax(rl[0])))
        assert int(torch.argmax(lg[0])) == seq[-1]


def test_state_specs_and_pool_trees_match_reference():
    """Pool-tree leaves (names, shapes, dtypes) of MLA and GQA-MoE stacks
    equal the reference's; the MLA leaves view one buffer."""
    from repro.serving import new_block_cache as r_new_block_cache

    for arch in ENGINE_ARCHS:
        cfg, _, tcfg, _ = bridged(arch)
        got = TS.new_block_cache(tcfg, "decoder", 2, 9, device="cpu")
        want = r_new_block_cache(cfg, "decoder", 2, 9)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        if "latent" in got:
            assert TA.mla_keys(got["latent"], got["krope"]).data_ptr() == \
                got["latent"].data_ptr()
