"""Device-group servers in the port against the JAX reference, in f32 on
the CPU (a group's slots all name the ``cpu`` device).

* tests/test_sharded_serving.py's matrix: decoder / MLA / MoE (the
  reference's ``ARCH_MESH``) x fused / serial x slab / paged (page 2) —
  the port on a group gives the reference's ``mesh=None`` token streams,
  virtual clocks and ``round_stats`` exactly and its logits within rtol
  2e-4 / atol 1e-5 (the port's tolerance against the reference), and its
  own solo run's logits within the reference's ``LOGIT_TOL``;
* a (1, 1) group is bit-exact with solo; all-solo ``device_groups`` are
  the solo engine; heterogeneous groups {solo, (1, 2), (2, 2)} equal the
  all-solo twin;
* per-slot params and pools have their specs' block shapes, and every
  slot pool leaf (``ARCH_MESH`` and the families' ``FAMILY_MESH``, slab
  and paged at pages 2 and 4) is the block the reference's own
  ``serving_rules`` -> ``cache_axes_for`` -> ``guarded_spec`` give it on a
  stand-in mesh — time shards and the paged page axis over ``data``
  included; a row whose page another data slot holds reads it from there,
  counted;
* ``_apply_moe_ep`` equals the global MoE (tests/test_moe_ep.py); padded
  EP runs through the pooled decode step (``_ep_row_grid``) and unpadded
  MoE keeps the per-row path; the vocab-parallel embedding and LM head
  equal the solo ones;
* calibrated τ over heterogeneous groups is not constant, with collective
  bytes on TP groups and none solo; ``mesh=`` with ``device_groups=``
  raises; a group whose rules take the ``head_dim`` fallback serves the
  solo engine's run.

Weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``repro_torch.weights.from_reference``; prompts come from a seeded numpy
RNG.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro import serving as RS
from repro.configs import get_reduced_config
from repro.launch import sharding as RSH
from repro.models import init_params as r_init_params
from repro.models import moe as RM
from repro.models.layers import NULL_SH
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.launch import sharding as TSH
from repro_torch.launch.mesh import GroupMesh, group_meshes
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.model import layer_params
from repro_torch.serving import kv_cache as TKV
from repro_torch.weights import from_reference

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
LOGIT_TOL = dict(atol=5e-6, rtol=1e-4)  # tests/test_sharded_serving.py
ARCH_MESH = [
    ("llama3_2_1b", (2, 4)),
    ("deepseek_v2_236b", (2, 4)),
    ("llama4_scout_17b_a16e", (4, 2)),
]
HETERO_SHAPES = {0: None, 1: (1, 2), 2: (2, 2)}
LAYOUTS = [("slab", None), ("paged", 2)]


def cpu_mesh(shape):
    return GroupMesh(np.full(shape, "cpu", dtype=object))


@functools.lru_cache(maxsize=None)
def bridged(arch):
    cfg = get_reduced_config(arch)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, t_get_reduced_config(arch), tparams


def problem(C, cfg, n_servers=2, l_out=4):
    """tests/test_sharded_serving.py's cluster."""
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=1000.0, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3, workload=C.Workload(4,
                                                                       l_out))


def port(arch, n_servers=2, params=None, **kw):
    _, _, tcfg, tparams = bridged(arch)
    R = n_servers
    return TS.GeoServingSystem(
        tcfg, tparams if params is None else params,
        problem(TC, tcfg, n_servers), algorithm="proposed", R=R,
        max_new_tokens=4, max_sessions=4, device="cpu", **kw)


def jobs_for(vocab, lengths=(4, 6, 5), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, n) for n in lengths]


def serve(system, C, jobs, n_new=4, spread=False):
    """Admit, prefill, decode to completion: (tokens, virtual times,
    per-round logits) per session, and the round_stats.  ``spread``:
    session i on server i alone (every server hosts every block), so
    each server's step runs; else the shortest-path route."""
    sids = []
    for i, prompt in enumerate(jobs):
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        if spread:
            route = C.Route(servers=(i % len(system.servers),),
                            blocks=(system.cfg.n_layers,))
        sids.append(system.create_session(prompt, 0, route, n_new))
    assert system.try_admit_sessions(sids) == sids
    system.drain_prefill()
    hist = {s: [np.array(system.sessions[s].last_logits)] for s in sids}
    while True:
        todo = [s for s in sids if system.sessions[s].n_generated < n_new]
        if not todo:
            break
        system.decode_round(todo)
        for s in todo:
            hist[s].append(np.array(system.sessions[s].last_logits))
    out = ([list(system.sessions[s].tokens) for s in sids],
           [float(system.sessions[s].virtual_time) for s in sids],
           [hist[s] for s in sids], dict(system.round_stats))
    for s in sids:
        system.retire_session(s)
    return out


@functools.lru_cache(maxsize=None)
def reference_run(arch, mode, layout, page_size):
    cfg, params, _, _ = bridged(arch)
    system = RS.GeoServingSystem(
        cfg, params, problem(RC, cfg), algorithm="proposed", R=2,
        max_new_tokens=4, max_sessions=4, decode_mode=mode,
        cache_layout=layout, page_size=page_size)
    return serve(system, RC, jobs_for(cfg.vocab_size))


@functools.lru_cache(maxsize=None)
def solo_run(arch, mode, layout, page_size):
    system = port(arch, decode_mode=mode, cache_layout=layout,
                  page_size=page_size)
    return serve(system, TC, jobs_for(system.cfg.vocab_size))


def assert_same_run(got, want, **tol):
    assert got[0] == want[0], "tokens diverge"
    assert got[1] == want[1], "virtual clocks diverge"
    assert got[3] == want[3], "round_stats diverge"
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("layout,page_size", LAYOUTS)
@pytest.mark.parametrize("mode", ["fused", "serial"])
@pytest.mark.parametrize("arch,shape", ARCH_MESH)
def test_group_matches_reference_and_solo(arch, shape, mode, layout,
                                          page_size):
    system = port(arch, mesh=cpu_mesh(shape), decode_mode=mode,
                  cache_layout=layout, page_size=page_size)
    assert all(s.n_chips == shape[0] * shape[1]
               for s in system.servers.values())
    got = serve(system, TC, jobs_for(system.cfg.vocab_size))
    assert_same_run(got, reference_run(arch, mode, layout, page_size),
                    rtol=RTOL, atol=ATOL)
    assert_same_run(got, solo_run(arch, mode, layout, page_size),
                    **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_236b",
                                  "llama4_scout_17b_a16e"])
def test_trivial_group_is_bit_exact(arch):
    """A (1, 1) group runs the whole group path (slot params and pools, the
    group steps, the client's vocab-parallel head) with nothing split:
    tokens, clocks and logits bit for bit the solo run's."""
    system = port(arch, mesh=cpu_mesh((1, 1)))
    got = serve(system, TC, jobs_for(system.cfg.vocab_size))
    want = solo_run(arch, "fused", "slab", None)
    assert got[:2] == want[:2] and got[3] == want[3]
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            np.testing.assert_array_equal(a, b)


def test_all_solo_device_groups_are_the_solo_engine():
    system = port("llama3_2_1b", 3, device_groups={0: None, 2: None})
    for srv in system.servers.values():
        assert srv.mesh is None and srv.n_chips == 1
    got = serve(system, TC, jobs_for(system.cfg.vocab_size, (4, 6)))
    want = serve(port("llama3_2_1b", 3), TC,
                 jobs_for(system.cfg.vocab_size, (4, 6)))
    assert got[:2] == want[:2] and got[3] == want[3]
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout,page_size", LAYOUTS)
@pytest.mark.parametrize("mode", ["fused", "serial"])
def test_hetero_groups_match_all_solo_twin(mode, layout, page_size):
    """{solo, (1, 2), (2, 2)} on three servers at R = 3 (every server
    hosts every block), session i on server i: streams, clocks and
    round_stats the all-solo twin's."""
    kw = dict(decode_mode=mode, cache_layout=layout, page_size=page_size)
    vocab = bridged("llama3_2_1b")[2].vocab_size
    want = serve(port("llama3_2_1b", 3, **kw), TC, jobs_for(vocab),
                 spread=True)
    groups = group_meshes(HETERO_SHAPES, devices=["cpu"] * 6)
    system = port("llama3_2_1b", 3, device_groups=groups, **kw)
    assert len(system.servers) == 3
    assert [system.servers[j].n_chips for j in sorted(system.servers)] \
        == [1, 2, 4]
    assert_same_run(serve(system, TC, jobs_for(vocab), spread=True), want,
                    **LOGIT_TOL)


@pytest.mark.parametrize("layout,page_size", LAYOUTS)
@pytest.mark.parametrize("arch,shape", ARCH_MESH)
def test_slot_leaves_have_their_spec_shapes(arch, shape, layout, page_size):
    """Each slot's param and pool leaves are its block of the whole leaf
    under the group layout's spec; something is split."""
    system = port(arch, mesh=cpu_mesh(shape), cache_layout=layout,
                  page_size=page_size)
    srv = next(iter(system.servers.values()))
    mesh = srv.mesh
    assert srv.mesh_rules == TSH.serving_rules(
        srv.cfg, mesh, srv.pool.n_rows, srv.pool.max_len)
    split = False
    for r, p in enumerate(srv.run_params):
        for parent, sub in p.items():
            for name, x in sub.items():
                spec = srv.param_specs[r][parent][name]
                split |= any(e is not None for e in spec)
                for s in range(mesh.size):
                    want = x[TSH.slot_index(tuple(x.shape), spec, mesh, s)]
                    got = srv.slot_params[s][r][parent][name]
                    assert got.shape == want.shape
                    assert torch.equal(got, want)
    assert split, "no param leaf is split"
    kinds = srv.kinds
    full = [(TKV.new_paged_pool_tree(srv.cfg, k, hi - lo, srv.pool.n_rows,
                                     page_size, srv.pool.pages.n_pages + 1,
                                     0, "meta")
             if layout == "paged" else
             TKV.new_state_pool_tree(srv.cfg, k, hi - lo, srv.pool.n_rows,
                                     srv.pool.max_len, 0, "meta"))
            for k, lo, hi in TKV.kind_runs(kinds)]
    rows_split = False
    for r, tree in enumerate(full):
        for key, x in tree.items():
            spec = srv.pool.slot_specs[r][key]
            rows_split |= spec[1] == "data"
            for s in range(mesh.size):
                idx = TSH.slot_index(tuple(x.shape), spec, mesh, s)
                assert srv.pool.slot_trees[s][r][key].shape == x[idx].shape
    assert rows_split == (layout == "slab")


def _moe_params(arch):
    _, params, tcfg, tparams = bridged(arch)
    return tcfg, layer_params(tparams["segments"]["blocks"]["ffn"], 0)


def _pad_experts(p, E, E_alloc):
    out = dict(p)
    for k in ("wg", "wu", "wo"):
        out[k] = torch.cat([p[k], p[k].new_zeros((E_alloc - E,)
                                                 + p[k].shape[1:])])
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_apply_moe_ep_matches_global(shape):
    """Pure EP over the group (each slot its own tokens and its padded
    expert block), plus the shared expert, == the global sort dispatch
    with room for every token; the aux terms too (tests/test_moe_ep.py)."""
    tcfg, p = _moe_params("deepseek_v2_236b")
    tcfg = tcfg.replace(capacity_factor=8.0)
    E = tcfg.n_experts
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 16, tcfg.d_model).astype(np.float32)
                         * 0.3)
    ref, aux_ref = TM.apply_moe(p, tcfg, x)
    mesh = cpu_mesh(shape)
    rules = {"batch": "data", "experts": ("data", "model")}
    ctxs = TL.group_ctxs(mesh, rules)
    padded = _pad_experts(p, E, 2 * E) if mesh.size <= 2 * E else None
    spec = (("data", "model"), None, None)
    per = {k: (TSH.shard(v, spec, mesh) if k in ("wg", "wu", "wo")
               else [v] * mesh.size) for k, v in padded.items()}
    ps = [{k: v[s] for k, v in per.items()} for s in range(mesh.size)]
    assert TM._ep_eligible(padded, tcfg, ctxs[0], x)
    xs = TSH.shard(x, ("data", "model", None), mesh)
    outs, aux = TM._apply_moe_ep(ps, tcfg, ctxs, xs)
    got = TM._shared_expert(p, tcfg, x, TSH.unshard(
        outs, ("data", "model", None), mesh, x.shape))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=1e-4)
    assert float(aux["moe_drop_frac"]) < 1e-6
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(aux_ref["moe_aux_loss"]), rtol=1e-4)
    assert not TM._ep_eligible(p, tcfg, ctxs[0], x)  # unpadded
    assert not TM._ep_eligible(padded, tcfg, TL.NULL, x)  # no group


def test_ep_matches_reference_shard_map():
    """The port's pure EP == the reference's ``_apply_moe_ep`` on its
    one-device mesh (same padded weights and tokens)."""
    from repro.launch.mesh import compat_make_mesh
    from repro.models.layers import ShardingCtx

    cfg, params, tcfg, tparams = bridged("deepseek_v2_236b")
    cfg, tcfg = (c.replace(capacity_factor=8.0) for c in (cfg, tcfg))
    E = cfg.n_experts
    r_p = jax.tree.map(lambda a: a[0], params["segments"]["blocks"]["ffn"])
    r_pad = dict(r_p)
    for k in ("wg", "wu", "wo"):
        r_pad[k] = jnp.concatenate(
            [r_p[k], jnp.zeros((E,) + r_p[k].shape[1:], r_p[k].dtype)])
    rng = np.random.RandomState(1)
    xn = rng.randn(2, 16, cfg.d_model).astype(np.float32) * 0.3
    sh = ShardingCtx(compat_make_mesh((1, 1), ("data", "model")),
                     {"batch": "data", "seq_act": None})
    want, _ = RM._apply_moe_ep(r_pad, cfg, sh, jnp.asarray(xn))
    _, p = _moe_params("deepseek_v2_236b")
    mesh = cpu_mesh((1, 1))
    ctxs = TL.group_ctxs(mesh, {"batch": "data",
                                "experts": ("data", "model")})
    x = torch.from_numpy(xn)
    outs, _ = TM._apply_moe_ep([_pad_experts(p, E, 2 * E)], tcfg, ctxs, [x])
    got = TM._shared_expert(p, tcfg, x, outs[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert RM._ep_eligible(r_pad, cfg, sh, jnp.asarray(xn))


def _pad_model(tparams, E, E_alloc):
    out = dict(tparams)
    seg = dict(out["segments"])
    blocks = dict(seg["blocks"])
    ffn = dict(blocks["ffn"])
    for k in ("wg", "wu", "wo"):
        w = ffn[k]
        ffn[k] = torch.cat([w, w.new_zeros((w.shape[0], E_alloc - E)
                                           + w.shape[2:])], dim=1)
    blocks["ffn"] = ffn
    seg["blocks"] = blocks
    out["segments"] = seg
    return out


def test_padded_ep_through_pooled_decode_step():
    """Padded experts on a (2, 2) group: the pooled decode step takes the
    pure-EP all-to-all (``_ep_row_grid``), and streams, clocks and logits
    equal the solo twin on the same padded params (which the global path
    slices back to E)."""
    _, _, tcfg, tparams = bridged("llama4_scout_17b_a16e")
    E = tcfg.n_experts
    padded = _pad_model(tparams, E, 2 * E)
    vocab = tcfg.vocab_size
    want = serve(port("llama4_scout_17b_a16e", params=padded), TC,
                 jobs_for(vocab))
    system = port("llama4_scout_17b_a16e", params=padded,
                  mesh=cpu_mesh((2, 2)))
    srv = next(iter(system.servers.values()))
    grid = TKV._ep_row_grid(srv.cfg, srv.mesh,
                            TSH.freeze_rules(srv.mesh_rules),
                            srv.run_params[0], srv.pool.n_rows)
    assert grid == (2, srv.pool.n_rows // 2) and srv.moe_ep
    assert_same_run(serve(system, TC, jobs_for(vocab)), want, atol=2e-5,
                    rtol=1e-4)


def test_unpadded_moe_keeps_per_row_path():
    system = port("llama4_scout_17b_a16e", mesh=cpu_mesh((2, 2)))
    srv = next(iter(system.servers.values()))
    assert TKV._ep_row_grid(srv.cfg, srv.mesh,
                            TSH.freeze_rules(srv.mesh_rules),
                            srv.run_params[0], srv.pool.n_rows) is None
    assert not srv.moe_ep


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_vocab_parallel_embedding_and_head(shape):
    _, _, tcfg, tparams = bridged("llama4_scout_17b_a16e")  # untied head
    system = port("llama4_scout_17b_a16e", mesh=cpu_mesh(shape))
    ctxs, ps = system._client
    assert ps[0]["tok"].shape[0] == tcfg.padded_vocab // shape[1]
    assert ps[0]["head"].shape[1] == tcfg.padded_vocab // shape[1]
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab_size, (3, 5)))
    want = TL.embed_tokens(tparams["embed"], tcfg, tok)
    for e in TL.embed_tokens_group(ps, tcfg, ctxs, [tok] * len(ctxs)):
        assert torch.equal(e, want)
    h = torch.from_numpy(np.random.RandomState(1).randn(
        3, 1, tcfg.d_model).astype(np.float32))
    want = TL.lm_head(tparams["embed"], tcfg, h)
    for lg in TL.lm_head_group(ps, tcfg, ctxs, [h] * len(ctxs)):
        np.testing.assert_allclose(lg.numpy(), want.numpy(), **LOGIT_TOL)


def test_hetero_calibrated_taus_are_non_constant():
    groups = group_meshes(HETERO_SHAPES, devices=["cpu"] * 6)
    system = port("llama3_2_1b", 3, device_groups=groups)
    taus = system.calibrate_taus()
    assert set(taus) == {0, 1, 2}
    assert all(np.isfinite(t) and t > 0 for t in taus.values())
    assert len({round(t, 15) for t in taus.values()}) > 1, taus
    assert taus[2] <= taus[0] * (1 + 1e-9), taus
    costs = {j: s.decode_step_cost() for j, s in system.servers.items()}
    assert costs[0].coll_wire_bytes == 0 and costs[0].coll_count == 0
    assert costs[1].coll_wire_bytes > 0 and costs[2].coll_wire_bytes > 0
    assert costs[2].flops < costs[0].flops
    cal = system.calibrated_problem()
    np.testing.assert_allclose(cal.tau(), [taus[0], taus[1], taus[2]])
    assert system.problem.tau().tolist() == [0.01, 0.02, 0.03]


def test_mesh_rules_override_and_exclusive_spellings():
    mesh = cpu_mesh((1, 2))
    system = port("llama3_2_1b", mesh=mesh)
    srv = next(iter(system.servers.values()))
    derived = TSH.serving_rules(srv.cfg, mesh, srv.pool.n_rows,
                                srv.pool.max_len)
    assert srv.mesh_rules == derived
    system2 = port("llama3_2_1b", mesh=mesh,
                   mesh_rules=dict(derived, mlp=None))
    srv2 = next(iter(system2.servers.values()))
    assert srv2.mesh_rules["mlp"] is None
    assert srv2.slot_params[0][0]["ffn"]["wo"].shape == \
        srv2.run_params[0]["ffn"]["wo"].shape
    with pytest.raises(ValueError, match="not both"):
        port("llama3_2_1b", mesh=mesh, device_groups={0: mesh})


def test_group_over_unported_kind_raises():
    """Every block kind takes a group, and so does the reference's
    ``head_dim`` fallback this test once pinned as raising (query heads
    that do not divide the model axis: reduced Llama's 4 heads on a (1,
    8) group): each slot projects its head_dim columns, and the run is
    the solo engine's (tests/test_torch_group_rules_serving.py holds it
    against the reference too)."""
    system = port("llama3_2_1b", mesh=cpu_mesh((1, 8)))
    srv = next(iter(system.servers.values()))
    assert srv.mesh_rules["head_dim"] == "model"
    got = serve(system, TC, jobs_for(system.cfg.vocab_size))
    assert_same_run(got, solo_run("llama3_2_1b", "fused", "slab", None),
                    **LOGIT_TOL)


FAMILY_MESH = [("rwkv6_7b", (2, 4)), ("zamba2_7b", (2, 4)),
               ("seamless_m4t_large_v2", (2, 4))]


def _stand_in(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros(shape, np.int8))


@pytest.mark.parametrize("layout,page_size", [("slab", None), ("paged", 2),
                                              ("paged", 4)])
@pytest.mark.parametrize("arch,shape", ARCH_MESH + FAMILY_MESH)
def test_slot_pool_leaves_match_reference_specs(arch, shape, layout,
                                                page_size):
    """Each slot's pool leaf has the per-device shape the reference's
    serving rules give that leaf (its ``cache_axes_for`` through its
    ``guarded_spec`` on a stand-in mesh): rows over data, KV heads or the
    time axis over model, and the paged page arrays' page axis over data
    where the ``n_phys + 1`` pages divide it."""
    from repro.serving import kv_cache as RKV

    cfg, _, _, _ = bridged(arch)
    system = port(arch, mesh=cpu_mesh(shape), cache_layout=layout,
                  page_size=page_size)
    srv = next(iter(system.servers.values()))
    pool, mesh = srv.pool, _stand_in(shape)
    rules = RSH.serving_rules(cfg, mesh, pool.n_rows, pool.max_len)
    sizes = dict(zip(("data", "model"), shape))
    enc = pool.enc_len
    for r, (kind, lo, hi) in enumerate(TKV.kind_runs(srv.kinds)):
        L = hi - lo
        ref = jax.eval_shape(
            (lambda: RKV.new_paged_pool_tree(
                cfg, kind, L, pool.n_rows, pool.max_len, page_size,
                pool.pages.n_pages + 1, enc)) if layout == "paged" else
            (lambda: RKV.new_state_pool_tree(cfg, kind, L, pool.n_rows,
                                              pool.max_len, enc)))
        for key, leaf in ref.items():
            rs = dict(rules)
            axes = RSH.cache_axes_for(key, leaf.ndim, rs)
            spec = tuple(RSH.guarded_spec(axes, leaf.shape, rs, mesh))
            want = []
            for d, (n, e) in enumerate(zip(leaf.shape, spec + (None,) * 9)):
                if e is None:
                    want.append(n)
                    continue
                k = int(np.prod([sizes[a] for a in (e if isinstance(e, tuple)
                                                    else (e,))]))
                want.append(n // k)
            for s in range(shape[0] * shape[1]):
                got = pool.slot_trees[s][r][key]
                assert tuple(got.shape) == tuple(want), (key, s, spec)


@pytest.mark.parametrize("arch,shape,n_time", [
    ("llama3_2_1b", (2, 4), 4), ("deepseek_v2_236b", (1, 2), 2)])
def test_time_sharded_slots_hold_and_price_their_shard(arch, shape, n_time):
    """Where the rules put the time axis on ``model`` a slot holds 1/M of
    it (reduced Llama's K/V on (2, 4), DeepSeek-V2's latent on (1, 2)),
    and ``decode_step_cost`` prices that shard plus the merge's wire
    bytes: fewer bytes a slot than the same group with the time axis kept
    whole (``mesh_rules`` with ``kv_time`` None, the port's earlier
    layout), and another τ."""
    mesh = cpu_mesh(shape)
    system = port(arch, mesh=mesh)
    srv = next(iter(system.servers.values()))
    whole = port(arch, mesh=mesh, mesh_rules=dict(srv.mesh_rules,
                                                  kv_time=None))
    wsrv = next(iter(whole.servers.values()))
    for r, tree in enumerate(srv.pool.slot_trees[0]):
        for key, x in tree.items():
            w = wsrv.pool.slot_trees[0][r][key]
            assert x.shape[2] * n_time == w.shape[2] == srv.pool.max_len
    cost, wcost = srv.decode_step_cost(), wsrv.decode_step_cost()
    assert cost.coll_by_kind["merge"] > 0 and "merge" not in \
        wcost.coll_by_kind
    pool = sum(TKV.decode_step_bytes(t, srv.pool.max_len)[0]
               for t in srv.pool.slot_trees[0])
    wpool = sum(TKV.decode_step_bytes(t, srv.pool.max_len)[0]
                for t in wsrv.pool.slot_trees[0])
    assert pool * n_time == wpool
    assert cost.bytes_accessed < wcost.bytes_accessed
    assert system.calibrate_taus() != whole.calibrate_taus()


@pytest.mark.parametrize("layout,page_size", [("slab", None), ("paged", 8)])
@pytest.mark.parametrize("arch,shape,n_time", [
    ("llama3_2_1b", (2, 4), 8), ("deepseek_v2_236b", (2, 4), 8),
    ("llama4_scout_17b_a16e", (4, 2), 4)])
def test_time_over_data_and_model_matches_solo(arch, shape, n_time, layout,
                                               page_size):
    """Pool rows that do not divide the data axis (3 rows): the
    reference's rules put the time axis on (data, model) — on data alone
    where the KV heads take model (Scout on (4, 2)) —, so each slot holds
    1/n_time of it (paged: of each 8-token page) and K1's partials merge
    over the slots of its time row: every slot of the group, or the data
    column whose KV heads it shares.  Streams, clocks and round_stats are
    the solo run's; logits within LOGIT_TOL."""
    _, _, tcfg, tparams = bridged(arch)

    def build(**kw):
        return TS.GeoServingSystem(
            tcfg, tparams, problem(TC, tcfg), algorithm="proposed", R=2,
            max_new_tokens=4, max_sessions=3, device="cpu",
            cache_layout=layout, page_size=page_size, **kw)

    system = build(mesh=cpu_mesh(shape))
    srv = next(iter(system.servers.values()))
    assert srv.pool.n_rows == 3
    assert srv.mesh_rules["kv_time"] == ("data", "model")
    for tree in srv.pool.slot_trees[0]:
        for x in tree.values():
            assert x.shape[2] * n_time == (page_size or srv.pool.max_len)
    vocab = tcfg.vocab_size
    assert_same_run(serve(system, TC, jobs_for(vocab)),
                    serve(build(), TC, jobs_for(vocab)), **LOGIT_TOL)
