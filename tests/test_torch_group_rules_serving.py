"""The reference's activation layout rules in the port's group forms of
``prefill`` / ``decode_step`` and in its serving engine, against the
solo port and the JAX reference on the CPU.

* ``attn_seq_q`` and the ``head_dim`` fallback in the group ``prefill``
  and ``decode_step`` (the rules of a prefill / decode cell): every
  reduced architecture with attention on a (1, 8) mesh — 4 query heads
  that do not divide 8 — and Llama and Gemma on (2, 8): the logits
  against the solo port's and the reference's monolithic ones, and the
  slots' cache shards, put back together, against the solo caches after
  the prefill and after the decode step;
* ``seq_act`` at prefill: reduced DeepSeek-V2 with the rule set by hand on
  its prefill rules (its 8 experts never set it; the reference's values
  do not depend on it) on (1, 2) and (2, 2);
* the engine under the ``head_dim`` fallback (``serving_rules`` clear
  ``seq_act`` and ``attn_seq_q``): reduced Llama, Gemma and SeamlessM4T
  (encoder and cross attention) served by ``GeoServingSystem(mesh=(1,
  8))`` — tokens, virtual clocks and ``round_stats`` exactly the
  reference's ``mesh=None`` run and the solo port's, logits within
  tolerance — and every slot pool leaf at the per-device shape the
  reference's serving rules give it.

Tolerances: logits at rtol 2e-4 / atol 1e-5 (tests/test_torch_dryrun.py;
gemma3 atol 5e-5), the engines' per-round logits at the tolerances of
tests/test_torch_groups.py (reference 2e-4 / 1e-5, solo atol 5e-6 / rtol
1e-4).  Weights are the reference's ``init_params(PRNGKey(0), cfg)``
bridged with ``weights.from_reference``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.serving as RS
import repro_torch.core as TC
import repro_torch.serving as TS
from repro.configs import ARCH_IDS, get_reduced_config
from repro.launch import sharding as RSH
from repro.models import NULL_SH
from repro.models import decode_step as r_decode_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.serving import kv_cache as RKV
from repro_torch.configs import ShapeSpec
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.launch.mesh import GroupMesh
from repro_torch.launch.sharding import (cache_shardings, make_ctx, shard,
                                         shard_params, unshard)
from repro_torch.models import decode_step, prefill
from repro_torch.models.layers import count_collectives, group_ctxs, row_heads
from repro_torch.serving import kv_cache as TKV
from repro_torch.weights import from_reference

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
LOGIT_ATOL = {"gemma3_4b": 5e-5, "zamba2_7b": 1e-4}
CACHE_ATOL = {"gemma3_4b": 5e-5, "zamba2_7b": 2e-4}
SOLO_TOL = dict(atol=5e-6, rtol=1e-4)
B, S, T = 4, 8, 16  # rows, prompt, cache length
ATTN_CASES = [(a, (1, 8)) for a in ARCH_IDS if a != "rwkv6_7b"] + [
    ("llama3_2_1b", (2, 8)), ("gemma3_4b", (2, 8))]


def cpu_mesh(shape):
    return GroupMesh(np.full(shape, "cpu", dtype=object))


@functools.lru_cache(maxsize=None)
def bridged(arch):
    cfg = get_reduced_config(arch)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, t_get_reduced_config(arch), tparams


def _clone(tree):
    """A copy of a cache tree (an MLA layer's latent / krope stay the
    views of one buffer)."""
    if isinstance(tree, dict):
        if "latent" in tree:
            from repro_torch.models.attention import mla_cache_views
            buf = torch.cat([tree["latent"], tree["krope"]], dim=-1)
            return dict(mla_cache_views(buf, tree["latent"].shape[-1]),
                        **{k: _clone(v) for k, v in tree.items()
                           if k not in ("latent", "krope")})
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@functools.lru_cache(maxsize=None)
def solo_run(arch):
    """The batch, and the reference's and the solo port's prefill /
    decode step (logits and caches)."""
    cfg, params, tcfg, tparams = bridged(arch)
    rng = np.random.RandomState(3)
    toks = rng.randint(2, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.is_enc_dec:
        batch = {"frames": rng.randn(B, S, cfg.frame_dim).astype(np.float32),
                 "tokens": toks}
    nxt = rng.randint(2, cfg.vocab_size, B).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: r_prefill(p, cfg, NULL_SH, b,
                                                cache_len=T))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    rd, _ = jax.jit(lambda p, c, t: r_decode_step(p, cfg, NULL_SH, c, t, S))(
        params, rcache, jnp.asarray(nxt))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tcache = prefill(tparams, tcfg, tb, cache_len=T)
    td, after = decode_step(tparams, tcfg, _clone(tcache),
                            torch.from_numpy(nxt), S)
    return dict(batch=tb, nxt=torch.from_numpy(nxt),
                ref=(np.asarray(rl), np.asarray(rd)), solo=(tl, td),
                caches=(tcache, after))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def _unshard_tree(parts, specs, mesh, like):
    if isinstance(like, dict):
        return {k: _unshard_tree([p[k] for p in parts], specs[k], mesh,
                                 like[k]) for k in like}
    return unshard(parts, specs, mesh, tuple(like.shape))


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def _assert_caches(got, want, atol, what):
    for (path, g), (_, w) in zip(_flat(got), _flat(want)):
        _close(g, w, atol, f"{what} {path}")


def run_group(arch, shape, prefill_rules=None):
    """The group prefill (under ``prefill_rules``, default the prefill
    cell's) and decode step (the decode cell's rules) of ``arch`` on a
    ``shape`` mesh, held against the solo port and the reference.
    Returns the prefill's collective count."""
    run = solo_run(arch)
    _, _, cfg, tparams = bridged(arch)
    atol = LOGIT_ATOL.get(arch, ATOL)
    mesh = cpu_mesh(shape)
    sh = make_ctx(cfg, mesh, ShapeSpec("prefill", T, B, "prefill"))
    if prefill_rules is not None:
        sh.rules = prefill_rules(dict(sh.rules))
    ctxs = group_ctxs(mesh, sh.rules)
    ps = shard_params(cfg, sh, tparams)
    bspec = sh.spec(("batch", None), (B, S))
    batches = [{} for _ in ctxs]
    for k, v in run["batch"].items():
        for d, blk in zip(batches, shard(v, bspec + (None,) * (v.dim() - 2),
                                         mesh)):
            d[k] = blk
    with count_collectives() as count:
        logits, caches = prefill(ps, cfg, batches, cache_len=T, ctxs=ctxs)
    got = torch.cat([logits[s] for s in row_heads(ctxs)])
    _close(got, run["solo"][0], atol, "prefill vs solo")
    _close(got, run["ref"][0], atol, "prefill vs reference")
    specs = cache_shardings(cfg, sh, run["caches"][0])
    _assert_caches(_unshard_tree(caches, specs, mesh, run["caches"][0]),
                   run["caches"][0], CACHE_ATOL.get(arch, ATOL),
                   "prefill caches")
    dsh = make_ctx(cfg, mesh, ShapeSpec("decode", T, B, "decode"))
    dctxs = group_ctxs(mesh, dsh.rules)
    toks = shard(run["nxt"], dsh.spec(("batch",), (B,)), mesh)
    logits, caches = decode_step(ps, cfg, caches, toks, S, ctxs=dctxs)
    got = torch.cat([logits[s] for s in row_heads(dctxs)])
    _close(got, run["solo"][1], atol, "decode vs solo")
    _close(got, run["ref"][1], atol, "decode vs reference")
    _assert_caches(_unshard_tree(caches, specs, mesh, run["caches"][1]),
                   run["caches"][1], CACHE_ATOL.get(arch, ATOL),
                   "decode caches")
    return count


@pytest.mark.parametrize("arch,shape", ATTN_CASES, ids=str)
def test_attention_rules_prefill_and_decode_match_solo_and_reference(
        arch, shape):
    cfg = bridged(arch)[2]
    sh = make_ctx(cfg, cpu_mesh(shape), ShapeSpec("prefill", T, B,
                                                  "prefill"))
    assert sh.rules["attn_seq_q"] == "model"
    assert sh.rules["head_dim"] == ("model" if cfg.head_dim % 8 == 0
                                    else None)
    count = run_group(arch, shape)
    if cfg.attn_kind != "mla":  # MLA's weights take no head_dim rule
        assert count.by_kind["all-to-all"] > 0  # head_dim <-> query rows


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_seq_act_prefill_matches_solo_and_reference(shape):
    count = run_group("deepseek_v2_236b", shape,
                      lambda rules: dict(rules, seq_act="model"))
    assert count.by_kind["reduce-scatter"] > 0
    assert count.by_kind["broadcast"] > 0  # the last position's h


# ---------------------------------------------------------------------------
# The engine under the head_dim fallback
# ---------------------------------------------------------------------------


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


def jobs_for(cfg, lengths=(4, 6, 5), enc_lens=(5, 9, 7), seed=0):
    """Prompts (and, for an enc-dec stack, frames) from a seeded RNG."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(2, cfg.vocab_size, n),
             rng.randn(e, cfg.frame_dim).astype(np.float32)
             if cfg.is_enc_dec else None)
            for n, e in zip(lengths, enc_lens)]


def serve(system, C, jobs, n_new=4):
    """Admit, prefill, decode to completion: (tokens, virtual times,
    per-round logits, round_stats)."""
    sids = []
    for prompt, frames in jobs:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        kw = {} if frames is None else {"frames": frames}
        sids.append(system.create_session(prompt, 0, route, n_new, **kw))
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


def assert_same_run(got, want, **tol):
    assert got[0] == want[0], "tokens diverge"
    assert got[1] == want[1], "virtual clocks diverge"
    assert got[3] == want[3], "round_stats diverge"
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            np.testing.assert_allclose(a, b, **tol)


def port(arch, **kw):
    _, _, tcfg, tparams = bridged(arch)
    return TS.GeoServingSystem(tcfg, tparams, problem(TC, tcfg),
                               algorithm="proposed", R=2, max_new_tokens=4,
                               max_sessions=4, device="cpu", **kw)


@pytest.mark.parametrize("arch,layout,page_size", [
    ("llama3_2_1b", "slab", None), ("llama3_2_1b", "paged", 2),
    ("gemma3_4b", "slab", None), ("seamless_m4t_large_v2", "slab", None)])
def test_engine_head_dim_group_matches_reference_and_solo(arch, layout,
                                                          page_size):
    cfg, params, tcfg, _ = bridged(arch)
    system = port(arch, mesh=cpu_mesh((1, 8)), cache_layout=layout,
                  page_size=page_size)
    srv = next(iter(system.servers.values()))
    assert srv.mesh_rules["head_dim"] == "model"
    assert srv.mesh_rules["attn_seq_q"] is None
    attn = "self_attn" if cfg.is_enc_dec else "attn"
    p = srv.slot_params[0][-1][attn]
    assert p["wq"].shape[-1] == tcfg.head_dim // 8  # its head_dim columns
    got = serve(system, TC, jobs_for(tcfg))
    ref = RS.GeoServingSystem(cfg, params, problem(RC, cfg),
                              algorithm="proposed", R=2, max_new_tokens=4,
                              max_sessions=4, cache_layout=layout,
                              page_size=page_size)
    assert_same_run(got, serve(ref, RC, jobs_for(cfg)), rtol=RTOL,
                    atol=ATOL)
    solo = port(arch, cache_layout=layout, page_size=page_size)
    assert_same_run(got, serve(solo, TC, jobs_for(tcfg)), **SOLO_TOL)
    # every slot pool leaf at the reference's per-device shape
    pool = srv.pool
    stand_in = RSH.serving_rules(cfg, _StandIn((1, 8)), pool.n_rows,
                                 pool.max_len)
    for r, (kind, lo, hi) in enumerate(TKV.kind_runs(srv.kinds)):
        ref_tree = jax.eval_shape(
            (lambda: RKV.new_paged_pool_tree(
                cfg, kind, hi - lo, pool.n_rows, pool.max_len, page_size,
                pool.pages.n_pages + 1, pool.enc_len))
            if layout == "paged" else
            (lambda: RKV.new_state_pool_tree(cfg, kind, hi - lo, pool.n_rows,
                                              pool.max_len, pool.enc_len)))
        for key, leaf in ref_tree.items():
            rs = dict(stand_in)
            spec = RSH.guarded_spec(RSH.cache_axes_for(key, leaf.ndim, rs),
                                    leaf.shape, rs, _StandIn((1, 8)))
            want = tuple(n // (8 if e == "model" else 1)
                         for n, e in zip(leaf.shape,
                                         tuple(spec) + (None,) * 9))
            for s in range(8):
                assert tuple(pool.slot_trees[s][r][key].shape) == want, \
                    (key, s, spec)


class _StandIn:
    """The two attributes of a mesh the reference's rules read."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)
