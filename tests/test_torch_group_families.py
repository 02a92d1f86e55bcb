"""Device groups over the RWKV6, Mamba2/zamba2 and encoder-decoder block
kinds in the port against the JAX reference, in f32 on the CPU (a group's
slots all name the ``cpu`` device).

* ``FAMILY_MESH``: reduced ``rwkv6_7b``, ``zamba2_7b`` and
  ``seamless_m4t_large_v2`` on a (2, 4) group x fused / serial x slab /
  paged (page 2) give the reference's ``mesh=None`` token streams,
  virtual clocks and ``round_stats`` exactly, its logits within rtol 2e-4
  / atol 1e-5, and the port's own solo run's within ``LOGIT_TOL``;
  zamba2 at atol 1e-4 in both (ROADMAP C2: its recurrences amplify f32
  rounding);
* the recurrent states the reference's rules replicate over ``model``
  (``wkv``, ``ssm``, ``conv``, ``shift_*``) are equal on every model slot
  after a prefill and a decode round, and equal to the solo pool's rows;
* paged page arrays split over ``data`` (the reference's layout: servers
  of 260 memory units hold 35 pages and the trash page, 18 a data slot,
  on (2, 2); zamba2's of 520, 37 and the trash page): rows read and write
  pages another data slot holds, the moves counted in
  ``count_collectives`` and ``decode_step_cost``, and the streams, clocks
  and ``round_stats`` stay the reference's and the solo run's.

Weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``repro_torch.weights.from_reference``; prompts and frames come from a
seeded numpy RNG.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro import serving as RS
from repro.configs import get_reduced_config
from repro.models import init_params as r_init_params
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.launch.mesh import GroupMesh
from repro_torch.weights import from_reference

torch.set_num_threads(1)

FAMILY_MESH = [("rwkv6_7b", (2, 4)), ("zamba2_7b", (2, 4)),
               ("seamless_m4t_large_v2", (2, 4))]
LAYOUTS = [("slab", None), ("paged", 2)]
REF_TOL = {"zamba2_7b": dict(rtol=2e-4, atol=1e-4)}
SOLO_TOL = {"zamba2_7b": dict(rtol=1e-4, atol=1e-4)}
DEFAULT_REF_TOL = dict(rtol=2e-4, atol=1e-5)
LOGIT_TOL = dict(atol=5e-6, rtol=1e-4)  # tests/test_sharded_serving.py


def cpu_mesh(shape):
    return GroupMesh(np.full(shape, "cpu", dtype=object))


@functools.lru_cache(maxsize=None)
def bridged(arch):
    cfg = get_reduced_config(arch)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, t_get_reduced_config(arch), tparams


def problem(C, cfg, n_servers=2, l_out=4, mem=1000.0):
    """tests/test_sharded_serving.py's cluster (``mem``: each server's
    memory)."""
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=mem, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3, workload=C.Workload(4,
                                                                       l_out))


def jobs_for(cfg, lengths=(4, 6, 5), enc_lens=(5, 9, 7), seed=0):
    """Prompts (and, for an enc-dec stack, frames) from a seeded RNG."""
    rng = np.random.RandomState(seed)
    jobs = []
    for n, e in zip(lengths, enc_lens):
        prompt = rng.randint(2, cfg.vocab_size, n)
        frames = rng.randn(e, cfg.frame_dim).astype(np.float32) \
            if cfg.is_enc_dec else None
        jobs.append((prompt, frames))
    return jobs


def port(arch, mem=1000.0, **kw):
    _, _, tcfg, tparams = bridged(arch)
    return TS.GeoServingSystem(tcfg, tparams, problem(TC, tcfg, mem=mem),
                               algorithm="proposed", R=2, max_new_tokens=4,
                               max_sessions=4, device="cpu", **kw)


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


@functools.lru_cache(maxsize=None)
def reference_run(arch, mode, layout, page_size):
    cfg, params, _, _ = bridged(arch)
    system = RS.GeoServingSystem(
        cfg, params, problem(RC, cfg), algorithm="proposed", R=2,
        max_new_tokens=4, max_sessions=4, decode_mode=mode,
        cache_layout=layout, page_size=page_size)
    return serve(system, RC, jobs_for(cfg))


@functools.lru_cache(maxsize=None)
def solo_run(arch, mode, layout, page_size):
    system = port(arch, decode_mode=mode, cache_layout=layout,
                  page_size=page_size)
    return serve(system, TC, jobs_for(system.cfg))


def assert_same_run(got, want, **tol):
    assert got[0] == want[0], "tokens diverge"
    assert got[1] == want[1], "virtual clocks diverge"
    assert got[3] == want[3], "round_stats diverge"
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("layout,page_size", LAYOUTS)
@pytest.mark.parametrize("mode", ["fused", "serial"])
@pytest.mark.parametrize("arch,shape", FAMILY_MESH)
def test_family_group_matches_reference_and_solo(arch, shape, mode, layout,
                                                 page_size):
    system = port(arch, mesh=cpu_mesh(shape), decode_mode=mode,
                  cache_layout=layout, page_size=page_size)
    assert all(s.n_chips == shape[0] * shape[1]
               for s in system.servers.values())
    got = serve(system, TC, jobs_for(system.cfg))
    assert_same_run(got, reference_run(arch, mode, layout, page_size),
                    **REF_TOL.get(arch, DEFAULT_REF_TOL))
    assert_same_run(got, solo_run(arch, mode, layout, page_size),
                    **SOLO_TOL.get(arch, LOGIT_TOL))


RECURRENT = ("wkv", "ssm", "conv", "shift_tm", "shift_cm")


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_replicated_recurrent_states_agree_across_model_slots(arch):
    """After a prefill and a decode round the recurrent state leaves are
    equal on every model slot of a data row block (the reference keeps
    them whole on each, ``ssm_heads_act`` having no rule), and their rows
    equal the solo server's pool within the solo tolerance."""
    system = port(arch, mesh=cpu_mesh((2, 4)))
    solo = port(arch)
    for s in (system, solo):
        sids = []
        for prompt, _ in jobs_for(s.cfg):
            route, _ = TC.shortest_path_route(s.problem,
                                              s.alive_placement(), 0)
            sids.append(s.create_session(prompt, 0, route, 4))
        assert s.try_admit_sessions(sids) == sids
        s.drain_prefill()
        s.decode_round(sids)
    checked = 0
    tol = SOLO_TOL.get(arch, LOGIT_TOL)
    for j, srv in system.servers.items():
        mesh = srv.mesh
        n_data, n_model = mesh.devices.shape
        rows = srv.pool.n_rows // n_data
        for r, tree in enumerate(solo.servers[j].pool.tree):
            for key in tree:
                if key not in RECURRENT:
                    continue
                for i in range(n_data):
                    slots = [srv.pool.slot_trees[i * n_model + m][r][key]
                             for m in range(n_model)]
                    for x in slots[1:]:
                        assert torch.equal(x, slots[0]), (j, r, key, i)
                    whole = solo.servers[j].pool.tree[r][key]
                    np.testing.assert_allclose(
                        slots[0].numpy(),
                        whole[:, i * rows:(i + 1) * rows].numpy(), **tol)
                    checked += 1
    assert checked > 0


# servers' memory whose page arrays split over data on (2, 2): 7
# block-slots, 35 pages + the trash page (zamba2: 520, 37 + 1)
SPLIT_MEM = {"zamba2_7b": 520.0}


@functools.lru_cache(maxsize=None)
def split_reference_run(arch):
    cfg, params, _, _ = bridged(arch)
    system = RS.GeoServingSystem(
        cfg, params, problem(RC, cfg, mem=SPLIT_MEM.get(arch, 260.0)),
        algorithm="proposed",
        R=2, max_new_tokens=4, max_sessions=4, cache_layout="paged",
        page_size=4)
    return serve(system, RC, jobs_for(cfg))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_236b",
                                  "zamba2_7b", "seamless_m4t_large_v2"])
def test_split_page_axis_matches_reference_and_solo(arch):
    """Page arrays whose page axis splits over ``data`` (GQA K/V, MLA's
    joint latent buffer, zamba2's shared K/V, enc-dec self K/V): each
    slot holds the reference's per-device block of pages, a row of data
    slot 1 owns pages data slot 0 holds (the allocator stays global), the
    cross-slot page reads and writes are counted in the step's
    collectives, and streams, clocks and round_stats equal the
    reference's ``mesh=None`` run and the port's solo run."""
    from repro_torch.models.layers import count_collectives
    from repro_torch.serving.kv_cache import page_blocks

    kw = dict(mem=SPLIT_MEM.get(arch, 260.0), cache_layout="paged",
              page_size=4)
    system = port(arch, mesh=cpu_mesh((2, 2)), **kw)
    split = [srv for srv in system.servers.values()
             if page_blocks(srv.mesh, srv.pool.slot_specs) == 2]
    assert split
    for srv in split:
        n_phys = srv.pool.pages.n_pages + 1
        assert n_phys in (36, 38)
        for tree in srv.pool.slot_trees[0]:
            for key in ("k", "v", "latent", "krope"):
                if key in tree:
                    assert tree[key].shape[1] == n_phys // 2, key
        cost = srv.decode_step_cost()
        assert cost.coll_by_kind["page-read"] > 0
        assert cost.coll_by_kind["page-write"] > 0
    crossed = []
    drain = system.drain_prefill

    def drain_and_look():
        drain()
        for srv in split:
            table, half = srv.pool.pages.table, srv.pool.n_rows // 2
            block = (srv.pool.pages.n_pages + 1) // 2
            # a row of data slot 1 owning a page of data slot 0's block
            crossed.append(bool(((table[half:] > 0)
                                 & (table[half:] < block)).any()))

    system.drain_prefill = drain_and_look
    with count_collectives() as coll:
        got = serve(system, TC, jobs_for(system.cfg))
    assert any(crossed)
    assert coll.by_kind["page-read"] > 0 and coll.by_kind["page-write"] > 0
    assert_same_run(got, split_reference_run(arch),
                    **REF_TOL.get(arch, DEFAULT_REF_TOL))
    assert_same_run(got, serve(port(arch, **kw), TC, jobs_for(system.cfg)),
                    **SOLO_TOL.get(arch, LOGIT_TOL))
