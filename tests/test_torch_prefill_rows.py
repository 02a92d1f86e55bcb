"""Batched prefill's one-row calls on the CPU: where a server steps a pool
row alone (``BlockServer.row_calls``: a solo server, or a group whose rows
do not shard over ``data``), each member of a bucket group is prefilled in
its own pooled call over one row, its pool row, the step's operands cut to
that row (``kv_cache.pool_row_view``).

On slab and paged pools, for an attention stack (reduced Llama), a
recurrent hybrid (reduced Zamba2: Mamba2 state, shared attention, the
original embeddings) and an encoder-decoder (reduced SeamlessM4T: cross
K/V) stack, after a two-member group prefill beside a session already
decoding:

* every call is one row, its mask (m, 1), its operand that row's views;
* every pool row (paged: every page and row-resident leaf) outside the
  group is bit-identical to before;
* each member's row holds what it holds when the member is prefilled
  alone, and its first token and logits are the same: on the attention
  stacks the prompts are longer than the largest bucket, so the chunk at
  offset 8 reads its own row's prefix from the pool;
* a group whose rows shard over ``data`` keeps the call over every pool
  row, and serves the solo engine's streams.
"""
import functools

import numpy as np
import pytest
import torch

import repro_torch.core as C
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import GroupMesh
from repro_torch.models import init_params
from repro_torch.serving import GeoServingSystem
from repro_torch.serving.kv_cache import _LENGTH_KEYS, TRASH_PAGE

torch.set_num_threads(1)

ARCHS = ["llama3_2_1b", "zamba2_7b", "seamless_m4t_large_v2"]
LAYOUTS = ["slab", "paged"]
# background prompt, then the two members: the attention stacks' members
# run two chunks of 8 (the largest bucket); the recurrent stack groups by
# exact length
LENGTHS = {"llama3_2_1b": (5, 11, 13), "zamba2_7b": (5, 6, 6),
           "seamless_m4t_large_v2": (5, 11, 13)}
ENC_LEN = 6


@functools.lru_cache(maxsize=None)
def model(arch):
    cfg = get_reduced_config(arch)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _system(arch, layout, **kw):
    """Two servers of equal τ; R = 2 puts every block on both."""
    cfg, params = model(arch)
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=1000.0, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(2)]
    rtt = np.full((1, 2), 0.02)
    prob = C.Problem(llm, servers, 1, rtt, 3 * rtt,
                     workload=C.Workload(8, 4))
    return GeoServingSystem(cfg, params, prob, R=2, max_new_tokens=4,
                            max_sessions=4, max_seq_len=32,
                            prefill_buckets=(4, 8), cache_layout=layout,
                            page_size=4, device="cpu", **kw)


def _jobs(arch):
    cfg = model(arch)[0]
    rng = np.random.RandomState(3)
    return [(rng.randint(2, cfg.vocab_size, n),
             rng.randn(ENC_LEN, cfg.frame_dim).astype(np.float32)
             if cfg.is_enc_dec else None) for n in LENGTHS[arch]]


def _admit(system, jobs):
    route, _ = C.shortest_path_route(system.problem,
                                     system.alive_placement(), 0)
    sids = [system.create_session(p, 0, route, 3, frames=f)
            for p, f in jobs]
    assert system.try_admit_sessions(sids) == sids
    return sids


def _started(arch, layout, **kw):
    """A system with one session prefilled and one decode round in."""
    system = _system(arch, layout, **kw)
    bg = _admit(system, _jobs(arch)[:1])
    system.drain_prefill()
    system.decode_round(bg)
    return system


def _leaves(system):
    """{(server, run, key): a copy of the leaf}."""
    return {(j, r, k): x.clone()
            for j, srv in system.servers.items()
            for r, tree in enumerate(srv.pool.tree) for k, x in tree.items()}


def _row_state(system, sid):
    """{(server, run, key): the session's row of each leaf (paged: its
    pages, in table order)}."""
    out = {}
    for j, srv in system.servers.items():
        pool = srv.pool
        if sid not in pool.rows:
            continue
        row = pool.rows[sid]
        for r, tree in enumerate(pool.tree):
            for k, x in tree.items():
                if pool.layout == "paged" and k in _LENGTH_KEYS:
                    out[j, r, k] = x[:, pool.pages.pages_of(row)]
                else:
                    out[j, r, k] = x[:, row]
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_group_prefill_writes_its_rows_alone(arch, layout):
    system = _started(arch, layout)
    calls = []
    for srv in system.servers.values():
        assert srv.row_calls
        real = srv.prefill_rows

        def spy(h, mask, *a, real=real, srv=srv, **kw):
            calls.append((srv.sid, h.shape[0], mask.shape[1], kw.get("row"),
                          kw.get("emb0_rows"), kw.get("phase")))
            return real(h, mask, *a, **kw)

        srv.prefill_rows = spy
    before = _leaves(system)
    sids = _admit(system, _jobs(arch)[1:])
    assert len(system._prefill_groups) == 1
    groups = system._prefill_groups[0].members
    assert [s.sid for s in groups] == sids
    system.drain_prefill()
    member_rows = {j: {srv.pool.rows[s] for s in sids if s in srv.pool.rows}
                   for j, srv in system.servers.items()}
    dec = [c for c in calls if c[-1] != "enc"]  # the encoder pass aside
    assert dec and all(n == 1 and m == 1 and row in member_rows[j]
                       for j, n, m, row, _, _ in dec)
    assert all((e0 is not None) == system._needs_emb0
               for _, _, _, _, e0, _ in dec)
    for (j, r, k), old in before.items():
        srv = system.servers[j]
        new = srv.pool.tree[r][k]
        if layout == "paged" and k in _LENGTH_KEYS:
            theirs = {p for row in member_rows[j]
                      for p in srv.pool.pages.pages_of(row)}
            keep = [p for p in range(new.shape[1])
                    if p not in theirs and p != TRASH_PAGE]
        else:
            keep = [row for row in range(new.shape[1])
                    if row not in member_rows[j]]
        assert keep
        assert torch.equal(new[:, keep], old[:, keep]), (j, r, k)
    for sid in sids:
        assert system.sessions[sid].state == "active"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_members_rows_equal_each_prefilled_alone(arch, layout):
    jobs = _jobs(arch)[1:]
    grouped = _started(arch, layout)
    sids = _admit(grouped, jobs)
    assert len(grouped._prefill_groups) == 1
    chunked = not grouped._recurrent
    if chunked:  # both prompts run chunks at offsets 0 and 8
        assert grouped._prefill_groups[0].bucket is None
        assert [o for o, _, _ in grouped._prefill_plan(11)] == [0, 8]
    grouped.drain_prefill()
    alone = _started(arch, layout)
    solo = []
    for job in jobs:
        solo += _admit(alone, [job])
        alone.drain_prefill()
    for g, s in zip(sids, solo):
        want, got = _row_state(alone, s), _row_state(grouped, g)
        assert want.keys() == got.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), (g, key)
        a, b = alone.sessions[s], grouped.sessions[g]
        assert a.tokens == b.tokens
        assert torch.equal(a.last_logits, b.last_logits)
        assert a.prefill_time == b.prefill_time


@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_split_group_keeps_the_pooled_call(layout):
    """On (2, 2) groups the four pool rows shard over ``data``: each hop
    is one call over every row, and the streams are the solo engine's."""
    arch = "llama3_2_1b"
    mesh = GroupMesh(np.full((2, 2), "cpu", dtype=object))
    system = _system(arch, layout, mesh=mesh)
    shapes = []
    for srv in system.servers.values():
        assert not srv.row_calls and srv.pool.n_rows == 4
        real = srv.prefill_rows

        def spy(h, mask, *a, real=real, **kw):
            shapes.append((h.shape[0], tuple(mask.shape[1:]), kw.get("row")))
            return real(h, mask, *a, **kw)

        srv.prefill_rows = spy
    solo = _system(arch, layout)
    runs = []
    for s in (system, solo):
        sids = _admit(s, _jobs(arch))
        s.drain_prefill()
        while any(s.sessions[i].n_generated < 3 for i in sids):
            s.decode_round([i for i in sids if s.sessions[i].n_generated < 3])
        runs.append([(list(s.sessions[i].tokens), s.sessions[i].last_logits)
                     for i in sids])
    assert shapes and set(shapes) == {(4, (4,), None)}
    for (tg, lg), (ts, ls) in zip(*runs):
        assert tg == ts
        np.testing.assert_allclose(lg.numpy(), ls.numpy(), rtol=1e-4,
                                   atol=5e-6)
