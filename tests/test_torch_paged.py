"""The port's paged cache pools against the JAX reference's, on the CPU.

* ``PagePool``: the same random alloc / grow / free sequences (the seeds
  and strategy of tests/test_paged_pools.py) give the reference's tables,
  counts and free lists after every operation, and the same invariants;
* ``CachePool(layout="paged")``: page-unit accounting, the solo-fit
  bound and the co-residency unlock equal the reference's;
* the engine scenarios of tests/test_paged_pools.py on the reduced llama3
  with bridged weights — preempt-mid-decode resume, preemption composed
  with failover, a silent crash of the victim's server mid-swap, retiring
  a preempted session, the oversubscribed cohort and the scheduler's
  preemption counts: token streams, virtual clocks, admissions and
  ``round_stats`` identical to the reference's paged engine, and paged
  streams equal to slab streams in the port;
* paged zamba2 (shared-attention K/V paged, Mamba states row-resident) at
  the zamba2 tolerance of ROADMAP C (logits atol 1e-4, rtol 2e-4).
"""
import functools
import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as RC
import repro_torch.core as TC
from repro import serving as RS
from repro.configs import get_reduced_config
from repro.models import init_params
from repro.serving.kv_cache import TRASH_PAGE as R_TRASH
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.serving.kv_cache import TRASH_PAGE
from repro_torch.weights import from_reference

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def model(arch="llama3_2_1b"):
    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, tcfg, from_reference(
        jax.tree.map(np.asarray, params), "cpu")


# ---------------------------------------------------------------------------
# PagePool: the reference's tables over the same operation sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 4, 5, 16, 17, 33])
@pytest.mark.parametrize("page", [1, 2, 4, 16])
def test_pages_for_matches_reference(n, page):
    assert TS.pages_for(n, page) == RS.pages_for(n, page)
    assert TRASH_PAGE == R_TRASH == 0


def _state(pool):
    return (pool.table.tolist(), pool.count.tolist(), list(pool._free),
            pool.free_pages, pool.used_pages)


def _twin_ops(ref, port, rng: random.Random, n_ops: int):
    """tests/test_paged_pools.py's random alloc/grow/free driver, applied
    to both allocators; their whole state must agree after every op."""
    live_rows = {}
    log = []
    for _ in range(n_ops):
        op = rng.random()
        act = None
        if op < 0.45 and len(live_rows) < ref.n_rows:
            row = rng.randrange(ref.n_rows)
            have = live_rows.get(row, 0)
            want = min(have + rng.randint(1, 3), ref.max_pages_per_row)
            act = ("grow", row, want, have)
        elif op < 0.7 and live_rows:
            row = rng.choice(sorted(live_rows))
            have = live_rows[row]
            want = min(have + rng.randint(1, 4), ref.max_pages_per_row)
            act = ("grow", row, want, have)
        elif live_rows:
            row = rng.choice(sorted(live_rows))
            act = ("free", row)
        if act is not None and act[0] == "grow":
            _, row, want, have = act
            ok = ref.can_grow(row, want)
            assert port.can_grow(row, want) == ok
            if want > have and ok:
                got = ref.grow_to(row, want)
                assert port.grow_to(row, want) == got
                log.append(("grow", row, want, tuple(got)))
                live_rows[row] = want
        elif act is not None:
            freed = ref.free_row(act[1])
            assert port.free_row(act[1]) == freed
            log.append(("free", act[1], tuple(freed)))
            del live_rows[act[1]]
        port.check_invariants()
        assert _state(port) == _state(ref)
        for r in range(ref.n_rows):
            assert port.pages_of(r) == ref.pages_of(r)
    return log


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_pagepool_random_ops_match_reference(seed):
    rng = random.Random(seed)
    shape = dict(n_pages=rng.randint(4, 24), n_rows=rng.randint(2, 8),
                 max_pages_per_row=rng.randint(2, 6))
    ref, port = RS.PagePool(**shape), TS.PagePool(**shape)
    _twin_ops(ref, port, rng, n_ops=60)
    live = [p for r in range(port.n_rows) for p in port.pages_of(r)]
    assert len(live) == len(set(live)) and TRASH_PAGE not in live


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_pagepool_deterministic_replay(seed):
    logs, tables = [], []
    for _ in range(2):
        rng = random.Random(seed)
        shape = dict(n_pages=rng.randint(4, 24), n_rows=rng.randint(2, 8),
                     max_pages_per_row=rng.randint(2, 6))
        port = TS.PagePool(**shape)
        logs.append(_twin_ops(RS.PagePool(**shape), port, rng, n_ops=40))
        tables.append(port.table.copy())
    assert logs[0] == logs[1]
    np.testing.assert_array_equal(tables[0], tables[1])


def test_pagepool_exhaustion_and_width_overflow():
    pool = TS.PagePool(n_pages=3, n_rows=2, max_pages_per_row=4)
    pool.grow_to(0, 2)
    assert pool.can_grow(1, 1) and not pool.can_grow(1, 2)
    with pytest.raises(RuntimeError, match="page"):
        pool.grow_to(1, 2)
    with pytest.raises(RuntimeError, match="page"):
        pool.grow_to(0, 5)
    pool.check_invariants()
    assert pool.free_pages == 1
    first = pool.free_row(0)
    assert sorted(pool.grow_to(1, 3)) == sorted(first + [3])
    pool.check_invariants()


# ---------------------------------------------------------------------------
# CachePool: page-granular eq. (5) accounting
# ---------------------------------------------------------------------------


def _pools(**kw):
    args = dict(n_rows=4, max_len=8, cap_slots=4, layout="paged",
                page_size=2)
    args.update(kw)
    return (RS.CachePool(get_reduced_config("llama3_2_1b"),
                         ("decoder", "decoder"), **args),
            TS.CachePool(t_get_reduced_config("llama3_2_1b"),
                         ("decoder", "decoder"), device="cpu", **args))


def test_cache_pool_page_units_accounting():
    ref, port = _pools()
    assert port.cap_units == ref.cap_units == port.cap_slots * port.max_pages
    assert port.pages.n_pages == ref.pages.n_pages
    for op in [("alloc", 7, 2, 1), ("grow", 7, 3), ("alloc", 8, 1, 2),
               ("release", 7), ("release", 8)]:
        for pool in (ref, port):
            if op[0] == "alloc":
                pool.alloc(sid=op[1], k_blocks=op[2], n_pages=op[3])
            elif op[0] == "grow":
                assert pool.can_grow(op[1], op[2])
                pool.grow_pages(op[1], op[2])
            else:
                pool.release(op[1])
        assert port.usage() == ref.usage()
        np.testing.assert_array_equal(port.pages.table, ref.pages.table)
        np.testing.assert_array_equal(port.page_table().numpy(),
                                      np.asarray(ref.page_table()))
    assert port.usage() == (0, port.cap_units)
    port.pages.check_invariants()
    assert port.pages.free_pages == port.pages.n_pages
    # the physical arrays: trash page + n_pages pages of page_size tokens
    k = port.tree[0]["k"]
    assert tuple(k.shape) == tuple(ref.tree[0]["k"].shape)
    assert k.shape[1] == port.pages.n_pages + 1 and k.shape[2] == 2


def test_cache_pool_worst_case_solo_fit_bound():
    ref, port = _pools()
    cases = [(2, 1, port.max_pages), (2, 1, port.max_pages + 1),
             (port.cap_units // port.max_pages + 1, 1, port.max_pages),
             (1, 3, None), (4, 2, port.max_pages)]
    got = [port.fits(1, k, n_pages=p, worst_pages=w) for k, p, w in cases]
    assert got == [ref.fits(1, k, n_pages=p, worst_pages=w)
                   for k, p, w in cases]
    assert got[:3] == [True, False, False]


def test_cache_pool_paged_books_pages_not_slots():
    ref_slab, port_slab = _pools(layout="slab", page_size=0)
    ref, port = _pools()
    counts = []
    for slab, paged in ((ref_slab, ref), (port_slab, port)):
        n_slab = n_paged = 0
        for sid in range(16):
            if slab.fits(sid, k_blocks=2):
                slab.alloc(sid, 2)
                n_slab += 1
            if paged.fits(sid, 2, n_pages=1, worst_pages=paged.max_pages):
                paged.alloc(sid, 2, n_pages=1)
                n_paged += 1
        counts.append((n_slab, n_paged))
    assert counts[0] == counts[1] and counts[1][1] > counts[1][0]


def test_paged_prefill_write_matches_slab_rows():
    """The serial path's per-page prefill write lands the prompt's K/V in
    the row's pages: gathered back, it equals the slab row."""
    tcfg = t_get_reduced_config("llama3_2_1b")
    kinds = ("decoder", "decoder")
    paged = TS.CachePool(tcfg, kinds, n_rows=3, max_len=8, cap_slots=6,
                         layout="paged", page_size=2, device="cpu")
    slab = TS.CachePool(tcfg, kinds, n_rows=3, max_len=8, cap_slots=6,
                        device="cpu")
    g = torch.Generator().manual_seed(0)
    entries = [{key: torch.randn((1, 5, tcfg.n_kv_heads, tcfg.head_dim),
                                 generator=g) for key in ("k", "v")}
               for _ in kinds]
    for pool in (paged, slab):
        pool.alloc(0, 1, n_pages=1)
        row = pool.alloc(3, 2, n_pages=3)
        pool.write_prefill_range(0, 2, row, entries, 5)
    from repro_torch.models.layers import NULL
    from repro_torch.serving.kv_cache import _gather_paged
    scratch = _gather_paged([NULL], paged.runs, [paged.tree],
                            [paged.page_table()], 2)[0]
    r_p, r_s = paged.rows[3], slab.rows[3]
    for key in ("k", "v"):
        torch.testing.assert_close(scratch[0][key][:, r_p, :5],
                                   slab.tree[0][key][:, r_s, :5],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Engine scenarios: reference paged engine vs the port's
# ---------------------------------------------------------------------------


def _problem(C, cfg, mem, max_new, n_servers):
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=mem, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3,
                     workload=C.Workload(4, max_new))


def _systems(layout, mem=2000.0, max_new=6, n_servers=2, max_sessions=4,
             page_size=None, arch="llama3_2_1b", decode_mode="fused",
             prefill_mode="batched"):
    """(reference system, port system) of tests/test_paged_pools.py's
    ``_build_system``."""
    cfg, params, tcfg, tparams = model(arch)
    kw = dict(algorithm="proposed", R=2, max_new_tokens=max_new,
              max_sessions=max_sessions, decode_mode=decode_mode,
              prefill_mode=prefill_mode, cache_layout=layout,
              page_size=page_size)
    return (RS.GeoServingSystem(cfg, params, _problem(RC, cfg, mem, max_new,
                                                      n_servers), **kw),
            TS.GeoServingSystem(tcfg, tparams,
                                _problem(TC, tcfg, mem, max_new, n_servers),
                                device="cpu", **kw))


def _admit(C, system, lengths, n_new, seed=0, expect_all=True):
    rng = np.random.RandomState(seed)
    sids = []
    for n in lengths:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids.append(system.create_session(
            rng.randint(2, system.cfg.vocab_size, n), 0, route, n_new))
    admitted = system.try_admit_sessions(sids)
    if expect_all:
        assert admitted == sids
    system.drain_prefill()
    return sids, admitted


def _run_to_completion(system, sids, n_new, max_rounds=500):
    rounds = 0
    while any(system.sessions[s].n_generated < n_new for s in sids):
        system.decode_round()
        rounds += 1
        assert rounds < max_rounds, "decode did not converge"
    return [list(system.sessions[s].tokens) for s in sids], \
        [float(system.sessions[s].virtual_time) for s in sids]


SESSION_FIELDS = ("state", "pos", "n_generated", "n_preemptions",
                  "n_replays", "n_detections", "n_retries", "replay_time",
                  "detect_time", "backoff_time", "virtual_time", "end")


def _assert_twins(ref, port, sids):
    """Streams, per-session clocks/counters, round_stats, slot usage and
    the servers' page tables identical."""
    for sid in sids:
        a, b = ref.sessions[sid], port.sessions[sid]
        assert list(a.tokens) == list(b.tokens), sid
        assert a.route.servers == b.route.servers
        for f in SESSION_FIELDS:
            assert getattr(a, f) == getattr(b, f), (sid, f)
    assert ref.round_stats == port.round_stats
    assert ref.slot_usage() == port.slot_usage()
    for j, srv in port.servers.items():
        np.testing.assert_array_equal(srv.pool.pages.table,
                                      ref.servers[j].pool.pages.table)
        srv.pool.pages.check_invariants()


def _drive(layout, scenario, **kw):
    """Run ``scenario(C, system)`` on both engines; returns the systems and
    the port's sids after checking them twin for twin."""
    ref, port = _systems(layout, **kw)
    sids = scenario(RC, ref)
    assert scenario(TC, port) == sids
    _assert_twins(ref, port, sids)
    return ref, port, sids


@pytest.fixture(scope="module")
def slab_streams():
    """The port's unpreempted big-memory slab run: what every preemption
    scenario's streams must equal (2 sessions, 2 servers, 6 new tokens)."""
    _, port = _systems("slab")
    sids, _ = _admit(TC, port, (4, 5), n_new=6)
    return _run_to_completion(port, sids, n_new=6)


def test_paged_unpreempted_equals_slab(slab_streams):
    """No page pressure: the paged engine is the slab engine — streams and
    virtual clocks identical — and the reference's paged engine's twin."""
    def scenario(C, system):
        sids, _ = _admit(C, system, (4, 5), n_new=6)
        _run_to_completion(system, sids, n_new=6)
        return sids

    _, port, sids = _drive("paged", scenario, page_size=2)
    toks = [list(port.sessions[s].tokens) for s in sids]
    vts = [float(port.sessions[s].virtual_time) for s in sids]
    assert (toks, vts) == slab_streams
    assert port.round_stats["preemptions"] == 0


@pytest.mark.parametrize("decode_mode,prefill_mode", [
    ("fused", "batched"), ("serial", "batched"), ("fused", "serial")])
def test_preempt_mid_decode_resumes_bit_exact(slab_streams, decode_mode,
                                              prefill_mode):
    def scenario(C, system):
        sids, _ = _admit(C, system, (4, 5), n_new=6)
        system.decode_round(sids)
        system.preempt_session(sids[0])
        assert system.sessions[sids[0]].state == "preempted"
        assert all(sids[0] not in srv.pool.rows
                   for srv in system.servers.values())
        _run_to_completion(system, sids, n_new=6)
        return sids

    _, port, sids = _drive("paged", scenario, page_size=2,
                           decode_mode=decode_mode,
                           prefill_mode=prefill_mode)
    ref_toks, ref_vts = slab_streams
    assert [list(port.sessions[s].tokens) for s in sids] == ref_toks
    replays = [port.sessions[s].replay_time for s in sids]
    assert replays[0] > 0.0 and replays[1] == 0.0
    assert [port.sessions[s].virtual_time for s in sids] == pytest.approx(
        [r + p for r, p in zip(ref_vts, replays)])
    assert port.round_stats["resumes"] >= 1


def test_preemption_composes_with_failover(slab_streams):
    def scenario(C, system):
        sids, _ = _admit(C, system, (4, 5), n_new=6)
        system.decode_round(sids)
        system.preempt_session(sids[0])
        system.kill_server(system.sessions[sids[0]].route.servers[0])
        _run_to_completion(system, sids, n_new=6)
        return sids

    _, port, sids = _drive("paged", scenario, page_size=2, n_servers=4)
    assert [list(port.sessions[s].tokens) for s in sids] == slab_streams[0]
    assert port.round_stats["replays"] >= 2


def test_crash_of_preemption_victim_mid_swap(slab_streams):
    dead = {}

    def scenario(C, system):
        sids, _ = _admit(C, system, (4, 5), n_new=6)
        system.decode_round(sids)
        system.preempt_session(sids[0])
        dead[C] = system.sessions[sids[0]].route.servers[0]
        system.inject_crash(dead[C])
        _run_to_completion(system, sids, n_new=6)
        return sids

    _, port, sids = _drive("paged", scenario, page_size=2, n_servers=4)
    assert [list(port.sessions[s].tokens) for s in sids] == slab_streams[0]
    victim = port.sessions[sids[0]]
    assert dead[TC] not in victim.route.servers
    assert victim.n_detections >= 1 and victim.recovery_time > 0.0
    assert port.suspected_servers() == [dead[TC]]


def test_retire_preempted_session_is_clean():
    def scenario(C, system):
        sids, _ = _admit(C, system, (4,), n_new=6)
        system.decode_round(sids)
        system.preempt_session(sids[0])
        assert system.retire_session(sids[0]) is not None
        return sids

    ref, port = _systems("paged", page_size=2)
    sids = scenario(RC, ref)
    assert scenario(TC, port) == sids
    assert port.slot_usage() == ref.slot_usage()
    assert all(u == 0 for u, _ in port.slot_usage().values())
    assert ref.round_stats == port.round_stats
    for srv in port.servers.values():
        srv.pool.pages.check_invariants()


def test_oversubscription_slab_refuses_paged_serves():
    """A 10-session cohort the slab budget refuses is admitted whole and
    served to completion under paged accounting, preempting under page
    pressure — on both engines alike, and equal to the port's uncontended
    slab streams."""
    n_new, lengths = 30, [4] * 10
    _, big = _systems("slab", mem=5000.0, max_new=n_new, max_sessions=12)
    big_sids, _ = _admit(TC, big, lengths, n_new)
    big_toks, _ = _run_to_completion(big, big_sids, n_new)

    admitted = []
    for C, system in zip((RC, TC), _systems("slab", mem=250.0,
                                            max_new=n_new,
                                            max_sessions=12)):
        admitted.append(_admit(C, system, lengths, n_new,
                               expect_all=False)[1])
    assert admitted[0] == admitted[1] and len(admitted[1]) < len(lengths)

    def scenario(C, system):
        sids, _ = _admit(C, system, lengths, n_new)
        _run_to_completion(system, sids, n_new, max_rounds=3000)
        return sids

    _, port, sids = _drive("paged", scenario, mem=250.0, max_new=n_new,
                           max_sessions=12, page_size=2)
    assert [list(port.sessions[s].tokens) for s in sids] == big_toks
    assert port.round_stats["preemptions"] >= 1
    assert port.round_stats["resumes"] >= 1


RECORD_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped", "n_deferrals",
                 "n_preemptions", "n_replays", "replay_time")


def test_scheduler_reports_preemptions():
    """Through ContinuousBatchingScheduler on the oversubscribed topology:
    every request completes, ServedRequest records (preemption counts
    included) are identical, and the counts reconcile with round_stats."""
    n_new = 30
    outs = []
    systems = _systems("paged", mem=250.0, max_new=n_new, max_sessions=12,
                       page_size=2)
    for S, system in zip((RS, TS), systems):
        sched = S.ContinuousBatchingScheduler(system, R=12)
        rng = np.random.RandomState(0)
        for rid in range(10):
            sched.submit(rid, rng.randint(2, system.cfg.vocab_size, 4),
                         arrival=0.0, n_new=n_new)
        outs.append(sched.run())
    ref_out, port_out = outs
    assert len(port_out) == 10 and not any(r.dropped for r in port_out)
    for a, b in zip(ref_out, port_out):
        assert list(a.tokens) == list(b.tokens)
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert systems[0].round_stats == systems[1].round_stats
    assert (sum(r.n_preemptions for r in port_out)
            == systems[1].round_stats["preemptions"] >= 1)


def test_scheduler_slot_scale_matches_reference():
    from repro.serving.scheduler import _slot_scale as r_scale
    from repro_torch.serving.scheduler import _slot_scale as t_scale
    for layout, page in (("slab", None), ("paged", 2), ("paged", None)):
        ref, port = _systems(layout, page_size=page, max_new=30)
        assert port.page_size == ref.page_size
        assert t_scale(port) == r_scale(ref)


def test_page_size_must_divide_max_seq_len():
    _, _, tcfg, tparams = model()
    with pytest.raises(ValueError, match="page_size"):
        TS.GeoServingSystem(tcfg, tparams, _problem(TC, tcfg, 2000.0, 6, 2),
                            R=2, max_new_tokens=6, max_seq_len=42,
                            cache_layout="paged", page_size=4, device="cpu")


def test_paged_zamba2_shared_kv_paged_states_resident():
    """zamba2 under paged: the shared-attention K/V leaves page while the
    Mamba states stay row-resident; a mid-decode preemption resumes to the
    reference's streams, clocks and round_stats, and to the port's slab
    streams; logits at the zamba2 tolerance of ROADMAP C."""
    def scenario(C, system):
        sids, _ = _admit(C, system, (4, 6), n_new=4)
        system.decode_round(sids)
        system.preempt_session(sids[1])
        _run_to_completion(system, sids, n_new=4)
        return sids

    ref, port, sids = _drive("paged", scenario, arch="zamba2_7b",
                             page_size=2, max_new=4)
    shared = [(srv.pool, t) for srv in port.servers.values()
              for (kind, _, _), t in zip(srv.pool.runs, srv.pool.tree)
              if kind == "mamba_shared"]
    assert shared, "no server hosts a shared-attention block"
    for pool, t in shared:
        assert tuple(t["k"].shape[1:3]) == (pool.pages.n_pages + 1, 2)
        assert t["ssm"].shape[1] == pool.n_rows
    for sid in sids:
        np.testing.assert_allclose(
            port.sessions[sid].last_logits.numpy(),
            np.asarray(ref.sessions[sid].last_logits), rtol=2e-4, atol=1e-4)
    _, slab = _systems("slab", arch="zamba2_7b", max_new=4)
    slab_sids, _ = _admit(TC, slab, (4, 6), n_new=4)
    slab_toks, _ = _run_to_completion(slab, slab_sids, n_new=4)
    assert [list(port.sessions[s].tokens) for s in sids] == slab_toks
    assert port.round_stats["preemptions"] == 1


def test_scheduler_routes_on_engine_placement():
    """The paged eq. (20) scale shrinks the controller's s_c, and CG-BP on
    that scaled problem can place blocks differently from the engine: on
    chip_smoke.py's 5-server cluster the reference's controller then
    routes through block ranges the engine's servers do not host (a
    reference fault, ROADMAP C).  The port's controller routes on the
    engine's placement, so paged streams equal slab streams."""
    from repro.core.online import OnlineBPRR as ROnline
    from repro.serving.scheduler import _slot_scale as r_scale
    from repro_torch.models import init_params as t_init_params

    tcfg = t_get_reduced_config("llama3_2_1b").replace(n_layers=16)
    params = t_init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def problem(C):
        llm = C.LLMSpec("t", 16, block_bytes=50.0,
                        cache_bytes_per_token=0.25)
        mem = (1600.0, 1600.0, 700.0, 700.0, 700.0)
        tau = (0.004, 0.004, 0.02, 0.02, 0.02)
        rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
        return C.Problem(llm, [C.ServerSpec(j, m, t) for j, (m, t) in
                               enumerate(zip(mem, tau))], 1, rtt, 3 * rtt,
                         workload=C.Workload(128, 32))

    rng = np.random.RandomState(0)
    lens = rng.randint(32, 129, 6)
    reqs = [(rid, rng.randint(2, tcfg.vocab_size, int(n)), 0.3 * rid)
            for rid, n in enumerate(lens)]
    streams = {}
    for layout in ("slab", "paged"):
        system = TS.GeoServingSystem(
            tcfg, params, problem(TC), R=4, max_new_tokens=8,
            max_sessions=8, max_seq_len=176, cache_layout=layout,
            page_size=16, device="cpu")
        routes = []
        create = system.create_session

        def recording(tokens, client, route, *a, **kw):
            routes.append(route)
            return create(tokens, client, route, *a, **kw)

        system.create_session = recording
        sched = TS.ContinuousBatchingScheduler(system, R=4)
        for rid, toks, t in reqs:
            sched.submit(rid, toks, t, n_new=8)
        streams[layout] = [list(r.tokens) for r in sched.run()]
        pl = system.placement
        assert len(routes) == len(reqs)
        for route in routes:  # every hop's blocks are hosted by its server
            e = 0
            for j, k in zip(route.servers, route.blocks):
                assert pl.a[j] <= e and e + k <= pl.a[j] + pl.m[j], route
                e += k
        # the reference's controller on the same engine: another placement
        ref_ctl = ROnline(problem(RC), R=4, slot_scale=r_scale(system))
        differs = (list(ref_ctl.placement.m) != list(system.placement.m)
                   or list(ref_ctl.placement.a) != list(system.placement.a))
        assert differs == (layout == "paged")
    assert streams["paged"] == streams["slab"]


def test_legacy_generate_grows_pages():
    """The single-session API (``submit`` / ``decode`` via ``generate``)
    grows the session's pages before each step: the reference's tokens
    and clock, and the slab layout's tokens."""
    prompt = np.random.RandomState(4).randint(2, 256, 5)
    ref, port = _systems("paged", page_size=2, max_new=6)
    r_toks, r_vt = RS.generate(ref, prompt, 6)
    t_toks, t_vt = TS.generate(port, prompt, 6)
    assert list(t_toks) == list(r_toks) and t_vt == r_vt
    _, slab = _systems("slab", max_new=6)
    assert list(TS.generate(slab, prompt, 6)[0]) == list(t_toks)
    assert all(u == 0 for u, _ in port.slot_usage().values())
