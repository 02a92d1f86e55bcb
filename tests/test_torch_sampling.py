"""The port's seeded sampling against the JAX reference's, on the CPU.

* ``serving.prng``: ``prng_key`` / ``fold_in`` / ``random_bits`` /
  ``uniform`` equal ``jax.random`` bit for bit over edge seeds and token
  indices; Gumbel draws agree within 4 float32 ulps of ``max(1, |g|)``
  (both compute ``-log(-log(u))`` from the same uniforms, but XLA's CPU
  ``log`` and torch's differ in the last bits on ~14% of inputs);
* the row sampler on single rows against the reference's ``_sample_one``
  and on batches against its vmapped sampler, for greedy,
  temperature and top-k rows (ties at the k-th value included), and the
  round tail against the reference's;
* engine streams of seeded temperature / top-k sessions on the reduced
  llama3 with bridged weights equal the reference's, fused and serial,
  solo and grouped (mirroring tests/test_family_pools.py and
  tests/test_round_fusion.py), with identical virtual clocks and
  ``round_stats``.
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
from repro.models import init_params
from repro.serving import sampling as r_sampling
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.serving import prng
from repro_torch.serving import sampling as t_sampling
from repro_torch.weights import from_reference

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
INDICES = [0, 1, 5, 2 ** 31, 2 ** 32 - 1]
EPS32 = 2.0 ** -23
GUMBEL_ULPS = 4  # |g_port - g_ref| <= 4 * EPS32 * max(1, |g_ref|)


def _jax_key(seed, index):
    return jax.random.fold_in(jax.random.PRNGKey(seed), index)


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniforms_bit_exact(seed):
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(),
                                  _words(jax.random.PRNGKey(seed)))
    for index in INDICES:
        jk = _jax_key(seed, index)
        tk = prng.fold_in(key, index)
        np.testing.assert_array_equal(tk.numpy(), _words(jk))
        np.testing.assert_array_equal(t_sampling._key_for_row(seed, index),
                                      _words(jk))
        np.testing.assert_array_equal(
            TS.SamplingSpec("temperature", seed=seed).key_for(index),
            _words(RS.SamplingSpec("temperature", seed=seed).key_for(index)))
        bits = np.asarray(jax.random.bits(jk, (1001,), jnp.uint32))
        np.testing.assert_array_equal(prng.random_bits(tk, 1001).numpy(),
                                      bits.astype(np.int64))
        tiny = jnp.finfo(jnp.float32).tiny
        for lo in (0.0, tiny):
            u = np.asarray(jax.random.uniform(jk, (1001,), jnp.float32,
                                              minval=lo, maxval=1.0))
            got = prng.uniform(tk, 1001, float(lo)).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          u.view(np.int32))


def test_keys_vectorised_over_rows():
    """The round tail derives W keys at once from (seed, index) rows."""
    seeds = np.repeat(SEEDS, len(INDICES))
    index = np.tile(INDICES, len(SEEDS))
    keys = t_sampling._key_for_row(torch.as_tensor(seeds),
                                   torch.as_tensor(index))
    want = np.stack([_words(_jax_key(int(s), int(i)))
                     for s, i in zip(seeds, index)])
    np.testing.assert_array_equal(keys.numpy(), want)
    bits = prng.random_bits(keys, 64).numpy()
    for row, (s, i) in enumerate(zip(seeds, index)):
        np.testing.assert_array_equal(bits[row], np.asarray(jax.random.bits(
            _jax_key(int(s), int(i)), (64,), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31, 2 ** 32 - 1])
def test_gumbel_within_ulps(seed):
    for index in (0, 9, 2 ** 31):
        g = np.asarray(jax.random.gumbel(_jax_key(seed, index), (50000,),
                                         jnp.float32)).astype(np.float64)
        got = prng.gumbel(prng.fold_in(prng.prng_key(seed), index),
                          50000).numpy().astype(np.float64)
        assert np.isfinite(got).all()
        err = np.abs(got - g) / (EPS32 * np.maximum(1.0, np.abs(g)))
        assert err.max() <= GUMBEL_ULPS, err.max()


# ---------------------------------------------------------------------------
# The row sampler
# ---------------------------------------------------------------------------


def _logits(rng, v, ties=False):
    x = rng.randn(v).astype(np.float32) * 3
    if ties:  # several logits tied at the k-th largest value
        order = np.argsort(-x)
        x[order[2:6]] = x[order[2]]
    return x


ROW_CASES = [
    # (temperature, top_k, ties)
    (0.0, 0, False), (0.0, 5, False), (0.7, 0, False), (1.0, 0, True),
    (0.8, 3, False), (0.8, 3, True), (0.5, 1, False), (2.0, 4, True),
    (1e-7, 0, False), (1.3, 1000, False),
]


@pytest.mark.parametrize("temperature,top_k,ties", ROW_CASES)
def test_sample_one_matches_reference(temperature, top_k, ties):
    rng = np.random.RandomState(int(temperature * 100) + top_k)
    hits = set()
    for seed in (0, 11, 2 ** 32 - 1):
        for index in range(12):
            x = _logits(rng, 300, ties)
            want = int(r_sampling._sample_one(
                jnp.asarray(x), jnp.float32(temperature), jnp.int32(top_k),
                _jax_key(seed, index)))
            got = int(TS.make_sampler()(
                torch.as_tensor(x)[None], torch.tensor([temperature]),
                torch.tensor([top_k]),
                t_sampling._key_for_row(seed, index)[None])[0])
            assert got == want, (seed, index)
            hits.add(got)
            if top_k:
                assert x[got] >= np.sort(x)[-min(top_k, 300)]
    if temperature > 1e-3 and top_k != 1:
        assert len(hits) > 1  # really stochastic


def test_sampler_rows_match_reference_vmapped():
    rng = np.random.RandomState(1)
    n, v = 7, 300
    x = np.stack([_logits(rng, v, ties=i % 2 == 0) for i in range(n)])
    temps = np.asarray([0.0, 0.7, 1.0, 0.8, 0.0, 2.0, 0.3], np.float32)
    topks = np.asarray([0, 0, 3, 5, 4, 0, 1], np.int32)
    seeds = np.asarray([0, 5, 2 ** 31, 2 ** 32 - 1, 9, 1, 77], np.uint32)
    tindex = np.asarray([0, 3, 1, 2 ** 31 - 1, 4, 0, 6], np.int32)
    want = np.asarray(r_sampling.make_sampler()(
        jnp.asarray(x), jnp.asarray(temps), jnp.asarray(topks),
        jax.vmap(r_sampling._key_for_row)(jnp.asarray(seeds),
                                          jnp.asarray(tindex))))
    got = t_sampling.sample_rows(torch.as_tensor(x), temps, topks,
                                 seeds.astype(np.int64), tindex)
    np.testing.assert_array_equal(got.numpy(), want)
    keys = t_sampling._key_for_row(torch.as_tensor(seeds.astype(np.int64)),
                                   torch.as_tensor(tindex.astype(np.int64)))
    np.testing.assert_array_equal(
        TS.make_sampler()(torch.as_tensor(x), torch.as_tensor(temps),
                          torch.as_tensor(topks), keys).numpy(), want)
    # all-greedy batch: one argmax, nothing drawn
    np.testing.assert_array_equal(
        t_sampling.sample_rows(torch.as_tensor(x), np.zeros(n, np.float32),
                               topks, seeds, tindex).numpy(),
        x.argmax(-1))


def test_round_tail_matches_reference():
    cfg, params, tcfg, tparams = model()
    rng = np.random.RandomState(2)
    W = 5
    h = rng.randn(W, 1, cfg.d_model).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 0.9, 0.0, 1.5], np.float32)
    topks = np.asarray([0, 0, 4, 0, 2], np.int32)
    seeds = np.asarray([0, 2 ** 32 - 1, 3, 0, 2 ** 31], np.uint32)
    tindex = np.asarray([0, 4, 1, 0, 9], np.int32)
    r_toks, r_logits = r_sampling.make_round_tail(cfg)(
        params["embed"], jnp.asarray(h), jnp.asarray(temps),
        jnp.asarray(topks), jnp.asarray(seeds), jnp.asarray(tindex))
    t_toks, t_logits = TS.make_round_tail(tcfg)(
        tparams["embed"], torch.as_tensor(h), temps, topks,
        seeds.astype(np.int64), tindex)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(r_toks))


def test_sampling_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        TS.SamplingSpec(kind="beam")
    with pytest.raises(ValueError, match="temperature"):
        TS.SamplingSpec(kind="temperature", temperature=0.0)
    with pytest.raises(ValueError, match="top_k"):
        TS.SamplingSpec(kind="top_k", top_k=0)
    with pytest.raises(ValueError, match="seed"):
        TS.SamplingSpec(kind="temperature", seed=2 ** 32)


# ---------------------------------------------------------------------------
# Engine streams
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def model(arch="llama3_2_1b"):
    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, tcfg, from_reference(
        jax.tree.map(np.asarray, params), "cpu")


def _problem(C, cfg, max_new, n_servers=2):
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=1000.0, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3,
                     workload=C.Workload(4, max_new))


def _system(S, decode_mode, max_new=6, layout="slab"):
    cfg, params, tcfg, tparams = model()
    kw = dict(algorithm="proposed", R=2, max_new_tokens=max_new,
              max_sessions=4, decode_mode=decode_mode, cache_layout=layout,
              page_size=2 if layout == "paged" else None)
    if S is RS:
        return RS.GeoServingSystem(cfg, params, _problem(RC, cfg, max_new),
                                   **kw)
    return TS.GeoServingSystem(tcfg, tparams, _problem(TC, tcfg, max_new),
                               device="cpu", **kw)


def _serve(S, system, prompts, specs, n_new, grouped=True):
    """Admit as one batch (or one by one) and decode to completion.
    Returns (token lists, virtual times)."""
    C = RC if S is RS else TC
    sids = []
    for p, sp in zip(prompts, specs):
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids.append(system.create_session(p, 0, route, n_new, sampling=sp))
    out = {}
    batches = [sids] if grouped else [[s] for s in sids]
    for batch in batches:
        assert system.try_admit_sessions(batch) == batch
        system.drain_prefill()
        while any(system.sessions[s].n_generated < n_new for s in batch):
            system.decode_round([s for s in batch
                                 if system.sessions[s].n_generated < n_new])
        for s in batch:
            out[s] = (list(system.sessions[s].tokens),
                      float(system.sessions[s].virtual_time))
            system.retire_session(s)
    return [out[s][0] for s in sids], [out[s][1] for s in sids]


def _specs(S):
    # the reduced model's logits are peaked (top gaps ~6 at std ~7):
    # temperatures of a few units make the draws leave the argmax
    return [S.SamplingSpec("temperature", temperature=3.0, seed=3),
            S.SamplingSpec("top_k", temperature=4.0, top_k=3, seed=11),
            S.SamplingSpec(),
            S.SamplingSpec("top_k", temperature=2.5, top_k=12,
                           seed=2 ** 31 + 13)]


PROMPTS = [np.random.RandomState(8).randint(2, 64, n) for n in (4, 6, 5, 4)]


@pytest.mark.parametrize("decode_mode", ["fused", "serial"])
@pytest.mark.parametrize("grouped", [True, False])
def test_engine_sampled_streams_match_reference(decode_mode, grouped):
    """Seeded temperature / top-k sessions beside a greedy one: the port
    draws the reference's streams with the same clocks, fused or serial,
    grouped or solo."""
    outs, stats = [], []
    for S in (RS, TS):
        system = _system(S, decode_mode)
        outs.append(_serve(S, system, PROMPTS, _specs(S), n_new=6,
                           grouped=grouped))
        stats.append(system.round_stats)
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]


def test_port_sampled_streams_invariant():
    """Within the port: fused == serial, solo == grouped, slab == paged,
    and a greedy session's stream is the all-greedy run's."""
    runs = {}
    for mode in ("fused", "serial"):
        for layout in ("slab", "paged"):
            for grouped in (True, False):
                runs[mode, layout, grouped] = _serve(
                    TS, _system(TS, mode, layout=layout), PROMPTS,
                    _specs(TS), n_new=6, grouped=grouped)[0]
    first = runs["fused", "slab", True]
    assert all(r == first for r in runs.values())
    greedy = _serve(TS, _system(TS, "fused"), PROMPTS,
                    [TS.SamplingSpec()] * len(PROMPTS), n_new=6)[0]
    assert first[2] == greedy[2]
    # the sampled sessions really sampled
    assert any(first[i] != greedy[i] for i in (0, 1, 3))
