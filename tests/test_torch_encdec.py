"""The port's encoder-decoder stack (SeamlessM4T-large-v2, reduced, f32)
against the JAX reference on the CPU, with weights bridged from
``init_params(PRNGKey(0), cfg)`` and inputs drawn with numpy from a seed.

* the modules: ``embed_frames``, ``gqa_encoder_kv``, ``encoder_block_full``,
  ``cross_decoder_block_full`` (whole, and in chunks over a cached prefix
  with the cross K/V reused), ``cross_decoder_block_decode`` with per-row
  encoder lengths shorter than the cross cache — each against the
  reference's plain (XLA) path and its Pallas kernels in interpret mode;
* the monolithic ``prefill``/``decode_step`` with frames;
* the weight bridge leaf by leaf, the port's own init tree, and the
  serving state specs and pool trees;
* the engine against the reference's (tests/test_family_pools.py and
  tests/test_round_fusion.py scenarios): against the monolithic streams,
  solo vs grouped bit for bit, groups keyed by encoder length, encoder
  hops billed once, through the scheduler (slab and paged, fused and
  serial), failover mid-stream, fused == serial rounds, paged == slab,
  and paged preemption with resume.

Tolerances: logits and activations at rtol 2e-4 / atol 1e-5 (the
reference's own between two compiled programs); streams, virtual clocks,
admissions, prefill groups and ``round_stats`` exact.
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
from repro.models import attention as RA
from repro.models import blocks as RB
from repro.models import decode_step as r_decode_step
from repro.models import init_params
from repro.models import prefill as r_prefill
from repro.models.layers import embed_frames as r_embed_frames
from repro_torch import serving as TS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_params as t_init_params
from repro_torch.models import prefill as t_prefill
from repro_torch.models.layers import embed_frames as t_embed_frames
from repro_torch.models.model import layer_params
from repro_torch.sim.workload import poisson_requests
from repro_torch.weights import from_reference, to_numpy

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)

ARCH = "seamless_m4t_large_v2"
TOL = dict(rtol=2e-4, atol=1e-5)
RECORD_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped", "n_deferrals",
                 "n_replays", "n_detections", "replay_time", "detect_time")


@functools.lru_cache(maxsize=None)
def model():
    cfg = get_reduced_config(ARCH)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, t_get_reduced_config(ARCH), from_reference(
        jax.tree.map(np.asarray, params), "cpu")


def T(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def frames_for(cfg, rng, n):
    return rng.randn(n, cfg.frame_dim).astype(np.float32)


def seg_layer(params, seg, i):
    """Layer ``i`` of the reference's stacked segment ``seg``."""
    return jax.tree.map(lambda x: x[i], params["segments"][seg])


# ---------------------------------------------------------------------------
# Config and modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(reduced):
    """The port's copy of the seamless config: every field, the enc-dec
    flags and the enc-dec branch of ``param_count`` equal the
    reference's."""
    import dataclasses

    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config

    cfg = (get_reduced_config if reduced else get_config)(ARCH)
    tcfg = (t_get_reduced_config if reduced else t_get_config)(ARCH)
    ref, port = dataclasses.asdict(cfg), dataclasses.asdict(tcfg)
    assert ref == {k: port[k] for k in ref}
    # the port's own options (DeepSeek-V2's published ones) stay off
    defaults = {f.name: f.default for f in dataclasses.fields(tcfg)}
    assert {k: v for k, v in port.items() if k not in ref} == \
        {k: defaults[k] for k in port if k not in ref}
    assert tcfg.is_enc_dec and tcfg.frame_dim == cfg.frame_dim
    assert tcfg.param_count() == cfg.param_count()
    if not reduced:
        assert round(tcfg.param_count() / 1e9, 2) == 1.63


def test_layernorm_and_gelu_mlp():
    """The LayerNorm + GELU MLP branch of the seamless blocks."""
    from repro.models.layers import apply_mlp as r_apply_mlp
    from repro.models.layers import apply_norm as r_apply_norm
    from repro_torch.models.layers import apply_mlp, apply_norm

    cfg, params, tcfg, tparams = model()
    x = np.random.RandomState(7).randn(2, 5, cfg.d_model).astype(
        np.float32) * 3.0
    for seg in ("enc", "dec"):
        p, tp = seg_layer(params, seg, 1), layer_params(
            tparams["segments"][seg], 1)
        assert set(tp["ffn"]) == {"wi", "wo"}
        close(apply_norm(tp["ln2"], tcfg, T(x)),
              r_apply_norm(p["ln2"], cfg, jnp.asarray(x)))
        close(apply_mlp(tp["ffn"], tcfg, T(x)),
              r_apply_mlp(p["ffn"], cfg, NULL_SH, jnp.asarray(x)))


def test_embed_frames_and_encoder_kv():
    cfg, params, tcfg, tparams = model()
    rng = np.random.RandomState(0)
    fr = rng.randn(2, 7, cfg.frame_dim).astype(np.float32)
    want = r_embed_frames(params["embed"], cfg, NULL_SH, jnp.asarray(fr))
    got = t_embed_frames(tparams["embed"], tcfg, T(fr))
    assert got.dtype == torch.float32 and got.shape == (2, 7, cfg.d_model)
    close(got, want)
    p = seg_layer(params, "dec", 1)["cross_attn"]
    tp = layer_params(tparams["segments"]["dec"], 1)["cross_attn"]
    h = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    rk, rv = RA.gqa_encoder_kv(p, cfg, NULL_SH, jnp.asarray(h))
    tk, tv = TA.gqa_encoder_kv(tp, tcfg, T(h))
    close(tk, rk)
    close(tv, rv)


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("S", [1, 5, 13])
def test_encoder_block_full(S, ref_backend):
    """Bidirectional encoder block (non-causal K2 in the reference's
    Pallas interpret mode, or its plain path)."""
    cfg, params, tcfg, tparams = model()
    h = np.random.RandomState(S).randn(2, S, cfg.d_model).astype(np.float32)
    for i in range(cfg.n_enc_layers):
        want = RB.encoder_block_full(seg_layer(params, "enc", i), cfg,
                                     NULL_SH, jnp.asarray(h), jnp.arange(S),
                                     backend=ref_backend)
        got = TB.encoder_block_full(
            layer_params(tparams["segments"]["enc"], i), tcfg, T(h),
            torch.arange(S))
        close(got, want)


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
def test_cross_decoder_block_full_chunks(ref_backend):
    """Whole prompt, and the same prompt in two chunks over the cached
    self-K/V prefix with the cross K/V passed back in (``enc_kv``): the
    port equals the reference in both, and the chunks equal the whole."""
    cfg, params, tcfg, tparams = model()
    rng = np.random.RandomState(3)
    S, S_enc, P = 9, 6, 5
    h = rng.randn(2, S, cfg.d_model).astype(np.float32)
    enc = rng.randn(2, S_enc, cfg.d_model).astype(np.float32)
    p = seg_layer(params, "dec", 0)
    tp = layer_params(tparams["segments"]["dec"], 0)
    rh, rc = RB.cross_decoder_block_full(p, cfg, NULL_SH, jnp.asarray(h),
                                         jnp.arange(S), jnp.asarray(enc),
                                         backend=ref_backend)
    th, tc = TB.cross_decoder_block_full(tp, tcfg, T(h), torch.arange(S),
                                         T(enc))
    close(th, rh)
    for key in ("k", "v", "ck", "cv"):
        close(tc[key], rc[key])
    # chunk 1 at offset 0, chunk 2 at offset P over the cached prefix
    th1, tc1 = TB.cross_decoder_block_full(tp, tcfg, T(h[:, :P]),
                                           torch.arange(P), T(enc))
    rh2, rc2 = RB.cross_decoder_block_full(
        p, cfg, NULL_SH, jnp.asarray(h[:, P:]), P + jnp.arange(S - P),
        jnp.asarray(enc), prefix_kv=(rc["k"][:, :P], rc["v"][:, :P]),
        enc_kv=(rc["ck"], rc["cv"]), backend=ref_backend)
    th2, tc2 = TB.cross_decoder_block_full(
        tp, tcfg, T(h[:, P:]), P + torch.arange(S - P), T(enc),
        prefix_kv=(tc1["k"], tc1["v"]), enc_kv=(tc1["ck"], tc1["cv"]))
    close(th2, rh2)
    close(torch.cat([th1, th2], 1), rh)
    close(tc2["k"], rc["k"][:, P:])
    assert tc2["ck"] is tc1["ck"]  # reused, not projected again


@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
def test_cross_decoder_block_decode_enc_len(ref_backend):
    """One decode token per row over a cross cache longer than each row's
    encoder output: positions at or past ``enc_len`` (filled with garbage
    here) must not count; the self-K/V write lands at ``pos`` and the cross
    cache is returned unchanged."""
    cfg, params, tcfg, tparams = model()
    rng = np.random.RandomState(4)
    Tc, Te = 12, 10
    k = rng.randn(2, Tc, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    v = rng.randn(*k.shape).astype(np.float32)
    ck = rng.randn(2, Te, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    cv = rng.randn(*ck.shape).astype(np.float32)
    x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    pos, enc_len = [7, 3], [5, 9]
    p = seg_layer(params, "dec", 1)
    tp = layer_params(tparams["segments"]["dec"], 1)
    cache = {name: T(a).clone() for name, a in
             (("k", k), ("v", v), ("ck", ck), ("cv", cv))}
    th, tc = TB.cross_decoder_block_decode(tp, tcfg, T(x), cache,
                                           torch.tensor(pos),
                                           enc_len=torch.tensor(enc_len))
    for b in range(2):
        rc = {"k": jnp.asarray(k[b:b + 1]), "v": jnp.asarray(v[b:b + 1]),
              "ck": jnp.asarray(ck[b:b + 1]), "cv": jnp.asarray(cv[b:b + 1])}
        rh, rc2 = RB.cross_decoder_block_decode(
            p, cfg, NULL_SH, jnp.asarray(x[b:b + 1]), rc, pos[b],
            enc_len=enc_len[b], backend=ref_backend)
        close(th[b:b + 1], rh)
        close(tc["k"][b:b + 1], rc2["k"])
        # garbage past enc_len is masked out: changing it changes nothing
        ck2 = ck.copy()
        ck2[b, enc_len[b]:] = 1e3
        rh3, _ = RB.cross_decoder_block_decode(
            p, cfg, NULL_SH, jnp.asarray(x[b:b + 1]),
            dict(rc, ck=jnp.asarray(ck2[b:b + 1])), pos[b],
            enc_len=enc_len[b], backend=ref_backend)
        np.testing.assert_array_equal(np.asarray(rh3), np.asarray(rh))
    assert torch.equal(tc["ck"], T(ck)) and tc["ck"] is cache["ck"]


def test_decode_attention_plain_kv_len_and_noncausal_core():
    """The plain helpers the port's models take on the CPU: non-causal
    decode masked by a per-row kv_len, and non-causal prefill attention
    (dense and chunked) against the reference's."""
    rng = np.random.RandomState(6)
    q = rng.randn(3, 1, 4, 16).astype(np.float32)
    ck = rng.randn(3, 20, 2, 16).astype(np.float32)
    cv = rng.randn(3, 20, 2, 16).astype(np.float32)
    kv_len = [20, 7, 1]
    got = TA.decode_attention_plain(T(q), T(ck), T(cv), torch.zeros(3),
                                    causal=False, kv_len=torch.tensor(kv_len))
    for b in range(3):
        want = RA.decode_attention_xla(
            jnp.asarray(q[b:b + 1]), jnp.asarray(ck[b:b + 1]),
            jnp.asarray(cv[b:b + 1]), 0, causal=False, kv_len=kv_len[b])
        close(got[b:b + 1], want)
    for S, Tk in ((5, 9), (3000, 40)):  # dense, then the chunked path
        qq = rng.randn(1, S, 2, 8).astype(np.float32)
        kk = rng.randn(1, Tk, 2, 8).astype(np.float32)
        vv = rng.randn(1, Tk, 2, 8).astype(np.float32)
        want = RA.attention_core(jnp.asarray(qq), jnp.asarray(kk),
                                 jnp.asarray(vv), jnp.arange(S),
                                 jnp.arange(Tk), causal=False)
        got = TA.attention_core(T(qq), T(kk), T(vv), torch.arange(S),
                                torch.arange(Tk), causal=False)
        close(got, want)


# ---------------------------------------------------------------------------
# Monolithic prefill / decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_enc", [1, 6, 11])
def test_prefill_and_decode_steps(S_enc):
    """Frames + prompt, then 5 greedy decode steps: logits and caches
    within tolerance at every step, identical greedy tokens."""
    cfg, params, tcfg, tparams = model()
    rng = np.random.RandomState(10 + S_enc)
    toks = rng.randint(2, cfg.vocab_size, (2, 7))
    fr = rng.randn(2, S_enc, cfg.frame_dim).astype(np.float32)
    cache_len = 7 + 6
    rl, rc = r_prefill(params, cfg, NULL_SH,
                       {"tokens": jnp.asarray(toks),
                        "frames": jnp.asarray(fr)}, cache_len=cache_len)
    tl, tc = t_prefill(tparams, tcfg, {"tokens": T(toks), "frames": T(fr)},
                       cache_len=cache_len)
    close(tl, rl)
    assert set(tc) == set(rc) == {"dec"}
    for key in ("k", "v", "ck", "cv"):
        assert tuple(tc["dec"][key].shape) == rc["dec"][key].shape, key
        close(tc["dec"][key], rc["dec"][key])
    nxt = np.asarray(jnp.argmax(rl, -1))
    for i in range(5):
        rl, rc = r_decode_step(params, cfg, NULL_SH, rc, jnp.asarray(nxt),
                               7 + i)
        tl, tc = t_decode_step(tparams, tcfg, tc, T(nxt), 7 + i)
        close(tl, rl)
        nxt = np.asarray(jnp.argmax(rl, -1))
        assert (tl.argmax(-1).numpy() == nxt).all()


def test_init_decode_caches_encdec():
    from repro.models import init_decode_caches as r_init
    from repro_torch.models import init_decode_caches as t_init

    cfg, _, tcfg, _ = model()
    for enc_len in (None, 5):
        want = r_init(cfg, 3, 12, enc_len)
        got = t_init(tcfg, 3, 12, enc_len, device="cpu")
        assert set(got) == set(want) == {"dec"}
        assert {k: tuple(v.shape) for k, v in got["dec"].items()} == \
            {k: v.shape for k, v in want["dec"].items()}


# ---------------------------------------------------------------------------
# Weights, init tree, state specs and pool trees
# ---------------------------------------------------------------------------


def _flat(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_encdec_trees_leaf_by_leaf(dtype):
    """``from_reference`` carries the enc/dec segment trees (frame_proj,
    ln_cross, cross_attn, ...) across bit for bit, and the port's own
    init draws the same tree, shapes and dtypes."""
    cfg = get_reduced_config(ARCH).replace(param_dtype=dtype)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    np_tree = jax.tree.map(np.asarray, params)
    ported = from_reference(np_tree, "cpu")
    ref, got = _flat(np_tree), _flat(to_numpy(ported))
    assert ref.keys() == got.keys()
    for name in ("['embed']['frame_proj']",
                 "['segments']['dec']['ln_cross']['scale']",
                 "['segments']['dec']['cross_attn']['wq']",
                 "['segments']['enc']['attn']['wo']"):
        assert name in ref
    for path, r in ref.items():
        want = r.view(np.uint16) if r.dtype.name == "bfloat16" else r
        np.testing.assert_array_equal(got[path], want, err_msg=path)
    tcfg = t_get_reduced_config(ARCH).replace(param_dtype=dtype)
    own = _flat(jax.tree.map(lambda t: to_numpy(t),
                             t_init_params(tcfg, torch.Generator()
                                           .manual_seed(0), "cpu")))
    assert own.keys() == ref.keys()
    for path, r in ref.items():
        assert own[path].shape == r.shape, path


def test_state_specs_block_kinds_and_pool_trees():
    from repro.models import stack_block_kinds as r_kinds
    from repro.serving import new_block_cache as r_new_block_cache
    from repro.serving import new_state_pool_tree as r_new_pool

    cfg, _, tcfg, _ = model()
    assert TB.stack_block_kinds(tcfg) == r_kinds(cfg) == \
        ("enc", "enc", "dec", "dec")
    assert [(s.kind, s.recurrent, s.needs_emb0, s.cross, s.decode_active)
            for s in TS.state_specs(tcfg)] == \
        [(s.kind, s.recurrent, s.needs_emb0, s.cross, s.decode_active)
         for s in RS.state_specs(cfg)]
    for kind in ("enc", "dec"):
        got = TS.new_block_cache(tcfg, kind, 2, 9, enc_len=5, device="cpu")
        want = r_new_block_cache(cfg, kind, 2, 9, enc_len=5)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        got = TS.new_state_pool_tree(tcfg, kind, 2, 3, 8, enc_len=6,
                                     device="cpu")
        want = r_new_pool(cfg, kind, 2, 3, 8, enc_len=6)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    paged = TS.new_paged_pool_tree(tcfg, "dec", 2, 3, 4, 5, enc_len=6,
                                   device="cpu")
    assert tuple(paged["k"].shape) == (2, 5, 4, 4, 16)  # pages
    assert tuple(paged["ck"].shape) == (2, 3, 6, 4, 16)  # row-resident
    assert TS.bucket_for((8, 16), 5, TS.state_specs(tcfg)) == 8


# ---------------------------------------------------------------------------
# The engine against the reference
# ---------------------------------------------------------------------------


def problem(C, cfg, n_servers=3, mem=1000.0, wl=(4, 8)):
    """tests/test_family_pools.py's cluster."""
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=mem, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, rtt * 3, workload=C.Workload(*wl))


def engines(problem_kw=None, **kw):
    """(reference system, port system) over the same problem."""
    cfg, params, tcfg, tparams = model()
    pkw = problem_kw or {}
    ref = RS.GeoServingSystem(cfg, params, problem(RC, cfg, **pkw), **kw)
    port = TS.GeoServingSystem(tcfg, tparams, problem(TC, tcfg, **pkw),
                               device="cpu", **kw)
    return ref, port


def _monolithic(toks, frames, n_new):
    cfg, params, _, _ = model()
    logits, caches = r_prefill(params, cfg, NULL_SH,
                               {"tokens": jnp.asarray(toks)[None],
                                "frames": jnp.asarray(frames)[None]},
                               cache_len=len(toks) + n_new + 4)
    seq = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        lg, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), len(toks) + i)
        seq.append(int(jnp.argmax(lg[0])))
    return seq


def _jobs(lengths, enc_lens, seed=0):
    cfg = model()[0]
    rng = np.random.RandomState(seed)
    return [(rng.randint(2, cfg.vocab_size, n), frames_for(cfg, rng, e))
            for n, e in zip(lengths, enc_lens)]


def _create(system, jobs, n_new, C):
    sids = []
    for prompt, frames in jobs:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids.append(system.create_session(prompt, 0, route, n_new,
                                          frames=frames))
    return sids


def _route(r):
    return tuple(map(int, r.servers)), tuple(map(int, r.blocks))


def _logits(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _serve_rounds(system, jobs, n_new, C, coalesce=True):
    """Admit (as one batch, or one by one), decode to ``n_new`` tokens;
    returns (token lists, per-step logits, virtual times)."""
    sids = _create(system, jobs, n_new, C)
    hist = {}
    for batch in ([sids] if coalesce else [[s] for s in sids]):
        assert system.try_admit_sessions(batch) == batch
        system.drain_prefill()
        for sid in batch:
            hist[sid] = [_logits(system.sessions[sid].last_logits)]
        while True:
            todo = [s for s in batch
                    if system.sessions[s].n_generated < n_new]
            if not todo:
                break
            system.decode_round(todo)
            for sid in todo:
                hist[sid].append(_logits(system.sessions[sid].last_logits))
    toks = [list(system.sessions[s].tokens) for s in sids]
    vts = [float(system.sessions[s].virtual_time) for s in sids]
    for sid in sids:
        system.retire_session(sid)
    return toks, [hist[s] for s in sids], vts


def test_engine_matches_monolithic():
    """tests/test_family_pools.py::test_engine_matches_monolithic: submit +
    decode against the reference's monolithic prefill/decode_step and the
    reference engine — logits within tolerance, identical tokens and
    clocks."""
    cfg, params, _, _ = model()
    ref, port = engines(R=2, max_new_tokens=8, max_sessions=8)
    rng = np.random.RandomState(0)
    toks = rng.randint(2, cfg.vocab_size, 6)
    frames = frames_for(cfg, rng, 5)
    sid, logits = port.submit(toks, frames=frames)
    rsid, r_logits = ref.submit(toks, frames=frames)
    rl, caches = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)[None],
                            "frames": jnp.asarray(frames)[None]},
                           cache_len=len(toks) + 9)
    for want in (rl, r_logits):
        close(logits[0], want[0])
    assert port.sessions[sid].enc_out.shape == (1, 5, cfg.d_model)
    seq = [int(jnp.argmax(rl[0]))]
    for i in range(4):
        rl, caches = r_decode_step(params, cfg, NULL_SH, caches,
                                   jnp.asarray([seq[-1]]), len(toks) + i)
        lg = port.decode(sid, seq[-1])
        r_lg = ref.decode(rsid, seq[-1])
        for want in (rl, r_lg):
            close(lg[0], want[0])
        seq.append(int(jnp.argmax(rl[0])))
        assert int(torch.argmax(lg[0])) == seq[-1]
    assert seq == _monolithic(toks, frames, 5)
    assert port.sessions[sid].virtual_time == ref.sessions[rsid].virtual_time
    port.finish(sid)


@pytest.mark.parametrize("decode_mode", ["fused", "serial"])
def test_solo_vs_grouped_bit_exact(decode_mode):
    """A session's logits are bit-identical alone or among neighbours of
    other prompt lengths (equal encoder lengths: one group), and its tokens
    and clock equal the reference engine's."""
    jobs = _jobs((4, 6, 4), (5, 5, 5), seed=1)
    kw = dict(R=2, max_new_tokens=8, decode_mode=decode_mode)
    _, solo_sys = engines(**kw)
    ref, grp_sys = engines(**kw)
    solo = _serve_rounds(solo_sys, jobs, 4, TC, coalesce=False)
    grouped = _serve_rounds(grp_sys, jobs, 4, TC, coalesce=True)
    want = _serve_rounds(ref, jobs, 4, RC, coalesce=True)
    assert solo[0] == grouped[0] == want[0]
    assert grouped[2] == want[2]
    for ls, lg, lr in zip(solo[1], grouped[1], want[1]):
        assert len(ls) == len(lg) == 4
        for a, b, c in zip(ls, lg, lr):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(b, c, **TOL)


def test_mixed_enc_lengths_group_separately():
    """Groups are keyed by (route, bucket, encoder length) exactly as the
    reference's; each stream equals its monolithic reference."""
    ref, port = engines(R=2, max_new_tokens=8)
    jobs = _jobs((5, 6, 4), (4, 9, 4), seed=3)
    keys = []
    for system, C in ((ref, RC), (port, TC)):
        sids = _create(system, jobs, 4, C)
        assert system.try_admit_sessions(sids) == sids
        keys.append({(g.bucket, g.enc_len, tuple(s.sid for s in g.members))
                     for g in system._prefill_groups})
        system.drain_prefill()
        while any(system.sessions[s].n_generated < 4 for s in sids):
            system.decode_round()
        if system is port:
            for sid, (p, f) in zip(sids, jobs):
                assert system.sessions[sid].tokens[len(p):] == \
                    _monolithic(p, f, 4)
    assert keys[0] == keys[1] == {(8, 4, (0, 2)), (8, 9, (1,))}
    assert ref.round_stats == port.round_stats


@pytest.mark.parametrize("prefill_mode", ["batched", "serial"])
def test_chunked_billing_counts_enc_hops_once(prefill_mode):
    """tests/test_family_pools.py: a chunked prompt pays per-chunk protocol
    cost only on hops it traverses — the encoder-only first hop once, the
    decoder hops once per chunk (batched); the port's clock and stream
    equal the reference's."""
    cfg = model()[0]
    kw = dict(R=2, max_new_tokens=4, prefill_buckets=(4,), max_seq_len=16,
              prefill_mode=prefill_mode)
    ref, port = engines(problem_kw=dict(mem=250.0, wl=(4, 4)), **kw)
    rng = np.random.RandomState(9)
    toks = rng.randint(2, cfg.vocab_size, 7)  # chunks (0,4,4), (4,3,4)
    frames = frames_for(cfg, rng, 5)
    sid, logits = port.submit(toks, frames=frames)
    rsid, r_logits = ref.submit(toks, frames=frames)
    close(logits[0], r_logits[0])
    sess, rsess = port.sessions[sid], ref.sessions[rsid]
    assert _route(sess.route) == _route(rsess.route)
    assert sess.route.blocks[0] <= cfg.n_enc_layers, "encoder-only hop"
    assert sess.prefill_time == rsess.prefill_time
    if prefill_mode == "batched":
        expected, n_enc, prob = 0.0, cfg.n_enc_layers, port.problem
        for off, span, _ in [(0, 4, 4), (4, 3, 4)]:
            e = 0
            for j, k in zip(sess.route.servers, sess.route.blocks):
                if max(e, n_enc) < e + k or off == 0:
                    expected += (prob.rtt_prefill[0, j]
                                 + k * prob.servers[j].tau_prefill(span))
                e += k
        np.testing.assert_allclose(sess.prefill_time, expected, rtol=1e-12)
    seq = [int(torch.argmax(logits[0]))]
    for _ in range(3):
        lg = port.decode(sid, seq[-1])
        close(lg[0], ref.decode(rsid, seq[-1])[0])
        seq.append(int(torch.argmax(lg[0])))
    assert seq == _monolithic(toks, frames, 4)
    assert sess.virtual_time == rsess.virtual_time
    port.finish(sid)


def _requests(n, rate, seed, enc_lens=(6, 9)):
    cfg = model()[0]
    rng = np.random.RandomState(seed)
    return [(r.rid, rng.randint(2, cfg.vocab_size, 4 + r.rid % 3),
             r.arrival, frames_for(cfg, rng, enc_lens[r.rid % len(enc_lens)]))
            for r in poisson_requests(n, rate=rate, seed=seed + 1)]


def _schedule(system, sched_cls, reqs, R, n_new):
    sched = sched_cls(system, R=R)
    for rid, toks, arrival, frames in reqs:
        sched.submit(rid, toks, arrival, n_new=n_new, frames=frames)
    return sched.run(), sched


@pytest.mark.parametrize("layout,decode_mode,prefill_mode", [
    ("slab", "fused", "batched"), ("slab", "serial", "batched"),
    ("slab", "fused", "serial"), ("paged", "fused", "batched"),
    ("paged", "serial", "serial")])
def test_scheduler_identical_to_reference(layout, decode_mode,
                                          prefill_mode):
    """Poisson requests with two encoder lengths through the scheduler on
    a cluster where the stack splits over servers: tokens, clocks,
    admissions and round_stats identical; streams equal the monolithic
    ones; the pools drain."""
    kw = dict(R=2, max_new_tokens=5, max_sessions=8, cache_layout=layout,
              decode_mode=decode_mode, prefill_mode=prefill_mode,
              max_seq_len=40, page_size=2 if layout == "paged" else None)
    ref, port = engines(problem_kw=dict(n_servers=4, mem=420.0), **kw)
    assert list(ref.placement.a) == list(port.placement.a)
    assert list(ref.placement.m) == list(port.placement.m)
    assert max(port.placement.m) < model()[0].n_layers  # a split stack
    reqs = _requests(5, rate=4.0, seed=2)
    r_out, r_sched = _schedule(ref, RS.ContinuousBatchingScheduler, reqs, 2,
                               5)
    p_out, p_sched = _schedule(port, TS.ContinuousBatchingScheduler, reqs,
                               2, 5)
    assert len(p_out) == len(reqs) and not any(o.dropped for o in p_out)
    for a, b in zip(r_out, p_out):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert ref.round_stats == port.round_stats
    assert r_sched.max_concurrency == p_sched.max_concurrency > 1
    assert port.slot_usage() == ref.slot_usage()
    assert all(used == 0 for used, _ in port.slot_usage().values())
    for (_, toks, _, frames), out in list(zip(reqs, p_out))[:2]:
        assert list(out.tokens[len(toks):]) == _monolithic(toks, frames, 5)


@pytest.mark.parametrize("decode_mode,prefill_mode", [
    ("fused", "batched"), ("serial", "batched"), ("fused", "serial")])
def test_failover_mid_stream(decode_mode, prefill_mode):
    """tests/test_family_pools.py::test_failover_mid_stream_exact: kill a
    route server while two sessions are co-resident mid-stream — both
    streams continue as the no-failure run's, and route, clocks and
    round_stats equal the reference engine's under the same drill."""
    kw = dict(R=2, max_new_tokens=8, decode_mode=decode_mode,
              prefill_mode=prefill_mode)
    pkw = dict(n_servers=4)
    jobs = _jobs((5, 5), (5, 5), seed=4)
    _, clean = engines(problem_kw=pkw, **kw)
    want, _, _ = _serve_rounds(clean, jobs, 6, TC)
    ref, port = engines(problem_kw=pkw, **kw)
    out = []
    for system, C in ((ref, RC), (port, TC)):
        sids = _create(system, jobs, 6, C)
        assert system.try_admit_sessions(sids) == sids
        system.drain_prefill()
        system.decode_round(sids)
        system.decode_round(sids)
        victim = system.sessions[sids[0]].route.servers[0]
        system.kill_server(victim)
        while any(system.sessions[s].n_generated < 6 for s in sids):
            system.decode_round(
                [s for s in sids if system.sessions[s].n_generated < 6])
        sess = [system.sessions[s] for s in sids]
        assert all(victim not in s.route.servers for s in sess)
        out.append([(list(s.tokens), _route(s.route), s.virtual_time,
                     s.n_replays) for s in sess])
    assert out[0] == out[1]
    assert [t for t, _, _, _ in out[1]] == want
    assert ref.round_stats == port.round_stats
    assert port.round_stats["replays"] > 0


def test_failover_of_encoder_hop_replays_encoder():
    """A route whose first hop holds only encoder blocks: killing it makes
    no decode round fail over (encoder hops do no decode work); a later
    kill of a decoder hop replays through the new chain with the {"enc",
    "dec"} prompt records — streams, routes and clocks equal the
    reference's."""
    kw = dict(R=2, max_new_tokens=8)
    pkw = dict(n_servers=4, mem=250.0)
    jobs = _jobs((5,), (6,), seed=8)
    out = []
    for system, C in zip(engines(problem_kw=pkw, **kw), (RC, TC)):
        sid = _create(system, jobs, 6, C)[0]
        assert system.try_admit_sessions([sid]) == [sid]
        system.drain_prefill()
        sess = system.sessions[sid]
        assert sess.route.blocks[0] <= 2  # encoder-only first hop
        system.decode_round([sid])
        system.kill_server(sess.route.servers[0])
        system.decode_round([sid])
        replays_after_enc_kill = system.round_stats["replays"]
        system.kill_server(sess.route.servers[-1])
        while sess.n_generated < 6:
            system.decode_round([sid])
        out.append((list(sess.tokens), _route(sess.route), sess.virtual_time,
                    replays_after_enc_kill, dict(system.round_stats)))
    assert out[0] == out[1]
    assert out[1][3] == 0 and out[1][4]["replays"] == 1
    assert out[1][0][5:] == _monolithic(*jobs[0], 6)


def test_fused_matches_serial_rounds():
    """tests/test_round_fusion.py::test_fused_matches_serial_reference on
    the enc-dec scenario: tokens and clocks identical between fused and
    serial rounds, logits to float-ulp."""
    jobs = _jobs((4, 6, 5), (5, 8, 5))
    res = {}
    for mode in ("fused", "serial"):
        _, port = engines(problem_kw=dict(n_servers=2), R=2,
                          max_new_tokens=4, max_sessions=4, decode_mode=mode)
        res[mode] = _serve_rounds(port, jobs, 4, TC)
    assert res["fused"][0] == res["serial"][0]
    assert res["fused"][2] == res["serial"][2]
    for hf, hs in zip(res["fused"][1], res["serial"][1]):
        for a, b in zip(hf, hs):
            np.testing.assert_allclose(a, b, atol=5e-6, rtol=1e-4)


@pytest.mark.parametrize("mode", ["fused", "serial"])
def test_paged_matches_slab(mode):
    """tests/test_round_fusion.py::test_paged_matches_slab on the enc-dec
    scenario: paged (page size 2; cross K/V row-resident) equals slab bit
    for bit, grouped and solo; both equal the reference's paged engine."""
    jobs = _jobs((4, 6, 5), (5, 8, 5))
    res = {}
    for layout in ("slab", "paged"):
        ref, port = engines(problem_kw=dict(n_servers=2), R=2,
                            max_new_tokens=4, max_sessions=4,
                            decode_mode=mode, cache_layout=layout,
                            page_size=2)
        grouped = _serve_rounds(port, jobs, 4, TC)
        solo = [_serve_rounds(port, [job], 4, TC) for job in jobs]
        res[layout] = (grouped, solo)
        want = _serve_rounds(ref, jobs, 4, RC)
        assert grouped[0] == want[0] and grouped[2] == want[2]
    (toks_s, hist_s, vt_s), solo_s = res["slab"]
    (toks_p, hist_p, vt_p), solo_p = res["paged"]
    assert toks_p == toks_s and vt_p == vt_s
    for hp, hs in zip(hist_p, hist_s):
        for a, b in zip(hp, hs):
            np.testing.assert_array_equal(a, b)
    for (tp, _, vp), (ts, _, vs) in zip(solo_p, solo_s):
        assert tp == ts and vp == vs


def test_paged_preemption_resume_matches_reference():
    """Page pressure on enc-dec sessions: the engine preempts, resumes by
    replaying the {"enc", "dec"} records (cross K/V rebuilt from
    ``enc_out``), and the streams, clocks and round_stats equal the
    reference's; the streams equal an uncontended run's."""
    n_new = 30
    kw = dict(R=2, max_new_tokens=n_new, max_sessions=8,
              cache_layout="paged", page_size=2)
    jobs = _jobs((4,) * 6, (5, 7) * 3, seed=11)

    def run(system, C):
        sids = _create(system, jobs, n_new, C)
        assert system.try_admit_sessions(sids) == sids
        system.drain_prefill()
        for _ in range(3000):
            if all(system.sessions[s].n_generated >= n_new for s in sids):
                break
            system.decode_round()
        sess = [system.sessions[s] for s in sids]
        return ([list(s.tokens) for s in sess],
                [(s.virtual_time, s.n_preemptions, s.replay_time)
                 for s in sess], dict(system.round_stats))

    out = [run(system, C) for system, C in zip(
        engines(problem_kw=dict(n_servers=4, mem=200.0, wl=(4, n_new)),
                **kw), (RC, TC))]
    assert out[0] == out[1]
    assert out[1][2]["preemptions"] > 0 and out[1][2]["resumes"] > 0
    _, calm = engines(problem_kw=dict(n_servers=4, mem=5000.0,
                                      wl=(4, n_new)), **kw)
    assert run(calm, TC)[0] == out[1][0]


def test_create_session_frames_checks():
    """Enc-dec sessions need frames of (S_enc, frame_dim) within
    max_enc_len, as the reference requires."""
    cfg = model()[0]
    ref, port = engines(R=2, max_new_tokens=4, max_enc_len=8)
    assert port.max_enc_len == ref.max_enc_len == 8
    route = TC.shortest_path_route(port.problem, port.alive_placement(),
                                   0)[0]
    toks = np.arange(2, 7)
    for frames, msg in ((None, "need encoder `frames`"),
                        (np.zeros((4, cfg.frame_dim + 1), np.float32),
                         "frames must be"),
                        (np.zeros((9, cfg.frame_dim), np.float32),
                         "exceeds max_enc_len")):
        with pytest.raises(ValueError, match=msg):
            port.create_session(toks, 0, route, 3, frames=frames)
    sid = port.create_session(toks, 0, route, 3,
                              frames=np.zeros((8, cfg.frame_dim)))
    assert port.sessions[sid].enc_len == 8
    for srv in port.servers.values():
        for t in srv.pool.tree:
            if "ck" in t:
                assert t["ck"].shape[2] == 8
