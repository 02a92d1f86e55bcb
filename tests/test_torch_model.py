"""PyTorch port vs the JAX reference: layers, GQA attention, decoder blocks
and the monolithic prefill + greedy decode, on reduced configs in f32.

Inputs are made with numpy from a seed and handed to both packages;
weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``repro_torch.weights.from_reference``.  Tolerance: rtol 2e-4 / atol 1e-5,
the reference's own tolerance between two separately compiled programs
(tests/test_family_pools.py) — the two frameworks order f32 sums
differently.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.models import NULL_SH
from repro.models import attention as RA
from repro.models import blocks as RB
from repro.models import decode_step as r_decode_step
from repro.models import init_params as r_init_params
from repro.models import layers as RL
from repro.models import prefill as r_prefill
from repro_torch.configs import ARCH_IDS, PAPER_ARCH_IDS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_params as t_init_params
from repro_torch.models import layers as TL
from repro_torch.models import prefill as t_prefill
from repro_torch.models import upcast_prefill_logits
from repro_torch.models.model import layer_params, tree_map
from repro_torch.weights import from_reference

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
DENSE_ARCHS = ["llama3_2_1b", "qwen2_5_32b", "gemma3_4b", "olmo_1b",
               "chameleon_34b", "bloom_176b"]
# gemma3's reduced stack is 7 layers deep (the others 2) with sandwich
# norms; its logits (scale ~27) differ by up to ~2.4e-5 between the two
# frameworks — under 1e-6 of the logit scale, i.e. f32 rounding — so near-
# zero logits need atol 5e-5 there
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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_kind", ["rmsnorm", "layernorm",
                                       "nonparametric"])
def test_apply_norm(norm_kind):
    cfg = get_reduced_config("llama3_2_1b").replace(norm_kind=norm_kind)
    tcfg = t_get_reduced_config("llama3_2_1b").replace(norm_kind=norm_kind)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    p = {"scale": rng.randn(cfg.d_model).astype(np.float32),
         "bias": rng.randn(cfg.d_model).astype(np.float32)}
    ref = RL.apply_norm(p, cfg, jnp.asarray(x))
    got = TL.apply_norm({k: T(v) for k, v in p.items()}, tcfg, T(x))
    close(got, ref)
    close(TL.rms_norm_simple(T(x), T(p["scale"]), 1e-6),
          RL.rms_norm_simple(jnp.asarray(x), jnp.asarray(p["scale"]), 1e-6))


def test_rope_per_row_positions():
    """Per-row positions (B, S) — the port's pooled decode takes one
    position per row; each row equals the reference's shared-arange call."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 2, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [100, 101, 102, 103]])
    cos, sin = TL.rope_angles(T(pos), 16, 500_000.0)
    got = TL.apply_rope(T(x), cos, sin)
    for b in range(3):
        rc, rs = RL.rope_angles(jnp.asarray(pos[b]), 16, 500_000.0)
        close(got[b], RL.apply_rope(jnp.asarray(x[b]), rc, rs))


@pytest.mark.parametrize("n_heads", [4, 12, 32])
def test_alibi_slopes(n_heads):
    close(TL.alibi_slopes(n_heads), RL.alibi_slopes(n_heads), rtol=0,
          atol=0)


@pytest.mark.parametrize("vocab,tie", [(256, True), (250, False)])
def test_lm_head_and_vocab_pad_bias(vocab, tie):
    """Tied and untied heads; a padded vocabulary masks its pad columns
    with the finite -1e30 bias."""
    cfg = get_reduced_config("llama3_2_1b").replace(vocab_size=vocab,
                                                    tie_embeddings=tie)
    tcfg = t_get_reduced_config("llama3_2_1b").replace(vocab_size=vocab,
                                                       tie_embeddings=tie)
    params, _ = r_init_params(jax.random.PRNGKey(3), cfg)
    emb = params["embed"]
    temb = from_reference(jax.tree.map(np.asarray, emb), "cpu")
    h = np.random.RandomState(2).randn(2, 3, cfg.d_model).astype(np.float32)
    close(TL.lm_head(temb, tcfg, T(h)), RL.lm_head(emb, cfg, NULL_SH,
                                                   jnp.asarray(h)))
    bias = TL.vocab_pad_bias(tcfg)
    if vocab == cfg.padded_vocab:
        assert bias is None
    else:
        close(bias, RL.vocab_pad_bias(cfg), rtol=0, atol=0)
    tok = np.array([[1, 5, 255]])
    close(TL.embed_tokens(temb, tcfg, T(tok)),
          RL.embed_tokens(emb, cfg, NULL_SH, jnp.asarray(tok)), rtol=0,
          atol=0)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "bloom_176b"])
def test_apply_mlp(arch):
    """SwiGLU (llama) and the plain gelu MLP (bloom)."""
    cfg, params, tcfg, tparams = bridged(arch)
    p = jax.tree.map(lambda x: x[0], params["segments"]["blocks"]["ffn"])
    tp = layer_params(tparams["segments"]["blocks"]["ffn"], 0)
    x = np.random.RandomState(4).randn(2, 3, cfg.d_model).astype(np.float32)
    close(TL.apply_mlp(tp, tcfg, T(x)),
          RL.apply_mlp(p, cfg, NULL_SH, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,Tk,window,alibi,q_start", [
    (12, 12, None, False, 0),   # dense path
    (9, 20, 6, True, 11),       # dense, chunk suffix + window + ALiBi
    (6, 2200, None, False, 2194),  # flash path (T > DENSE_MAX_T)
])
def test_attention_core(S, Tk, window, alibi, q_start):
    rng = np.random.RandomState(5)
    H, D = 4, 16
    q = rng.randn(2, S, H, D).astype(np.float32) * 0.5
    k = rng.randn(2, Tk, H, D).astype(np.float32) * 0.5
    v = rng.randn(2, Tk, H, D).astype(np.float32) * 0.5
    q_pos = q_start + np.arange(S)
    kv_pos = np.arange(Tk)
    slopes = RL.alibi_slopes(H) if alibi else None
    ref = RA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(q_pos), jnp.asarray(kv_pos), window,
                            slopes, q_start=q_start)
    got = TA.attention_core(T(q), T(k), T(v), T(q_pos), T(kv_pos), window,
                            None if slopes is None else T(slopes),
                            q_start=q_start)
    close(got, ref)


@pytest.mark.parametrize("window,alibi", [(None, False), (5, False),
                                          (None, True)])
def test_decode_attention_plain_per_row(window, alibi):
    """The port's plain decode path with a (B,) position vector equals the
    reference's scalar-pos XLA path row by row."""
    rng = np.random.RandomState(6)
    B, H, Kv, D, Tc = 3, 4, 2, 16, 24
    q = rng.randn(B, 1, H, D).astype(np.float32)
    ck = rng.randn(B, Tc, Kv, D).astype(np.float32)
    cv = rng.randn(B, Tc, Kv, D).astype(np.float32)
    pos = np.array([3, 17, 23])
    slopes = RL.alibi_slopes(H) if alibi else None
    got = TA.decode_attention_plain(T(q), T(ck), T(cv), T(pos), window,
                                    None if slopes is None else T(slopes))
    for b in range(B):
        ref = RA.decode_attention_xla(
            jnp.asarray(q[b:b + 1]), jnp.asarray(ck[b:b + 1]),
            jnp.asarray(cv[b:b + 1]), int(pos[b]), window, slopes)
        close(got[b:b + 1], ref)


def test_gqa_full_chunked_prefix():
    """Chunked prefill: the chunk over [cached prefix + chunk] equals the
    reference's apply_gqa_full with the same prefix."""
    cfg, params, tcfg, tparams = bridged("llama3_2_1b")
    p = jax.tree.map(lambda x: x[0], params["segments"]["blocks"]["attn"])
    tp = layer_params(tparams["segments"]["blocks"]["attn"], 0)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    pk = rng.randn(2, 8, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    pv = rng.randn(2, 8, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    pos = 8 + np.arange(5)
    ry, (rk, rv) = RA.apply_gqa_full(p, cfg, NULL_SH, jnp.asarray(x),
                                     jnp.asarray(pos),
                                     prefix_kv=(jnp.asarray(pk),
                                                jnp.asarray(pv)))
    ty, (tk, tv) = TA.apply_gqa_full(tp, tcfg, T(x), T(pos),
                                     prefix_kv=(T(pk), T(pv)))
    close(ty, ry)
    close(tk, rk)
    close(tv, rv)


def test_gqa_decode_inplace_write_and_mask():
    """Decode writes K/V in place at each row's (clamped) position, only on
    active rows; the attention output equals the reference per row."""
    cfg, params, tcfg, tparams = bridged("llama3_2_1b")
    p = jax.tree.map(lambda x: x[0], params["segments"]["blocks"]["attn"])
    tp = layer_params(tparams["segments"]["blocks"]["attn"], 0)
    rng = np.random.RandomState(8)
    B, Tc = 3, 16
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    ck = rng.randn(B, Tc, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    cv = rng.randn(B, Tc, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    pos = np.array([4, 15, 9])
    active = np.array([True, True, False])
    tk, tv = T(ck), T(cv)
    ty, _, _ = TA.apply_gqa_decode(tp, tcfg, T(x), tk, tv, T(pos),
                                   active=T(active))
    for b in range(B):
        ry, rk, rv = RA.apply_gqa_decode(
            p, cfg, NULL_SH, jnp.asarray(x[b:b + 1]),
            jnp.asarray(ck[b:b + 1]), jnp.asarray(cv[b:b + 1]),
            int(pos[b]))
        if active[b]:
            close(ty[b:b + 1], ry)
            close(tk[b:b + 1], rk)
            close(tv[b:b + 1], rv)
        else:  # inactive: cache untouched
            np.testing.assert_array_equal(tk[b].numpy(), ck[b])
            np.testing.assert_array_equal(tv[b].numpy(), cv[b])
    # an out-of-range position clamps like dynamic_update_slice
    tk2 = T(ck)
    TA.write_token(tk2, T(np.ones((B, 1, cfg.n_kv_heads, cfg.head_dim),
                                  np.float32)), T(np.array([99, -3, 2])))
    assert (tk2[0, Tc - 1] == 1).all() and (tk2[1, 0] == 1).all()
    assert (tk2[2, 2] == 1).all()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layer", [("llama3_2_1b", 1),
                                        ("gemma3_4b", 0),
                                        ("gemma3_4b", 2)])
def test_decoder_block_full_and_decode(arch, layer):
    """One block, prefill then one decode token (gemma3: a local layer
    with its sliding window and a global one)."""
    cfg, params, tcfg, tparams = bridged(arch)
    p = jax.tree.map(lambda x: x[layer], params["segments"]["blocks"])
    tp = layer_params(tparams["segments"]["blocks"], layer)
    rng = np.random.RandomState(9)
    S = 20
    h = rng.randn(1, S, cfg.d_model).astype(np.float32)
    pos = np.arange(S)
    rh, rc, _ = RB.decoder_block_full(p, cfg, NULL_SH, jnp.asarray(h),
                                      jnp.asarray(pos), layer)
    th, tc, _ = TB.decoder_block_full(tp, tcfg, T(h), T(pos), layer)
    close(th, rh)
    close(tc["k"], rc["k"])
    Tc = 24
    ck = np.zeros((1, Tc, cfg.n_kv_heads, cfg.head_dim), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(rc["k"]), np.asarray(rc["v"])
    h1 = rng.randn(1, 1, cfg.d_model).astype(np.float32)
    rh1, rc1 = RB.decoder_block_decode(
        p, cfg, NULL_SH, jnp.asarray(h1),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, S, layer)
    tcache = {"k": T(ck), "v": T(cv)}
    th1, _ = TB.decoder_block_decode(tp, tcfg, T(h1), tcache,
                                     T(np.array([S])), layer)
    close(th1, rh1)
    close(tcache["v"], rc1["v"])


def test_window_for_layer():
    tcfg = t_get_reduced_config("gemma3_4b")
    wins = [TB.window_for_layer(tcfg, i) for i in range(tcfg.n_layers)]
    cfg = get_reduced_config("gemma3_4b")
    ref = [int(RB.window_for_layer(cfg, i)) for i in range(cfg.n_layers)]
    assert wins == ref
    assert TB.window_for_layer(t_get_reduced_config("llama3_2_1b"), 0) is None


# ---------------------------------------------------------------------------
# monolithic prefill + greedy decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_steps(arch):
    """Prompt + 5 greedy decode steps: logits within tolerance at every
    step, identical greedy tokens (the streams feed back)."""
    cfg, params, tcfg, tparams = bridged(arch)
    rng = np.random.RandomState(10)
    toks = rng.randint(2, cfg.vocab_size, (2, 19))
    cache_len = 19 + 6
    rl, rcache = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)}, cache_len=cache_len)
    tl, tcache = t_prefill(tparams, tcfg, {"tokens": T(toks)},
                           cache_len=cache_len)
    atol = LOGIT_ATOL.get(arch, ATOL)
    close(tl, rl, atol=atol)
    close(tcache["blocks"]["k"], rcache["blocks"]["k"], atol=atol)
    nxt = np.asarray(jnp.argmax(rl, -1))
    assert (tl.argmax(-1).numpy() == nxt).all()
    for i in range(5):
        rl, rcache = r_decode_step(params, cfg, NULL_SH, rcache,
                                   jnp.asarray(nxt), 19 + i)
        tl, tcache = t_decode_step(tparams, tcfg, tcache, T(nxt), 19 + i)
        close(tl, rl, atol=atol)
        nxt = np.asarray(jnp.argmax(rl, -1))
        assert (tl.argmax(-1).numpy() == nxt).all()


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2"])
def test_later_slices_raise(arch):
    """Device groups take encoder-decoder blocks
    (tests/test_torch_group_families.py) and, since the slice this test
    once pinned as raising, the reference's ``head_dim`` fallback too: a
    group whose query heads do not divide its model axis (the reduced
    stack's 4 heads on a (1, 8) group), asked for as a mesh or as a
    device group, serves a session with frames to the solo engine's
    tokens and logits."""
    import repro_torch.core as TC
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.serving import GeoServingSystem

    tcfg = t_get_reduced_config(arch)
    tparams = t_init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    llm = TC.LLMSpec("toy", tcfg.n_layers, 100.0, 1.0)
    prob = TC.Problem(llm, [TC.ServerSpec(0, 1000.0, 0.01)], 1,
                      np.full((1, 1), 0.02), np.full((1, 1), 0.06),
                      workload=TC.Workload(4, 8))
    rng = np.random.RandomState(0)
    prompt = rng.randint(2, tcfg.vocab_size, 6)
    frames = rng.randn(9, tcfg.frame_dim).astype(np.float32)

    def run(**kw):
        system = GeoServingSystem(tcfg, tparams, prob, device="cpu", **kw)
        route, _ = TC.shortest_path_route(system.problem,
                                          system.alive_placement(), 0)
        sid = system.create_session(prompt, 0, route, 4, frames=frames)
        assert system.try_admit_sessions([sid]) == [sid]
        system.drain_prefill()
        logits = [np.array(system.sessions[sid].last_logits)]
        while system.sessions[sid].n_generated < 4:
            system.decode_round([sid])
            logits.append(np.array(system.sessions[sid].last_logits))
        return list(system.sessions[sid].tokens), logits

    want = run()
    mesh = GroupMesh(np.full((1, 8), "cpu", dtype=object))
    for kw in (dict(mesh=mesh), dict(device_groups={0: mesh})):
        got = run(**kw)
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, atol=5e-6, rtol=1e-4)


def test_block_param_range_is_a_view():
    """Replicas of a block on several virtual servers share one copy."""
    from repro_torch.models import block_param_range

    _, _, tcfg, tparams = bridged("llama3_2_1b")
    stacked = tparams["segments"]["blocks"]["attn"]["wq"]
    view = block_param_range(tparams, tcfg, "decoder", 1, 2)["attn"]["wq"]
    assert view.data_ptr() == stacked[1].data_ptr()
    assert view.untyped_storage().data_ptr() == \
        stacked.untyped_storage().data_ptr()


def test_init_params_matches_reference_tree():
    """The torch init gives the reference's tree, shapes and dtypes, and
    the truncated-normal scale 1/sqrt(fan_in)."""
    cfg, params, tcfg, _ = bridged("llama3_2_1b")
    tp = t_init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert {jax.tree_util.keystr(k) for k, _ in ref} == \
        {jax.tree_util.keystr(k) for k in got}
    for path, leaf in ref:
        g = got[path]
        assert g.shape == leaf.shape and g.dtype == leaf.dtype, path
    wq = tp["segments"]["blocks"]["attn"]["wq"]
    # std of N(0,1) truncated to [-2, 2] is 0.8796
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 0.8796) < 0.05
    assert wq.abs().max().item() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6


@pytest.mark.parametrize("arch", ARCH_IDS + PAPER_ARCH_IDS)
def test_upcast_prefill_logits_equal_whole_tree_upcast(arch):
    """The f32 twin of a bf16 model that casts one layer at a time
    (``upcast_prefill_logits``, ROADMAP C5's reading) gives the logits of
    ``prefill`` on the whole tree cast to f32 up front: bit for bit with
    the LM head cast whole, and within f32 rounding of the product (1e-6
    of the logit scale) with it cast in vocabulary chunks."""
    cfg = t_get_reduced_config(arch).replace(param_dtype="bfloat16",
                                             act_dtype="bfloat16")
    params = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(1)
    batch = {"tokens": T(rng.randint(2, cfg.vocab_size, (1, 9)))}
    if cfg.is_enc_dec:
        batch["frames"] = T(rng.randn(1, 12, cfg.frame_dim)
                            .astype(np.float32))
    whole = t_prefill(tree_map(lambda x: x.float(), params),
                      cfg.replace(param_dtype="float32",
                                  act_dtype="float32"),
                      batch, backend="plain")[0]
    assert whole.dtype == torch.float32
    assert torch.equal(upcast_prefill_logits(params, cfg, batch,
                                             vocab_chunk=None), whole)
    chunked = upcast_prefill_logits(params, cfg, batch, vocab_chunk=96)
    live = slice(0, cfg.vocab_size)
    assert (chunked[:, live] - whole[:, live]).abs().max() <= \
        1e-6 * whole[:, live].abs().max()
