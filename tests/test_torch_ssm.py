"""The port's RWKV6 and Mamba2/zamba2 path against the JAX reference on the
CPU: the plain K3 (WKV6) and K4 (SSD) scans, the mixers, the blocks, and
the monolithic prefill + greedy decode of the reduced ``rwkv6_7b`` and
``zamba2_7b``.

Inputs are made with numpy from a seed and handed to both packages;
weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``repro_torch.weights.from_reference``.  The scans run here through the
wrappers on CPU tensors, i.e. their plain chunked versions; they are held
against the reference's Pallas kernels in interpret mode and its literal
``*_ref`` recurrences at the reference's own kernel tolerance (atol 1e-4,
rtol 1e-3: the chunked and sequential forms associate the decay products
differently).  Model-level outputs are held at rtol 2e-4 / atol 1e-5.
The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.kernels import ssd as r_ssd
from repro.kernels import ssd_ref as r_ssd_ref
from repro.kernels import wkv6 as r_wkv6
from repro.kernels import wkv6_ref as r_wkv6_ref
from repro.models import NULL_SH
from repro.models import blocks as RB
from repro.models import decode_step as r_decode_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models import ssm as RS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.kernels import (ssd, ssd_recurrence, ssd_unsupported, wkv6,
                                 wkv6_recurrence, wkv6_unsupported)
from repro_torch.models import blocks as TB
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_params as t_init_params
from repro_torch.models import prefill as t_prefill
from repro_torch.models import ssm as TS
from repro_torch.models.model import layer_params
from repro_torch.weights import from_reference

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
K_RTOL, K_ATOL = 1e-3, 1e-4
# zamba2 through its 7 layers: each block alone agrees to ~5e-6 at |h| ~ 15
# (f32 rounding, 3e-7 of the scale), but the recurrences amplify it across
# layers to ~1.3e-4 on K/V entries of magnitude ~3 and up to ~1e-4 on
# logits of scale ~3.3 (3e-5 of the scale).  The reference's own
# engine-vs-monolithic zamba2 test misses atol 1e-5 the same way (by
# 1.4e-5, ROADMAP C), so zamba2 is held at atol 2e-4 (caches) / 1e-4
# (logits) with the same rtol
CACHE_ATOL = {"rwkv6_7b": ATOL, "zamba2_7b": 2e-4}
LOGIT_ATOL = {"rwkv6_7b": ATOL, "zamba2_7b": 1e-4}
SEQ_LENS = [1, 5, 16, 37, 64, 130]


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
# K3: WKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, B, S, H, hd, state=False):
    rng = np.random.RandomState(seed)
    r, k, v = [(rng.randn(B, S, H, hd) * 0.4).astype(np.float32)
               for _ in range(3)]
    lw = np.clip(-np.exp(rng.randn(B, S, H, hd) * 0.5 - 1), -5.0,
                 -1e-4).astype(np.float32)
    u = (rng.randn(H, hd) * 0.3).astype(np.float32)
    s0 = (rng.randn(B, H, hd, hd) * 0.3).astype(np.float32) if state \
        else None
    return r, k, v, lw, u, s0


def _flat(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQ_LENS)
def test_wkv6_plain_vs_reference(S, with_state):
    """The plain chunked K3 equals the reference's Pallas kernel (interpret
    mode) and its literal recurrence, from zeros or a carried state."""
    B, H, hd = 2, 3, 8
    r, k, v, lw, u, s0 = _wkv_inputs(S, B, S, H, hd, with_state)
    out, st = wkv6(*map(T, (r, k, v, lw, u)),
                   None if s0 is None else T(s0))
    ro, rst = r_wkv6(*map(jnp.asarray, (r, k, v, lw, u)),
                     None if s0 is None else jnp.asarray(s0),
                     interpret=True)
    close(out, ro, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)
    uf = np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd)
    lo, lst = r_wkv6_ref(_flat(r), _flat(k), _flat(v), _flat(lw), uf,
                         None if s0 is None else s0.reshape(B * H, hd, hd))
    close(out, np.asarray(lo).reshape(B, H, S, hd).transpose(0, 2, 1, 3),
          K_RTOL, K_ATOL)
    close(st, np.asarray(lst).reshape(B, H, hd, hd), K_RTOL, K_ATOL)
    # the port's own float64 oracle
    po, pst = wkv6_recurrence(*map(T, (r, k, v, lw, u)),
                              None if s0 is None else T(s0))
    close(out, po, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)


def test_wkv6_resume_and_zero_pad_invariance():
    """Splitting a sequence and carrying the state across the split gives
    the one-shot run; trailing zero tokens (k = v = lw = 0) leave the state
    unchanged."""
    r, k, v, lw, u, _ = _wkv_inputs(10, 2, 37, 2, 8)
    args = [T(x) for x in (r, k, v, lw)]
    out, st = wkv6(*args, T(u))
    o1, s1 = wkv6(*[a[:, :13] for a in args], T(u))
    o2, s2 = wkv6(*[a[:, 13:] for a in args], T(u), s1)
    close(torch.cat([o1, o2], 1), out, K_RTOL, K_ATOL)
    close(s2, st, K_RTOL, K_ATOL)
    padded = [torch.cat([a, torch.zeros_like(a[:, :5])], 1) for a in args]
    _, sp = wkv6(*padded, T(u))
    close(sp, st, K_RTOL, K_ATOL)


# ---------------------------------------------------------------------------
# K4: SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, B, S, H, p, n, state=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, S, H, p) * 0.4).astype(np.float32)
    Bm = (rng.randn(B, S, n) * 0.4).astype(np.float32)
    Cm = (rng.randn(B, S, n) * 0.4).astype(np.float32)
    dt = (np.abs(rng.randn(B, S, H)) * 0.5 + 0.1).astype(np.float32)
    A = (-np.abs(rng.randn(H)) - 0.2).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    s0 = (rng.randn(B, H, p, n) * 0.3).astype(np.float32) if state else None
    return x, Bm, Cm, dt, A, D, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQ_LENS)
def test_ssd_plain_vs_reference(S, with_state):
    """The plain chunked K4 equals the reference's Pallas kernel (interpret
    mode) and its literal recurrence, from zeros or a carried state."""
    B, H, p, n = 2, 3, 8, 4
    x, Bm, Cm, dt, A, D, s0 = _ssd_inputs(S, B, S, H, p, n, with_state)
    y, st = ssd(*map(T, (x, Bm, Cm, dt, A, D)),
                None if s0 is None else T(s0))
    ry, rst = r_ssd(*map(jnp.asarray, (x, Bm, Cm, dt, A, D)),
                    None if s0 is None else jnp.asarray(s0), interpret=True)
    close(y, ry, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)
    xf = _flat(x)
    dtf = dt.transpose(0, 2, 1).reshape(B * H, S)
    Af = np.broadcast_to(A[None], (B, H)).reshape(-1)
    Df = np.broadcast_to(D[None], (B, H)).reshape(-1)
    ly, lst = r_ssd_ref(xf, Bm, Cm, dtf, Af, Df,
                        None if s0 is None else s0.reshape(B * H, p, n))
    close(y, np.asarray(ly).reshape(B, H, S, p).transpose(0, 2, 1, 3),
          K_RTOL, K_ATOL)
    close(st, np.asarray(lst).reshape(B, H, p, n), K_RTOL, K_ATOL)
    py, pst = ssd_recurrence(*map(T, (x, Bm, Cm, dt, A, D)),
                             None if s0 is None else T(s0))
    close(y, py, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)


def test_ssd_resume_and_zero_pad_invariance():
    x, Bm, Cm, dt, A, D, _ = _ssd_inputs(11, 2, 300, 2, 8, 4)
    seq = [T(a) for a in (x, Bm, Cm, dt)]
    y, st = ssd(*seq, T(A), T(D))
    y1, s1 = ssd(*[a[:, :131] for a in seq], T(A), T(D))
    y2, s2 = ssd(*[a[:, 131:] for a in seq], T(A), T(D), s1)
    close(torch.cat([y1, y2], 1), y, K_RTOL, K_ATOL)
    close(s2, st, K_RTOL, K_ATOL)
    padded = [torch.cat([a, torch.zeros_like(a[:, :7])], 1) for a in seq]
    _, sp = ssd(*padded, T(A), T(D))
    close(sp, st, K_RTOL, K_ATOL)


@pytest.mark.parametrize("which", ["wkv6", "ssd"])
def test_scan_no_fallback_off_cpu(which):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel or raises — never silently to the plain path."""
    assert wkv6_unsupported() is None and ssd_unsupported() is None
    before = (wkv6.launches, ssd.launches)
    with pytest.raises(ValueError, match="no kernel for device"):
        if which == "wkv6":
            x = torch.zeros((1, 4, 2, 16), device="meta")
            wkv6(x, x, x, x, torch.zeros((2, 16), device="meta"))
        else:
            x = torch.zeros((1, 4, 2, 16), device="meta")
            b = torch.zeros((1, 4, 16), device="meta")
            dt = torch.zeros((1, 4, 2), device="meta")
            a = torch.zeros((2,), device="meta")
            ssd(x, b, b, dt, a, a)
    assert (wkv6.launches, ssd.launches) == before


# ---------------------------------------------------------------------------
# mixers and blocks
# ---------------------------------------------------------------------------


def _rwkv_layer(layer=1):
    cfg, params, tcfg, tparams = bridged("rwkv6_7b")
    p = jax.tree.map(lambda x: x[layer], params["segments"]["blocks"])
    return cfg, p, tcfg, layer_params(tparams["segments"]["blocks"], layer)


def _mamba_layer():
    """A mamba mixer of the mega segment (step 1, block 0)."""
    cfg, params, tcfg, tparams = bridged("zamba2_7b")
    p = jax.tree.map(lambda x: x[1, 0], params["segments"]["mega"]["mamba"])
    tp = layer_params(layer_params(tparams["segments"]["mega"]["mamba"], 1),
                      0)
    return cfg, p, tcfg, tp


@pytest.mark.parametrize("S", [1, 19])
def test_rwkv_time_mix_full_and_decode(S):
    cfg, p, tcfg, tp = _rwkv_layer()
    rng = np.random.RandomState(S)
    x = (rng.randn(2, S, cfg.d_model) * 0.5).astype(np.float32)
    ry, rst = RS.apply_rwkv_tm_full(p["tm"], cfg, NULL_SH, jnp.asarray(x))
    ty, tst = TS.apply_rwkv_tm_full(tp["tm"], tcfg, T(x))
    close(ty, ry)
    close(tst["wkv"], rst["wkv"])
    close(tst["shift"], rst["shift"], 0, 0)
    x1 = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
    ry1, rst1 = RS.apply_rwkv_tm_decode(p["tm"], cfg, NULL_SH,
                                        jnp.asarray(x1), rst)
    ty1, tst1 = TS.apply_rwkv_tm_decode(tp["tm"], tcfg, T(x1), tst)
    close(ty1, ry1)
    close(tst1["wkv"], rst1["wkv"])


def test_rwkv_channel_mix():
    cfg, p, tcfg, tp = _rwkv_layer(0)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 9, cfg.d_model) * 0.5).astype(np.float32)
    ry, rs = RS.apply_rwkv_cm(p["cm"], cfg, NULL_SH, jnp.asarray(x))
    ty, ts = TS.apply_rwkv_cm(tp["cm"], tcfg, T(x))
    close(ty, ry)
    close(ts, rs, 0, 0)
    ry1, _ = RS.apply_rwkv_cm(p["cm"], cfg, NULL_SH, jnp.asarray(x[:, :1]),
                              shift_state=rs)
    ty1, _ = TS.apply_rwkv_cm(tp["cm"], tcfg, T(x[:, :1]), shift_state=ts)
    close(ty1, ry1)


@pytest.mark.parametrize("S", [1, 3, 24])
def test_mamba_mixer_full_and_decode(S):
    """Prefill (the plain SSD path) and one decode step; the conv tail
    carries the last w-1 inputs (zero-padded under w-1 tokens)."""
    cfg, p, tcfg, tp = _mamba_layer()
    rng = np.random.RandomState(S)
    x = (rng.randn(2, S, cfg.d_model) * 0.5).astype(np.float32)
    ry, rst = RS.apply_mamba_full(p["mixer"], cfg, NULL_SH, jnp.asarray(x))
    ty, tst = TS.apply_mamba_full(tp["mixer"], tcfg, T(x))
    close(ty, ry)
    close(tst["ssm"], rst["ssm"])
    close(tst["conv"], rst["conv"])
    x1 = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
    ry1, rst1 = RS.apply_mamba_decode(p["mixer"], cfg, NULL_SH,
                                      jnp.asarray(x1), rst)
    ty1, tst1 = TS.apply_mamba_decode(tp["mixer"], tcfg, T(x1), tst)
    close(ty1, ry1)
    close(tst1["ssm"], rst1["ssm"])
    close(tst1["conv"], rst1["conv"])


def test_rwkv_and_mamba_blocks():
    cfg, p, tcfg, tp = _rwkv_layer()
    rng = np.random.RandomState(5)
    h = (rng.randn(1, 11, cfg.d_model) * 0.5).astype(np.float32)
    rh, rst = RB.rwkv_block_full(p, cfg, NULL_SH, jnp.asarray(h))
    th, tst = TB.rwkv_block_full(tp, tcfg, T(h))
    close(th, rh)
    assert set(tst) == set(rst) == {"wkv", "shift_tm", "shift_cm"}
    h1 = (rng.randn(1, 1, cfg.d_model) * 0.5).astype(np.float32)
    rh1, _ = RB.rwkv_block_decode(p, cfg, NULL_SH, jnp.asarray(h1), rst)
    th1, _ = TB.rwkv_block_decode(tp, tcfg, T(h1), tst)
    close(th1, rh1)
    cfg, p, tcfg, tp = _mamba_layer()
    rh, rst = RB.mamba_block_full(p, cfg, NULL_SH, jnp.asarray(h))
    th, tst = TB.mamba_block_full(tp, tcfg, T(h))
    close(th, rh)
    rh1, _ = RB.mamba_block_decode(p, cfg, NULL_SH, jnp.asarray(h1), rst)
    th1, _ = TB.mamba_block_decode(tp, tcfg, T(h1), tst)
    close(th1, rh1)


def test_zamba_shared_full_and_decode():
    """The shared attention+MLP on concat(h, emb0) at width 2*d_model, then
    one decode token with its K/V written in place at ``pos``."""
    cfg, params, tcfg, tparams = bridged("zamba2_7b")
    rng = np.random.RandomState(6)
    S, Tc = 10, 14
    h = (rng.randn(1, S, cfg.d_model) * 0.5).astype(np.float32)
    e0 = (rng.randn(1, S, cfg.d_model) * 0.5).astype(np.float32)
    pos = np.arange(S)
    rh, rkv = RB.zamba_shared_full(params["shared"], cfg, NULL_SH,
                                   jnp.asarray(h), jnp.asarray(e0),
                                   jnp.asarray(pos))
    th, tkv = TB.zamba_shared_full(tparams["shared"], tcfg, T(h), T(e0),
                                   T(pos))
    close(th, rh)
    close(tkv["k"], rkv["k"])
    ck = np.zeros((1, Tc, cfg.n_kv_heads, cfg.head_dim), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(rkv["k"]), np.asarray(rkv["v"])
    h1 = (rng.randn(1, 1, cfg.d_model) * 0.5).astype(np.float32)
    e1 = (rng.randn(1, 1, cfg.d_model) * 0.5).astype(np.float32)
    rh1, rc1 = RB.zamba_shared_decode(
        params["shared"], cfg, NULL_SH, jnp.asarray(h1), jnp.asarray(e1),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, S)
    cache = {"k": T(ck), "v": T(cv)}
    th1, _ = TB.zamba_shared_decode(tparams["shared"], tcfg, T(h1), T(e1),
                                    cache, T(np.array([S])))
    close(th1, rh1)
    close(cache["k"], rc1["k"])
    close(cache["v"], rc1["v"])


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


def test_stack_kinds_and_plan_match_reference():
    from repro.models import stack_block_kinds as r_kinds
    from repro.models import stack_plan as r_plan
    from repro_torch.models import stack_block_kinds as t_kinds
    from repro_torch.models import stack_plan as t_plan

    for arch in ("rwkv6_7b", "zamba2_7b"):
        for reduced in (True, False):
            cfg = get_reduced_config(arch)
            tcfg = t_get_reduced_config(arch)
            if not reduced:
                from repro.configs import get_config
                from repro_torch.configs import get_config as t_get_config
                cfg, tcfg = get_config(arch), t_get_config(arch)
            assert t_kinds(tcfg) == r_kinds(cfg)
            assert [(s.name, s.kind, s.n, s.blocks_per_step)
                    for s in t_plan(tcfg)] == \
                [(s.name, s.kind, s.n, s.blocks_per_step)
                 for s in r_plan(cfg)]


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_init_params_matches_reference_tree(arch):
    """The torch init gives the reference's tree, shapes and dtypes
    (nested (n_mega, per, ...) mamba leaves and ``params["shared"]``)."""
    cfg, params, tcfg, _ = bridged(arch)
    tp = t_init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert {jax.tree_util.keystr(k) for k, _ in ref} == \
        {jax.tree_util.keystr(k) for k in got}
    for path, leaf in ref:
        g = got[path]
        assert g.shape == leaf.shape and g.dtype == leaf.dtype, path


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_prefill_and_decode_steps(arch):
    """Monolithic prompt + 5 greedy decode steps: logits within tolerance
    at every step, identical greedy tokens, the recurrent caches equal."""
    cfg, params, tcfg, tparams = bridged(arch)
    rng = np.random.RandomState(10)
    toks = rng.randint(2, cfg.vocab_size, (2, 19))
    cache_len = 19 + 6
    rl, rcache = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)}, cache_len=cache_len)
    tl, tcache = t_prefill(tparams, tcfg, {"tokens": T(toks)},
                           cache_len=cache_len)
    close(tl, rl, atol=LOGIT_ATOL[arch])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(rcache)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tcache))[0])
    assert flat_r.keys() == flat_t.keys()
    for path in flat_r:
        close(T(flat_t[path]), flat_r[path], atol=CACHE_ATOL[arch])
    nxt = np.asarray(jnp.argmax(rl, -1))
    assert (tl.argmax(-1).numpy() == nxt).all()
    for i in range(5):
        rl, rcache = r_decode_step(params, cfg, NULL_SH, rcache,
                                   jnp.asarray(nxt), 19 + i)
        tl, tcache = t_decode_step(tparams, tcfg, tcache, T(nxt), 19 + i)
        close(tl, rl, atol=LOGIT_ATOL[arch])
        nxt = np.asarray(jnp.argmax(rl, -1))
        assert (tl.argmax(-1).numpy() == nxt).all()


def test_block_param_range_views_and_boundary_copy():
    """Hybrid ranges inside the mega segment or the tail are views of the
    stacked leaves (replicas share one copy); a range across the boundary
    copies just that range; every range equals the reference's."""
    from repro.models.model import block_param_range as r_range
    from repro_torch.models import block_param_range, hybrid_mamba_stack

    cfg, params, tcfg, tparams = bridged("zamba2_7b")  # 7 = 2 x 3 + 1
    mega = tparams["segments"]["mega"]["mamba"]["mixer"]["wz"]
    v = block_param_range(tparams, tcfg, "mamba", 1, 5)["mixer"]["wz"]
    assert v.untyped_storage().data_ptr() == \
        mega.untyped_storage().data_ptr()
    assert v.data_ptr() == mega[0, 1].data_ptr()
    tail = tparams["segments"]["tail"]["mixer"]["wz"]
    v = block_param_range(tparams, tcfg, "mamba", 6, 7)["mixer"]["wz"]
    assert v.data_ptr() == tail.data_ptr()
    for lo, hi in [(0, 3), (2, 3), (3, 6), (6, 7), (4, 7), (0, 7)]:
        got = block_param_range(tparams, tcfg, "mamba", lo, hi)
        ref = r_range(params, cfg, "mamba", lo, hi)
        for g, r in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got)),
                        jax.tree.leaves(ref)):
            np.testing.assert_array_equal(g, np.asarray(r))
    assert hybrid_mamba_stack(tparams, tcfg)["mixer"]["wz"].shape[0] == 7
    rw = block_param_range(bridged("rwkv6_7b")[3], t_get_reduced_config(
        "rwkv6_7b"), "rwkv", 1, 2)["tm"]["wr"]
    assert rw.data_ptr() == \
        bridged("rwkv6_7b")[3]["segments"]["blocks"]["tm"]["wr"][1].data_ptr()
