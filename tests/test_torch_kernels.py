"""The port's K1/K2 wrappers on CPU tensors (their plain PyTorch versions)
against the reference's Pallas kernels in interpret mode and its pure-jnp
``*_ref`` oracles — analogs of tests/test_kernels.py's attention sweeps:
GQA/MQA, ragged lengths, sliding windows with fully masked tiles, ALiBi,
chunked-prefill ``q_start``, non-causal Sq != Skv / Dv != Dk, per-row
``pos``, cross ``kv_len``, the MLA scale and the T % block padding
regressions.  The CUDA kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerance: f32 5e-5 (the reference's kernel-vs-oracle tolerance); bf16
inputs are compared after both sides compute in f32 from the same bf16
values, at 2e-2 (one bf16 ulp of the output near 1).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref as r_attention_ref
from repro.kernels import decode_attention as r_decode_attention
from repro.kernels import decode_attention_ref as r_decode_attention_ref
from repro.kernels import flash_attention as r_flash_attention
from repro.models.layers import alibi_slopes as r_alibi_slopes
from repro_torch.kernels import (decode_attention, decode_attention_ref,
                                 decode_attention_unsupported, decode_plan,
                                 flash_attention, flash_attention_unsupported)
from repro_torch.kernels.decode_attention.ops import (FILL_PAIRS,
                                                      TARGET_BLOCKS, TILES)
from repro_torch.models.layers import alibi_slopes

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)

TOLS = {"float32": 5e-5, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype))


def _close(got, ref, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(), _np(ref),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def _inputs(seed, *shapes, dtype="float32"):
    """numpy inputs rounded to ``dtype`` once, so both packages see the
    same values."""
    rng = np.random.RandomState(seed)
    out = []
    for s in shapes:
        x = (rng.randn(*s) * 0.3).astype(np.float32)
        out.append(_np(jnp.asarray(x, getattr(jnp, dtype))))
    return out


def _gqa_flat(q, k, v):
    B, Sq, H, Dk = q.shape
    Kv, Dv, Skv = k.shape[2], v.shape[-1], k.shape[1]
    return (q.transpose(0, 2, 1, 3).reshape(B * H, Sq, Dk),
            k.transpose(0, 2, 1, 3).reshape(B * Kv, Skv, Dk),
            v.transpose(0, 2, 1, 3).reshape(B * Kv, Skv, Dv))


# ---------------------------------------------------------------------------
# K2: flash attention (prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Kv,D,window", [
    (1, 64, 2, 2, 16, None),
    (2, 100, 4, 2, 16, None),  # GQA + ragged tiles
    (1, 96, 4, 1, 32, None),  # MQA
    (2, 80, 2, 2, 16, 24),  # sliding window
])
def test_flash_attention_sweep(dtype, B, S, H, Kv, D, window):
    q, k, v = _inputs(B * 1000 + S, (B, S, H, D), (B, S, Kv, D),
                      (B, S, Kv, D), dtype=dtype)
    got = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          causal=True, window=window)
    jd = getattr(jnp, dtype)
    ref = r_flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                            jnp.asarray(v, jd), causal=True, window=window,
                            block_q=32, block_kv=32, interpret=True)
    _close(got, ref, dtype)


def test_flash_attention_small_window_fully_masked_tiles():
    """Window 4 << tile: whole KV tiles below the diagonal are masked and
    must add exact zeros (NEG_INF is finite)."""
    q, k, v = _inputs(0, (1, 96, 2, 16), (1, 96, 2, 16), (1, 96, 2, 16))
    got = flash_attention(_t(q, "float32"), _t(k, "float32"),
                          _t(v, "float32"), causal=True, window=4)
    ref = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=4, block_q=16, block_kv=16,
                            interpret=True)
    _close(got, ref)
    qf, kf, vf = _gqa_flat(q, k, v)
    oracle = r_attention_ref(qf, kf, vf, causal=True, window=4)
    _close(got, _np(oracle).reshape(1, 2, 96, 16).transpose(0, 2, 1, 3))


def test_flash_attention_q_start_chunked_prefill():
    """The suffix chunk's queries over the full key range equal the
    corresponding rows of the one-shot computation and the oracle."""
    B, S, H, Kv, D, off = 2, 48, 4, 2, 16, 32
    q, k, v = _inputs(1, (B, S, H, D), (B, S, Kv, D), (B, S, Kv, D))
    full = flash_attention(_t(q, "float32"), _t(k, "float32"),
                           _t(v, "float32"))
    chunk = flash_attention(_t(q[:, off:], "float32"), _t(k, "float32"),
                            _t(v, "float32"), q_start=off)
    np.testing.assert_allclose(chunk.numpy(), full[:, off:].numpy(),
                               atol=5e-5, rtol=5e-5)
    qf = q[:, off:].transpose(0, 2, 1, 3).reshape(B * H, S - off, D)
    _, kf, vf = _gqa_flat(q, k, v)
    ref = r_attention_ref(qf, kf, vf, causal=True, q_start=off)
    _close(chunk, _np(ref).reshape(B, H, S - off, D).transpose(0, 2, 1, 3))


def test_flash_attention_alibi_slopes():
    B, S, H, D = 2, 40, 4, 16
    q, k, v = _inputs(2, (B, S, H, D), (B, S, H, D), (B, S, H, D))
    got = flash_attention(_t(q, "float32"), _t(k, "float32"),
                          _t(v, "float32"), slopes=alibi_slopes(H))
    ref = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            slopes=r_alibi_slopes(H), block_q=16,
                            block_kv=16, interpret=True)
    _close(got, ref)


def test_flash_attention_non_causal_cross_shapes():
    """Cross-attention regime: Sq != Skv and Dv != Dk, non-causal."""
    B, Sq, Skv, H, Kv, Dk, Dv = 2, 7, 19, 4, 2, 16, 8
    q, k, v = _inputs(3, (B, Sq, H, Dk), (B, Skv, Kv, Dk), (B, Skv, Kv, Dv))
    got = flash_attention(_t(q, "float32"), _t(k, "float32"),
                          _t(v, "float32"), causal=False)
    ref = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, block_q=4, block_kv=8,
                            interpret=True)
    _close(got, ref)


@pytest.mark.parametrize("window", [5, None])
def test_flash_attention_window_values(window):
    """Local and global windows (gemma3's per-layer pattern) — the kernel
    takes the window at run time."""
    q, k, v = _inputs(4, (1, 32, 2, 16), (1, 32, 2, 16), (1, 32, 2, 16))
    got = flash_attention(_t(q, "float32"), _t(k, "float32"),
                          _t(v, "float32"), window=window)
    qf, kf, vf = _gqa_flat(q, k, v)
    ref = r_attention_ref(qf, kf, vf, causal=True, window=window)
    _close(got, _np(ref).reshape(1, 2, 32, 16).transpose(0, 2, 1, 3))


def test_flash_attention_guard_raises():
    assert flash_attention_unsupported() is None
    assert flash_attention_unsupported(causal=False) is None
    assert "window" in flash_attention_unsupported(causal=False, window=8)
    assert "q_start" in flash_attention_unsupported(causal=False, q_start=4)
    assert "ALiBi" in flash_attention_unsupported(causal=False,
                                                  slopes=torch.ones(2))
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, causal=False, window=8)


# ---------------------------------------------------------------------------
# K1: decode attention
# ---------------------------------------------------------------------------


def _decode_flat(q, ck, cv):
    B, _, H, Dk = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    return (q.reshape(B * Kv, H // Kv, Dk),
            ck.transpose(0, 2, 1, 3).reshape(B * Kv, T, Dk),
            cv.transpose(0, 2, 1, 3).reshape(B * Kv, T, cv.shape[-1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Kv,Dk,Dv,T,pos", [
    (2, 4, 2, 16, 16, 128, 100),
    (1, 8, 1, 24, 16, 200, 63),  # MLA-like: MQA with asymmetric K/V dims
    (2, 2, 2, 32, 32, 96, 95),
])
def test_decode_attention_sweep(dtype, B, H, Kv, Dk, Dv, T, pos):
    q, ck, cv = _inputs(B * 100 + T, (B, 1, H, Dk), (B, T, Kv, Dk),
                        (B, T, Kv, Dv), dtype=dtype)
    got = decode_attention(_t(q, dtype), _t(ck, dtype), _t(cv, dtype), pos)
    jd = getattr(jnp, dtype)
    ref = r_decode_attention(jnp.asarray(q, jd), jnp.asarray(ck, jd),
                             jnp.asarray(cv, jd), pos, block_kv=64,
                             interpret=True)
    _close(got, ref, dtype)


def test_decode_attention_per_row_pos():
    """Pooled rows decode at different positions; each row equals the
    scalar-pos call."""
    B, H, Kv, D, T = 4, 4, 2, 16, 96
    q, ck, cv = _inputs(5, (B, 1, H, D), (B, T, Kv, D), (B, T, Kv, D))
    pos = np.array([3, 40, 77, 95])
    got = decode_attention(_t(q, "float32"), _t(ck, "float32"),
                           _t(cv, "float32"), torch.from_numpy(pos))
    qf, kf, vf = _decode_flat(q, ck, cv)
    ref = r_decode_attention_ref(qf, kf, vf, np.repeat(pos, Kv))
    _close(got, _np(ref).reshape(B, 1, H, D))
    for i in range(B):
        solo = decode_attention(_t(q[i:i + 1], "float32"),
                                _t(ck[i:i + 1], "float32"),
                                _t(cv[i:i + 1], "float32"), int(pos[i]))
        np.testing.assert_array_equal(solo[0].numpy(), got[i].numpy())


@pytest.mark.parametrize("window", [4, 24])
def test_decode_attention_sliding_window(window):
    """Sliding-window decode incl. tiles wholly outside the window."""
    B, H, Kv, D, T = 2, 4, 2, 16, 96
    q, ck, cv = _inputs(6, (B, 1, H, D), (B, T, Kv, D), (B, T, Kv, D))
    pos = np.array([90, 50])
    got = decode_attention(_t(q, "float32"), _t(ck, "float32"),
                           _t(cv, "float32"), torch.from_numpy(pos),
                           window=window)
    ref = r_decode_attention(jnp.asarray(q), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(pos),
                             window=window, block_kv=16, interpret=True)
    _close(got, ref)


def test_decode_attention_alibi_slopes():
    B, H, Kv, D, T = 2, 4, 2, 16, 64
    q, ck, cv = _inputs(7, (B, 1, H, D), (B, T, Kv, D), (B, T, Kv, D))
    pos = np.array([63, 10])
    got = decode_attention(_t(q, "float32"), _t(ck, "float32"),
                           _t(cv, "float32"), torch.from_numpy(pos),
                           slopes=alibi_slopes(H))
    ref = r_decode_attention(jnp.asarray(q), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(pos),
                             slopes=r_alibi_slopes(H), block_kv=16,
                             interpret=True)
    _close(got, ref)


def test_decode_attention_cross_kv_len():
    """Non-causal over an over-allocated cache; per-row kv_len masks the
    invalid tail."""
    B, H, Kv, D, T = 3, 4, 2, 16, 40
    q, ck, cv = _inputs(8, (B, 1, H, D), (B, T, Kv, D), (B, T, Kv, D))
    kv_len = np.array([5, 17, 40])
    got = decode_attention(_t(q, "float32"), _t(ck, "float32"),
                           _t(cv, "float32"), 0, causal=False,
                           kv_len=torch.from_numpy(kv_len))
    qf, kf, vf = _decode_flat(q, ck, cv)
    ref = r_decode_attention_ref(qf, kf, vf, np.zeros(B * Kv, np.int32),
                                 causal=False,
                                 kv_len=np.repeat(kv_len, Kv))
    _close(got, _np(ref).reshape(B, 1, H, D))


def test_decode_attention_mla_faithful_scale():
    """A caller scale (MLA absorbed decode: 1/sqrt(nope+rope))."""
    B, H, lora, rope, nope, T = 2, 4, 24, 8, 16, 48
    q, ck, cv = _inputs(9, (B, 1, H, lora + rope), (B, T, 1, lora + rope),
                        (B, T, 1, lora))
    scale = 1.0 / np.sqrt(nope + rope)
    got = decode_attention(_t(q, "float32"), _t(ck, "float32"),
                           _t(cv, "float32"), T - 1, scale=scale)
    ref = r_decode_attention(jnp.asarray(q), jnp.asarray(ck),
                             jnp.asarray(cv), T - 1, scale=scale,
                             block_kv=16, interpret=True)
    _close(got, ref)


@pytest.mark.parametrize("T", [5, 65, 33])
def test_decode_attention_padding_regressions(T):
    """pos == T-1 with T not a multiple of the tile."""
    B, H, Kv, D = 2, 4, 2, 16
    q, ck, cv = _inputs(T, (B, 1, H, D), (B, T, Kv, D), (B, T, Kv, D))
    got = decode_attention(_t(q, "float32"), _t(ck, "float32"),
                           _t(cv, "float32"), T - 1)
    qf, kf, vf = _decode_flat(q, ck, cv)
    ref = r_decode_attention_ref(qf, kf, vf, T - 1)
    _close(got, _np(ref).reshape(B, 1, H, D))


def test_decode_attention_fully_masked_row_is_zero():
    """A row with no reachable key (pos beyond kv_len) yields zeros, as the
    kernel (and the reference's Pallas kernel) does."""
    q, ck, cv = _inputs(11, (2, 1, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16))
    got = decode_attention_ref(_t(q, "float32"), _t(ck, "float32"),
                               _t(cv, "float32"), torch.tensor([3, 5]),
                               kv_len=torch.tensor([0, 8]))
    assert (got[0] == 0).all() and (got[1] != 0).any()


def test_decode_attention_guard_raises():
    assert decode_attention_unsupported() is None
    assert decode_attention_unsupported(causal=False, kv_len=4) is None
    assert "window" in decode_attention_unsupported(causal=False, window=8)
    q, c = torch.zeros((1, 1, 2, 8)), torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, c, c, 0, causal=False, window=8)


# ---------------------------------------------------------------------------
# K1's split-KV plan (host side) and split-then-combine arithmetic
# ---------------------------------------------------------------------------

PLAN_SHAPES = [  # (B, Kv, T, Dk, Dv, element size)
    (8, 8, 192, 64, 64, 2),      # the Llama serve path
    (8, 8, 4096, 64, 64, 2),     # a long cache
    (8, 32, 192, 224, 224, 2),   # zamba2's shared attention
    (2, 4, 1024, 224, 224, 4),
    (1, 1, 200, 24, 16, 4),      # Dk != Dv
    (1, 1, 5, 16, 16, 2),        # fewer positions than one tile
    (33, 8, 100, 64, 64, 2),     # B * Kv >= 264
    (3, 2, 65, 128, 64, 4),
]


@pytest.mark.parametrize("B,Kv,T,Dk,Dv,es", PLAN_SHAPES)
def test_decode_plan_tiles_cover_the_cache(B, Kv, T, Dk, Dv, es):
    """The slices [s*chunk, (s+1)*chunk) cut at T are tile-aligned, disjoint
    and non-empty, and cover [0, T) exactly."""
    tile, n_split, chunk = decode_plan(B, Kv, T, Dk, Dv, es)
    assert tile in TILES and chunk % tile == 0 and n_split >= 1
    slices = [(i * chunk, min(T, (i + 1) * chunk)) for i in range(n_split)]
    assert all(a % tile == 0 and a < b for a, b in slices)
    covered = [t for a, b in slices for t in range(a, b)]
    assert covered == list(range(T))
    if B * Kv >= FILL_PAIRS:
        assert n_split == 1
    else:
        assert n_split * B * Kv <= 2 * TARGET_BLOCKS


@pytest.mark.parametrize("B,Kv", [(33, 8), (8, 33), (264, 1), (1, 300)])
def test_decode_plan_one_split_when_the_pairs_fill_the_card(B, Kv):
    for T in (1, 64, 4096, 100_000):
        assert decode_plan(B, Kv, T, 64, 64, 2)[1] == 1


def test_decode_plan_takes_no_tensor_values():
    """The plan is a function of sizes alone: no pos or kv_len reaches it
    (reading them on the host would be a sync in every decode round)."""
    params = list(inspect.signature(decode_plan).parameters)
    assert params == ["n_rows", "n_kv", "t_len", "dk", "dv", "elem_size"]
    plan = decode_plan(8, 8, 4096, 64, 64, 2)
    assert all(type(x) is int for x in plan)
    assert plan == decode_plan(8, 8, 4096, 64, 64, 2)


def _split_combine(q, ck, cv, pos, n_split, *, window=None, kv_len=None,
                   causal=True):
    """Test-side plain emulation of K1's split-KV arithmetic in f32: each
    tile-aligned slice of [0, T) yields a partial (m, l, acc) over its
    reachable keys (an empty slice gives m = -1e30, l = 0, acc = 0); the
    partials are merged in split order with exp(m_s - m*) weights and a
    1e-30 floor on the denominator."""
    B, _, H, Dk = q.shape
    T, Kv, Dv = ck.shape[1], ck.shape[2], cv.shape[-1]
    G = H // Kv
    tile = 16
    chunk = math.ceil(math.ceil(T / n_split) / tile) * tile
    logits = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Kv, G, Dk),
                          ck) / math.sqrt(Dk)
    t = torch.arange(T)
    diff = pos[:, None] - t[None, :]
    ok = torch.ones(B, T, dtype=torch.bool)
    if causal:
        ok &= (diff >= 0) & (diff < (window or T + 1))
    if kv_len is not None:
        ok &= t[None, :] < kv_len[:, None]
    parts = []
    for s in range(n_split):
        in_s = ok & (t[None, :] >= s * chunk) & (t[None, :] < (s + 1) * chunk)
        msk = in_s[:, None, None, :]
        lg = torch.where(msk, logits, -1e30)
        m = lg.amax(-1)
        p = torch.where(msk, torch.exp(lg - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bkgt,btkd->bkgd", p, cv)))
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - m_star)[..., None] * a for m, _, a in parts)
    den = sum(torch.exp(m - m_star) * l for m, l, _ in parts)
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dv)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5])
@pytest.mark.parametrize("case", ["causal", "window", "kv_len"])
def test_split_then_combine_equals_the_plain_version(n_split, case):
    """Split-KV is exact: at every split count, including splits the mask
    leaves empty and a fully masked row, the merged partials equal
    decode_attention_ref."""
    B, H, Kv, Dk, Dv, T = 4, 8, 2, 24, 16, 80
    q, ck, cv = (_t(x, "float32") for x in _inputs(
        12, (B, 1, H, Dk), (B, T, Kv, Dk), (B, T, Kv, Dv)))
    pos = torch.tensor([79, 40, 3, 60])
    kw = {"causal": dict(), "window": dict(window=20),
          "kv_len": dict(kv_len=torch.tensor([80, 0, 10, 33]),
                         causal=False)}[case]
    if case == "window":
        kw["kv_len"] = torch.tensor([80, 80, 80, 30])  # row 3: none in reach
    got = _split_combine(q, ck, cv, pos, n_split, **kw)
    ref = decode_attention_ref(q, ck, cv, pos, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6,
                               rtol=1e-6)
    if case != "causal":
        empty = 1 if case == "kv_len" else 3
        assert (got[empty] == 0).all() and (ref[empty] == 0).all()


@pytest.mark.parametrize("which", ["decode", "flash"])
def test_no_fallback_off_cpu(which):
    """Only a CPU tensor takes the plain version: any other device goes to
    a kernel or raises — never silently to the plain path."""
    q = torch.zeros((1, 1, 2, 16), device="meta")
    c = torch.zeros((1, 4, 2, 16), device="meta")
    before = (decode_attention.launches, flash_attention.launches)
    with pytest.raises(ValueError, match="no kernel for device"):
        if which == "decode":
            decode_attention(q, c, c, 0)
        else:
            flash_attention(q, c, c)
    assert (decode_attention.launches, flash_attention.launches) == before
