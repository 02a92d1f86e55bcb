"""GQA attention (bias / qk-norm / sliding window / ALiBi) and DeepSeek's
MLA: the counterpart of the reference's ``repro/models/attention.py``.

Compute paths, as in the reference:

* ``dense``  — materialise (S, T) logits when S*T is small;
* ``flash``  — python double loop over (q-chunk, kv-chunk) pairs with an
               online softmax, skipping pairs above the causal diagonal;
* ``decode`` — single-query attention over a KV cache (grouped einsum, no
               KV head expansion).

These three are the PLAIN path.  The reference's ``_use_pallas_*``
predicates become device dispatch under ``backend="kernel"``: a CUDA tensor
goes to the hand-written kernels (``kernels.flash_attention`` in prefill,
``kernels.decode_attention`` in decode), a CPU tensor to the plain path.
``backend="plain"`` runs the plain path on any device (the oracle).
Cross attention of encoder-decoder stacks (``cross_kv`` in prefill,
``cross=True`` in decode) is non-causal and windowless; its decode masks
each row to its own ``kv_len``, the valid part of a cross cache allocated
longer than the row's encoder output.

Differences from the reference, both from eager PyTorch:

* decode takes a PER-ROW position vector ``pos`` (B,), and cross decode
  a per-row ``kv_len`` (B,): pooled rows are a real batch here, not a
  vmapped batch of one;
* the decode step writes the new token's K/V into the cache IN PLACE, at
  ``pos`` clamped into range like ``dynamic_update_slice`` clamps, and
  only on the rows ``active`` selects (the others keep their old values).

On a device-group slot (``heads=`` the global index of the slot's first
query head) the functions run on the slot's head shard of the params and
return the output projection's partial sum, which the group adds over its
model row (``layers.reduce_model``).  Where query heads shard but KV heads
replicate (their count does not divide the model axis) the slot holds
every KV head and attends its query heads over the KV heads they map to
by their global indices; MLA's latent cache has no head axis.

Where the query heads do not divide the model axis the reference's rules
take the ``head_dim`` fallback and, at a train or prefill shape,
``attn_seq_q``: :func:`gqa_full_split_group` projects each slot's
head_dim columns, moves q to the slot's query rows with the whole
head_dim (an all-to-all over the model row), gathers K/V and the QK-norm
scales whole (the norm spans the head), attends the slot's rows — K2 at
``q_start`` = prefix + its first row — and moves the output back to its
columns for its ``wo`` rows, whose partial sums the model row adds.
Decode gathers q / k / v whole and attends every head
(:func:`gqa_decode_group`).

Where the reference's rules shard the cache time axis (over ``model`` where
KV heads replicate, and for MLA latents; over ``data`` too where the pool
rows do not split over it), each slot holds a time shard of the cache
(``GroupCtx.time_block``) and :func:`gqa_decode_group` /
:func:`mla_decode_group` attend in three steps: K1's split partials over
the slot's shard (``decode_attention_partials``, masks at the shard's
global positions) for every query head, gathered over the model row,
where the shard holds every KV head (or for the slot's own heads where it
holds their KV heads' block), and the partials of the slot's heads merged
over its time row in time order (``GroupCtx.merge_partials``); the new
token is written by the slot that owns its position only.  Prefill reads
the prefix gathered from the time shards (``layers.gather_time``) and
runs K2 on the slot's heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import (decode_attention, decode_attention_partials,
                                 flash_attention)
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_partials_ref
from repro_torch.kernels.runtime import NO_WINDOW, use_kernel
from repro_torch.models.layers import (ParamBuilder, alibi_slopes,
                                       apply_rope, cfg_rope_angles,
                                       exchange_model, gather_model,
                                       param_dtype, rms_norm_simple,
                                       rope_angles, yarn_mscale)

_NEG_INF = -1e30
_BIG_WINDOW = NO_WINDOW
Q_CHUNK = 2048
KV_CHUNK = 1024
DENSE_MAX_T = 2048  # use the dense path when kv length <= this


# ---------------------------------------------------------------------------
# Mask / bias
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, kv_pos, window, slopes=None, causal=True):
    """Additive f32 bias (H|1, S, T): causal + sliding window + ALiBi
    (non-causal: ALiBi only)."""
    diff = q_pos[:, None] - kv_pos[None, :]  # (S, T); >= 0: past/self
    if causal:
        ok = (diff >= 0) & (diff < window)
    else:
        ok = torch.ones_like(diff, dtype=torch.bool)
    bias = torch.where(ok, 0.0, _NEG_INF).to(torch.float32)[None]
    if slopes is not None:
        bias = bias + slopes[:, None, None] * (-diff.abs())[None].float()
    return bias


# ---------------------------------------------------------------------------
# Plain softmax attention on (B, S, H, D) with expanded KV heads
# ---------------------------------------------------------------------------


def _dense_attn(q, k, v, bias):
    """q (B,S,H,D), k (B,T,H,D), v (B,T,H,Dv), bias (H|1,S,T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    logits = logits * scale + bias[None]
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def _flash_attn(q, k, v, q_pos, kv_pos, window, slopes=None, q_start=0,
                causal=True):
    """Double-chunked online-softmax attention; causal (q-chunk, kv-chunk)
    pairs above the diagonal are skipped (queries at ``q_start +
    arange(S)`` over keys ``arange(T)``)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(D)
    n_q = (S + Q_CHUNK - 1) // Q_CHUNK
    n_kv = (T + KV_CHUNK - 1) // KV_CHUNK
    outs = []
    for qi in range(n_q):
        q_lo, q_hi = qi * Q_CHUNK, min(S, (qi + 1) * Q_CHUNK)
        qc = q[:, q_lo:q_hi]
        qp = q_pos[q_lo:q_hi]
        m = torch.full((B, H, q_hi - q_lo), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q_hi - q_lo), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, q_hi - q_lo, H, Dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(n_kv):
            k_lo, k_hi = ki * KV_CHUNK, min(T, (ki + 1) * KV_CHUNK)
            if causal and k_lo > q_start + q_hi - 1:
                continue  # above the causal diagonal
            kc, vc = k[:, k_lo:k_hi], v[:, k_lo:k_hi]
            kp = kv_pos[k_lo:k_hi]
            logits = torch.einsum("bshd,bthd->bhst", qc.float(),
                                  kc.float()) * scale
            logits = logits + _mask_bias(qp, kp, window, slopes,
                                         causal)[None]
            new_m = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhst,bthd->bshd", p.to(v.dtype), vc).float()
            m = new_m
        out = acc / l.transpose(1, 2)[..., None].clamp_min(1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention_core(q, k, v, q_pos, kv_pos, window=None, slopes=None,
                   causal=True, q_start=0):
    """Plain prefill attention (causal, or non-causal for the encoder and
    cross attention): dense vs flash from the shapes."""
    window = _BIG_WINDOW if window is None else window
    S, T = q.shape[1], k.shape[1]
    if T <= DENSE_MAX_T and S * T <= DENSE_MAX_T * DENSE_MAX_T // 4:
        return _dense_attn(q, k, v, _mask_bias(q_pos, kv_pos, window,
                                               slopes, causal))
    return _flash_attn(q, k, v, q_pos, kv_pos, window, slopes, q_start,
                       causal)


def decode_attention_plain(q, ck, cv, pos, window=None, slopes=None,
                           causal=True, kv_len=None):
    """Plain single-step attention over a cache without KV-head expansion
    (the reference's ``decode_attention_xla``, with per-row positions).
    q (B,1,H,D); ck (B,T,Kv,D); cv (B,T,Kv,Dv); pos (B,).  ``kv_len``
    (B,): valid cache positions per row (cross attention over a cache
    allocated longer than the encoder output)."""
    B, _, H, D = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    G = H // Kv
    window = _BIG_WINDOW if window is None else window
    qg = q.reshape(B, Kv, G, D)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) * scale
    kv_pos = torch.arange(T, device=q.device)
    diff = pos.reshape(B, 1) - kv_pos[None, :]  # (B, T)
    if causal:
        ok = (diff >= 0) & (diff < window)
    else:
        ok = torch.ones_like(diff, dtype=torch.bool)
    if kv_len is not None:
        ok = ok & (kv_pos[None, :] < kv_len.reshape(-1, 1))
    if slopes is not None:
        logits = logits + (slopes.reshape(Kv, G)[None, :, :, None]
                           * (-diff.abs()).float()[:, None, None, :])
    logits = torch.where(ok[:, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(cv.dtype), cv)
    return out.reshape(B, 1, H, cv.shape[-1])


# ---------------------------------------------------------------------------
# GQA attention module
# ---------------------------------------------------------------------------


def init_gqa(pb: ParamBuilder, cfg: ModelConfig, width: Optional[int] = None):
    d = width or cfg.d_model
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = param_dtype(cfg)
    c = pb.child()
    c.dense("wq", (d, H, hd), dt)
    c.dense("wk", (d, Kv, hd), dt)
    c.dense("wv", (d, Kv, hd), dt)
    c.dense("wo", (H, hd, cfg.d_model), dt)
    if cfg.qkv_bias:
        c.zeros("bq", (H, hd), dt)
        c.zeros("bk", (Kv, hd), dt)
        c.zeros("bv", (Kv, hd), dt)
    if cfg.qk_norm:
        c.ones("q_norm", (hd,), torch.float32)
        c.ones("k_norm", (hd,), torch.float32)
    return c.params


def _q_proj(params, cfg, x):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    return q


def _kv_proj(params, cfg, x):
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return k, v


def _slopes(cfg: ModelConfig, device, heads=None, n_local=None):
    """ALiBi slopes of the query heads [heads, heads + n_local) (all heads
    without ``heads``), or None."""
    if cfg.pos_kind != "alibi":
        return None
    sl = alibi_slopes(cfg.n_heads, device)
    return sl if heads is None else sl[heads:heads + n_local]


def kv_heads_for(cfg: ModelConfig, heads: Optional[int], n_local: int,
                 n_kv: int):
    """The KV heads [lo, hi) that query heads [heads, heads + n_local)
    attend, for a cache holding ``n_kv`` heads.  A shard of the KV heads
    (n_kv < cfg.n_kv_heads) lines up with the query shard; replicated KV
    heads are selected by the query heads' global indices.  ``ValueError``
    when those map unevenly (GQA groups cut by the shard)."""
    if heads is None or n_kv < cfg.n_kv_heads or n_local == cfg.n_heads:
        return 0, n_kv
    G = cfg.n_heads // cfg.n_kv_heads
    lo, hi = heads // G, (heads + n_local - 1) // G + 1
    if not ((heads % G == 0 and n_local % G == 0) or hi - lo == 1):
        raise ValueError(
            f"query heads [{heads}, {heads + n_local}) cut the GQA groups "
            f"of {G} heads: no whole KV heads to attend on this slot")
    return lo, hi


def gqa_encoder_kv(params, cfg: ModelConfig, enc_h):
    """Cross-attention K/V (B,S_enc,Kv,hd) from encoder states (computed
    once per session)."""
    return _kv_proj(params, cfg, enc_h)


def _kv_slice(cfg: ModelConfig, heads, n_local: int, k, v):
    """``k``/``v`` restricted to the KV heads of ``kv_heads_for`` (the
    tensors themselves when that is all of them)."""
    lo, hi = kv_heads_for(cfg, heads, n_local, k.shape[2])
    if (lo, hi) == (0, k.shape[2]):
        return k, v
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _attend_full(cfg: ModelConfig, q, k, v, positions, kv_pos, window,
                 slopes, causal, q_start, backend):
    """Prefill attention core: K2 on a CUDA tensor under the kernel
    backend, else the plain path over KV heads expanded to the query
    heads."""
    if use_kernel(backend, q):
        # kernel contract: queries at q_start + arange(S) over keys at
        # arange(T) — what the (chunked-)prefill call sites pass; GQA
        # groups are mapped inside the kernel (no KV head expansion)
        return flash_attention(q, k, v, causal=causal, window=window,
                               slopes=slopes, q_start=q_start)
    G = q.shape[2] // k.shape[2]
    k_exp = torch.repeat_interleave(k, G, dim=2) if G > 1 else k
    v_exp = torch.repeat_interleave(v, G, dim=2) if G > 1 else v
    return attention_core(q, k_exp, v_exp, positions, kv_pos, window,
                          slopes, causal=causal, q_start=q_start)


def apply_gqa_full(params, cfg: ModelConfig, x, positions, window=None,
                   prefix_kv=None, cross_kv=None, backend: str = "kernel",
                   heads: Optional[int] = None):
    """Full-sequence attention (prefill).  x (B,S,d); positions (S,).

    Returns (out, (k, v)) with k/v in the un-expanded (B,S,Kv,hd) layout
    for caching.  ``prefix_kv``: optional (k, v) of an already-prefilled
    prefix (chunked prefill); the chunk's queries attend over prefix +
    chunk keys, ``positions`` must be ``P + arange(S)``, and the returned
    cache entry holds only the chunk's k/v.  ``cross_kv``: the encoder's
    (k, v) — non-causal cross attention with no window, returning (out,
    None).  ``heads``: a group slot's first query head (the module
    docstring)."""
    q_start = 0
    causal = cross_kv is None
    q = _q_proj(params, cfg, x)
    if causal:
        k, v = _kv_proj(params, cfg, x)
        if cfg.qk_norm:
            q = rms_norm_simple(q, params["q_norm"], cfg.norm_eps)
            k = rms_norm_simple(k, params["k_norm"], cfg.norm_eps)
        if cfg.pos_kind == "rope":
            cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        kv_out = (k, v)
        if prefix_kv is not None:
            pk, pv = prefix_kv
            q_start = pk.shape[1]
            k = torch.cat([pk.to(k.dtype), k], dim=1)
            v = torch.cat([pv.to(v.dtype), v], dim=1)
            kv_pos = torch.arange(k.shape[1], device=x.device)
        else:
            kv_pos = positions
    else:
        k, v = cross_kv
        kv_pos = torch.arange(k.shape[1], device=x.device)
        kv_out = None
    ks, vs = _kv_slice(cfg, heads, q.shape[2], k, v)
    out = _attend_full(cfg, q, ks, vs, positions,
                       kv_pos, window if causal else None,
                       _slopes(cfg, x.device, heads, q.shape[2]), causal,
                       q_start, backend)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, kv_out


def write_token(cache, new, pos, active=None, shard=None):
    """In-place write of one token per row: ``cache[b, pos[b]] = new[b, 0]``
    with ``pos`` clamped into [0, T-1] (``dynamic_update_slice``'s clamp).
    Rows where ``active`` is False keep their old value.  ``shard``: (t0,
    t_len) when ``cache`` is the time shard [t0, t0 + T) of a cache of
    ``t_len`` positions: ``pos`` is clamped into the whole [0, t_len - 1]
    and only the shard that owns it writes."""
    B, T = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    p = pos.to(torch.long)
    if shard is None:
        pc = p.clamp(0, T - 1)
    else:
        t0, t_len = shard
        p = p.clamp(0, t_len - 1)
        own = (p >= t0) & (p < t0 + T)
        active = own if active is None else active & own
        pc = (p - t0).clamp(0, T - 1)
    val = new[:, 0].to(cache.dtype)
    if active is not None:
        mask = active.reshape((B,) + (1,) * (val.dim() - 1))
        val = torch.where(mask, val, cache[rows, pc])
    cache[rows, pc] = val


def _gqa_decode_qkv(params, cfg: ModelConfig, x, pos, cross: bool):
    """The decode step's q (B,1,H,hd), and for self attention its new k/v,
    normed and rotated."""
    q = _q_proj(params, cfg, x)
    k, v = (None, None) if cross else _kv_proj(params, cfg, x)
    return _decode_post(cfg, q, k, v, pos, params.get("q_norm"),
                        params.get("k_norm"))


def _decode_post(cfg: ModelConfig, q, k, v, pos, q_norm, k_norm):
    """QK-norm (over the whole head_dim) and RoPE of a decode step's
    projected q and, for self attention, new k (``k`` None: cross
    attention, whose q is normed and not rotated)."""
    if k is not None:
        if cfg.qk_norm:
            q = rms_norm_simple(q, q_norm, cfg.norm_eps)
            k = rms_norm_simple(k, k_norm, cfg.norm_eps)
        if cfg.pos_kind == "rope":
            cos, sin = rope_angles(pos.reshape(-1, 1), cfg.head_dim,
                                   cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    elif cfg.qk_norm:
        q = rms_norm_simple(q, q_norm, cfg.norm_eps)
    return q, k, v


def _decode_attend(cfg: ModelConfig, q, cache_k, cache_v, pos, window, cross,
                   kv_len, backend: str, heads=None):
    """Single-query attention of ``q``'s heads (from ``heads``) over the
    cache's KV heads they map to: K1 on a CUDA tensor under the kernel
    backend, else the plain path."""
    slopes = _slopes(cfg, q.device, heads, q.shape[2])
    win = None if cross else window
    ck, cv = _kv_slice(cfg, heads, q.shape[2], cache_k, cache_v)
    if use_kernel(backend, q):
        return decode_attention(q, ck, cv, pos, window=win, slopes=slopes,
                                kv_len=kv_len, causal=not cross)
    return decode_attention_plain(q, ck, cv, pos, win, slopes,
                                  causal=not cross, kv_len=kv_len)


def apply_gqa_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     window=None, active=None, cross: bool = False,
                     kv_len=None, backend: str = "kernel",
                     heads: Optional[int] = None):
    """Single-token decode.  x (B,1,d); cache (B,T,Kv,hd); pos (B,).

    Self attention writes the new token's K/V into the cache at ``pos``
    (in place; only on ``active`` rows when given) and attends over the
    updated cache.  Cross attention (``cross=True``) attends, non-causal
    and without a window, over the encoder's K/V, which stay unchanged;
    ``kv_len`` (B,) masks positions at or past each row's encoder length
    (a cache allocated longer than the encoder output).  ``heads``: a
    group slot's first query head (the module docstring).  Returns (y,
    cache_k, cache_v) — the same cache tensors."""
    q, k, v = _gqa_decode_qkv(params, cfg, x, pos, cross)
    if not cross:
        write_token(cache_k, k, pos, active)
        write_token(cache_v, v, pos, active)
    out = _decode_attend(cfg, q, cache_k, cache_v, pos, window, cross,
                         kv_len, backend, heads)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA attention module (DeepSeek-V2)
# ---------------------------------------------------------------------------
#
# The serving caches hold each MLA layer as ONE (…, T, lora + rope) buffer
# whose first ``lora`` columns are the ``latent`` leaf and the rest the
# ``krope`` leaf (two views): absorbed decode then hands K1 the whole row
# as the key and the ``latent`` view as the value, through strides, with
# no per-step concatenation of the cache.


def init_mla(pb: ParamBuilder, cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    nope, rope = cfg.head_dim, cfg.rope_head_dim
    lora, qlora = cfg.kv_lora_rank, cfg.q_lora_rank
    dt = param_dtype(cfg)
    c = pb.child()
    c.dense("wdq", (d, qlora), dt)
    c.ones("q_norm", (qlora,), torch.float32)
    c.dense("wuq", (qlora, H, nope + rope), dt)
    c.dense("wdkv", (d, lora + rope), dt)
    c.ones("kv_norm", (lora,), torch.float32)
    c.dense("wuk", (lora, H, nope), dt)
    c.dense("wuv", (lora, H, nope), dt)
    c.dense("wo", (H, nope, d), dt)
    return c.params


def mla_cache_views(buf, lora: int):
    """The ``latent`` / ``krope`` leaves of one joint MLA cache buffer."""
    return {"latent": buf[..., :lora], "krope": buf[..., lora:]}


def mla_keys(latent, krope):
    """The (…, T, lora + rope) key rows of an MLA cache, as a view of the
    joint buffer whose two column blocks ``latent`` and ``krope`` are
    (``mla_cache_views``); ``ValueError`` for separate leaves (a copy of
    the cache in every decode step)."""
    lora, width = latent.shape[-1], latent.shape[-1] + krope.shape[-1]
    joint = (latent.shape[:-1] == krope.shape[:-1]
             and latent.stride()[:-1] == krope.stride()[:-1]
             and latent.stride(-1) == 1 and krope.stride(-1) == 1
             and latent.stride(-2) >= width
             and latent.untyped_storage().data_ptr()
             == krope.untyped_storage().data_ptr()
             and krope.data_ptr() == latent.data_ptr()
             + lora * latent.element_size())
    if not joint:
        raise ValueError("MLA cache leaves must be the latent/krope views "
                         "of one (..., T, lora + rope) buffer "
                         "(attention.mla_cache_views)")
    return latent.as_strided(latent.shape[:-1] + (width,), latent.stride())


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale: ``(nope + rope)^-1/2``, times ``mscale(factor,
    yarn_mscale_all_dim)^2`` under YaRN (DeepSeek-V2's
    ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def _mla_q(params, cfg: ModelConfig, x, positions):
    nope, rope = cfg.head_dim, cfg.rope_head_dim
    cq = x @ params["wdq"].to(x.dtype)
    cq = rms_norm_simple(cq, params["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsq,qhk->bshk", cq, params["wuq"].to(x.dtype))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = cfg_rope_angles(cfg, positions, rope)
    return q_nope, apply_rope(q_rope, cos, sin)


def mla_latent(params, cfg: ModelConfig, x, positions):
    """Down-project to the cached representation: latent (B,S,lora) and
    k_rope (B,S,rope)."""
    lora, rope = cfg.kv_lora_rank, cfg.rope_head_dim
    ckv = x @ params["wdkv"].to(x.dtype)
    latent = rms_norm_simple(ckv[..., :lora], params["kv_norm"],
                             cfg.norm_eps)
    cos, sin = cfg_rope_angles(cfg, positions, rope)
    k_rope = apply_rope(ckv[..., lora:][:, :, None, :], cos, sin)[:, :, 0]
    return latent, k_rope


def apply_mla_full(params, cfg: ModelConfig, x, positions, prefix_kv=None,
                   backend: str = "kernel"):
    """Full-sequence MLA, unabsorbed (prefill).  Returns (out, (latent,
    k_rope)) of the chunk for caching.  ``prefix_kv``: optional (latent,
    k_rope) of an already-prefilled prefix; they are up-projected with the
    chunk's and the chunk's queries attend over both.  On the kernel K2
    runs the per-head attention with Kv = H and (Dk, Dv) = (nope + rope,
    nope); its default 1/sqrt(Dk) is the faithful scale, which YaRN
    multiplies (:func:`mla_softmax_scale`: K2's ``scale``, the plain
    path's query scaled by the ratio)."""
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    latent, k_rope = mla_latent(params, cfg, x, positions)
    kv_out = (latent, k_rope)
    q_start = 0
    if prefix_kv is not None:
        plat, pkr = prefix_kv
        q_start = plat.shape[1]
        latent = torch.cat([plat.to(latent.dtype), latent], dim=1)
        k_rope = torch.cat([pkr.to(k_rope.dtype), k_rope], dim=1)
        kv_pos = torch.arange(latent.shape[1], device=x.device)
    else:
        kv_pos = positions
    k_nope = torch.einsum("bsl,lhk->bshk", latent, params["wuk"].to(x.dtype))
    v = torch.einsum("bsl,lhk->bshk", latent, params["wuv"].to(x.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    krope_bc = k_rope[:, :, None, :].expand(k_nope.shape[:3]
                                            + (k_rope.shape[-1],))
    k = torch.cat([k_nope, krope_bc], dim=-1)
    scale = mla_softmax_scale(cfg) if cfg.yarn_factor else None
    if use_kernel(backend, x):
        out = flash_attention(q, k, v, causal=True, q_start=q_start,
                              scale=scale)
    else:
        if scale is not None:
            q = q * (scale * math.sqrt(q.shape[-1]))
        out = attention_core(q, k, v, positions, kv_pos, q_start=q_start)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, kv_out


def apply_mla_decode(params, cfg: ModelConfig, x, cache_latent, cache_krope,
                     pos, active=None, backend: str = "kernel"):
    """Absorbed-form MLA decode: attention in latent space, MQA with one
    kv head.  x (B,1,d); cache_latent (B,T,lora); cache_krope (B,T,rope);
    pos (B,).  Writes the new token's latent/k_rope at ``pos`` in place
    (``active`` rows only) and attends.  On the kernel K1 takes the
    faithful 1/sqrt(nope + rope) scale (:func:`mla_softmax_scale`); the
    plain path pre-scales q so the helper's 1/sqrt(lora + rope) lands on
    it, as the reference's XLA branch does.  Returns (y, cache_latent,
    cache_krope)."""
    q_eff, new_latent, new_krope = _mla_decode_q(params, cfg, x, pos)
    write_token(cache_latent, new_latent, pos, active)
    write_token(cache_krope, new_krope, pos, active)
    keys = mla_keys(cache_latent, cache_krope)[:, :, None, :]
    values = cache_latent[:, :, None, :]
    faithful = mla_softmax_scale(cfg)
    if use_kernel(backend, x):
        ctx = decode_attention(q_eff, keys, values, pos, scale=faithful)
    else:
        scale_fix = math.sqrt(q_eff.shape[-1]) * faithful
        ctx = decode_attention_plain(q_eff * scale_fix, keys, values, pos)
    return _mla_out(params, x, ctx), cache_latent, cache_krope


def _mla_decode_q(params, cfg: ModelConfig, x, pos):
    """Absorbed MLA decode's (q_eff (B,1,H,lora+rope), new latent, new
    k_rope)."""
    posv = pos.reshape(-1, 1)
    q_nope, q_rope = _mla_q(params, cfg, x, posv)
    new_latent, new_krope = mla_latent(params, cfg, x, posv)
    # absorb W_uk into the query: q_lat[h] = q_nope[h] @ W_uk[:, h, :]^T
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope,
                         params["wuk"].to(x.dtype))
    return torch.cat([q_lat, q_rope], dim=-1), new_latent, new_krope


def _mla_out(params, x, ctx):
    """``wuv`` then ``wo`` on the attention's latent output."""
    v_heads = torch.einsum("bshl,lhk->bshk", ctx, params["wuv"].to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", v_heads, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode on a device group whose slots hold time shards of the cache
# ---------------------------------------------------------------------------


def _shards(ctxs, caches, name: str):
    """Per slot: (t0, t_len) of its time shard of the cache leaf ``name``
    (``caches``: the slots' leaves), or None when each slot holds the whole
    axis."""
    out = []
    for c, x in zip(ctxs, caches):
        b, n = c.time_block(name)
        if n == 1:
            return None
        out.append((b * x.shape[1], n * x.shape[1]))
    return out


def _partials_merged(ctxs, qs, ks, vs, poss, shards, heads, backend, name,
                     every: bool, slopes=None, *, window=None, kv_lens,
                     causal=True, scale=None):
    """Per slot: attention of its query heads (``qs``, from ``heads``) over
    the whole cache: K1's partials over each slot's shard of leaf
    ``name``, and the partials of the slot's heads from its ``time_row``
    merged in time order.  ``every``: each shard holds every KV head (they
    replicate; MLA's latent), and a slot computes the partials of every
    query head, gathered over the model row (held whole already where the
    slot's ``heads`` entry is None); else it holds its own KV heads' block
    and computes its own heads'.  ``slopes``: ALiBi's (H,)
    slopes or None."""
    q_all = gather_model(ctxs, qs, dim=2) \
        if every and heads[0] is not None else qs
    kernel = use_kernel(backend, qs[0])
    run = decode_attention_partials if kernel \
        else decode_attention_partials_ref
    parts = []
    for c, q, ck, cv, pos, kvl, sh, h, q_own in zip(
            ctxs, q_all, ks, vs, poss, kv_lens, shards, heads, qs):
        sl = slopes if slopes is None or every else \
            slopes[h or 0:(h or 0) + q_own.shape[2]]
        b, n = c.time_block(name)
        w = ck.shape[1]

        def part(i, q, ck, cv, pos=pos, sl=sl, kvl=kvl, w=w):
            return run(q, ck, cv, pos, t0=i * w, window=window, slopes=sl,
                       kv_len=kvl, causal=causal, scale=scale)

        # the reached keys (and so the work) differ by shard: a stand-in
        # slot counts every shard's call
        parts.append(_slots_mean(c, n, b, part, q, ck, cv))
    return [c.merge_partials(c.peers(parts, c.time_row(name)),
                             lo, lo + q.shape[2], q.dtype, kernel)
            for c, q, lo in zip(ctxs, qs, ((h or 0) if every else 0
                                           for h in heads))]


# ---------------------------------------------------------------------------
# The head_dim fallback and sequence-parallel attention on a device group
# ---------------------------------------------------------------------------


def head_dim_blocks(cfg: ModelConfig, params) -> int:
    """The blocks of ``head_dim`` whose one a slot's GQA weights hold: the
    model extent under the reference's ``head_dim`` fallback (query heads
    that do not divide the model axis), else 1."""
    return cfg.head_dim // params["wq"].shape[-1]


def gqa_split(cfg: ModelConfig, aps, ctxs) -> bool:
    """True where a group's full-sequence GQA runs
    :func:`gqa_full_split_group`: its slots hold ``head_dim`` columns of
    the weights, or attend a block of the query rows (``attn_seq_q``)."""
    return head_dim_blocks(cfg, aps[0]) > 1 or ctxs[0].q_rows[1] > 1


def _whole_hd(ctxs, parts, n_hd: int, dim: int = -1):
    """Per slot: its ``head_dim`` columns ``parts`` (1 of ``n_hd`` blocks)
    gathered over the model row into the whole head_dim."""
    return parts if n_hd == 1 else gather_model(ctxs, parts, dim)


def _qk_norms(ps, cfg: ModelConfig, ctxs, n_hd: int):
    """Per slot: the whole QK-norm scales (q_norm, k_norm) — gathered over
    the model row where they split on ``head_dim``: the RMS norm spans
    the whole head — or (None, None) without QK-norm."""
    if not cfg.qk_norm:
        return [(None, None)] * len(ps)
    return list(zip(_whole_hd(ctxs, [p["q_norm"] for p in ps], n_hd, 0),
                    _whole_hd(ctxs, [p["k_norm"] for p in ps], n_hd, 0)))


def _hd_cols(c, out, n_hd: int):
    """The slot's ``head_dim`` columns of an attention output (B,S,H,hd)
    that holds every column (its ``wo`` rows' input)."""
    if n_hd == 1:
        return out
    w = out.shape[-1] // n_hd
    return out.narrow(3, c.j * w, w)


def _slots_mean(c, n: int, own: int, run, *xs):
    """``run(own, *xs)``: a slot's variant ``own`` of a computation whose
    work differs by slot (``n`` variants: its block of the query rows, or of
    a cache's time shards).  A slot standing in for its group
    (``GroupCtx.stand_in``, the dry run) runs every variant, each counted
    at 1/n (``launch.costs.counted_at``), so that its count is the slots'
    mean — the per-slot figure of a group whose slots do the same work
    in total, as the reference's per-device count of one SPMD program
    is, not its slowest slot's.  It keeps its own variant's result; under
    autograd every variant's backward runs too, at 1/n, and only its own
    passes gradients on (:class:`_Weight`)."""
    if not c.stand_in or n == 1:
        return run(own, *xs)
    from repro_torch.launch.costs import counted_at

    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        with counted_at(1.0 / n):
            return [run(i, *xs) for i in range(n)][own]
    outs = []
    for i in range(n):
        box = {"keep": i == own}
        with counted_at(1.0 / n):
            ins = _Weight.apply(box, None, *xs)
            outs.append(_Weight.apply(box, 1.0 / n, run(i, *ins))[0])
    return _Join.apply(own, *outs)


class _Weight(torch.autograd.Function):
    """Identity marks around one variant of :func:`_slots_mean` on a
    stand-in slot, for its backward's count: the mark on the variant's
    output (``scale``) scales the counting weight, the mark on its inputs
    (``scale`` None) restores it and passes gradients on only for the
    slot's own variant (``box["keep"]``).  The engine runs a graph's
    nodes in reverse creation order on one device, so the variant's
    backward lies between the two."""

    @staticmethod
    def forward(ctx, box, scale, *xs):
        ctx.box, ctx.scale = box, scale
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.launch.costs import set_count_weight

        box = ctx.box
        if ctx.scale is not None:
            box["old"] = set_count_weight(None, ctx.scale)
            return (None, None) + gs
        set_count_weight(box["old"])
        return (None, None) + (gs if box["keep"] else (None,) * len(gs))


class _Join(torch.autograd.Function):
    """``outs[own]``, its backward sending the gradient to every
    variant's output (so that each variant's backward runs)."""

    @staticmethod
    def forward(ctx, own, *outs):
        ctx.n = len(outs)
        return outs[own].view_as(outs[own])

    @staticmethod
    def backward(ctx, g):
        return (None,) + (g,) * ctx.n


def gqa_encoder_kv_group(ps, cfg: ModelConfig, ctxs, enc_hs):
    """:func:`gqa_encoder_kv` on a group: each slot's cross (k, v) of its
    KV heads (or of every head, gathered whole over the model row from
    the slots' ``head_dim`` columns under the fallback)."""
    n_hd = head_dim_blocks(cfg, ps[0])
    kvs = [gqa_encoder_kv(p, cfg, e) for p, e in zip(ps, enc_hs)]
    return list(zip(_whole_hd(ctxs, [k for k, _ in kvs], n_hd),
                    _whole_hd(ctxs, [v for _, v in kvs], n_hd)))


def gqa_full_split_group(ps, cfg: ModelConfig, ctxs, xs, poss, window=None,
                         prefixes=None, cross_kvs=None, encoder=False,
                         backend: str = "kernel"):
    """Full-sequence GQA on a group whose slots hold ``head_dim`` columns
    of the weights (the reference's fallback where the query heads do not
    divide the model axis) or attend their ``q_rows`` block of the
    queries (``attn_seq_q``, sequence-parallel attention).

    Each slot projects its columns; q moves to the layout the rules name —
    the slot's query rows with the whole head_dim (an all-to-all over the
    model row; its own rows of a whole q where the weights do not split)
    — and K/V and the QK-norm scales are gathered whole (``kv_heads_act``
    replicates them).  The slot attends its rows over the keys they
    reach — K2 at ``q_start`` = prefix + its first row, or the plain path
    skipping the chunks above the diagonal — and its output moves back
    to its head_dim columns for its ``wo`` rows.  The causal work so
    differs by row block: a slot standing in for its group counts every
    block's at 1/n (:func:`_slots_mean`).  ``encoder``: the encoder's
    bidirectional self attention (RoPE, no QK-norm); ``cross_kvs``:
    per-slot whole cross (k, v), non-causal (no QK-norm or RoPE, as
    :func:`apply_gqa_full`).
    Returns (per-slot outputs — partial sums over the model row where the
    weights split, else whole; per-slot whole chunk (k, v), None for the
    non-causal forms)."""
    n = len(ctxs)
    n_hd = head_dim_blocks(cfg, ps[0])
    cols = 3 if n_hd > 1 else None
    rows = 1 if ctxs[0].q_rows[1] > 1 else None
    causal = cross_kvs is None and not encoder
    prefixes = prefixes or [None] * n
    qs = exchange_model(ctxs, [_q_proj(p, cfg, x) for p, x in zip(ps, xs)],
                        cols, rows)
    if cross_kvs is None:
        kvs = [_kv_proj(p, cfg, x) for p, x in zip(ps, xs)]
        cross_kvs = list(zip(_whole_hd(ctxs, [k for k, _ in kvs], n_hd),
                             _whole_hd(ctxs, [v for _, v in kvs], n_hd)))
    norms = _qk_norms(ps, cfg, ctxs, n_hd) if causal else [(None, None)] * n
    slopes = None if encoder else _slopes(cfg, xs[0].device)
    outs, kv_out = [], []
    for c, q, (k, v), positions, pre, (qn, kn) in zip(
            ctxs, qs, cross_kvs, poss, prefixes, norms):
        b, nq = c.q_rows
        w = positions.shape[0] // nq
        lo = b * w
        q_pos = positions[lo:lo + w]
        if causal and cfg.qk_norm:
            q = rms_norm_simple(q, qn, cfg.norm_eps)
            k = rms_norm_simple(k, kn, cfg.norm_eps)
        if (causal or encoder) and cfg.pos_kind == "rope":
            cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            q = apply_rope(q, cos[lo:lo + w], sin[lo:lo + w])
            k = apply_rope(k, cos, sin)
        P = 0
        if causal:
            kv_out.append((k, v))
            if pre is not None:
                P = pre[0].shape[1]
                k = torch.cat([pre[0].to(k.dtype), k], dim=1)
                v = torch.cat([pre[1].to(v.dtype), v], dim=1)
            kv_pos = torch.arange(k.shape[1], device=q.device)
        else:
            kv_out.append(None)
            kv_pos = positions if encoder else torch.arange(
                k.shape[1], device=q.device)

        def attend(i, q, k, v, P=P, kv_pos=kv_pos):
            return _attend_full(
                cfg, q, k, v, positions[i * w:(i + 1) * w], kv_pos,
                window if causal else None, slopes, causal,
                P + i * w if causal else 0, backend)

        outs.append(_slots_mean(c, nq, b, attend, q, k, v) if causal
                    else attend(b, q, k, v))
    outs = exchange_model(ctxs, outs, rows, cols)
    return ([torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
             for o, p, x in zip(outs, ps, xs)], kv_out)


def gqa_decode_group(ps, cfg: ModelConfig, ctxs, xs, ks, vs, poss,
                     window=None, actives=None, cross: bool = False,
                     kv_lens=None, backend: str = "kernel", heads=None):
    """:func:`apply_gqa_decode` on a group's slots (per-slot lists; the
    caches written in place), returning each slot's output projection
    partial sum.  ``heads``: each slot's first query head (None: all)."""
    n = len(ctxs)
    actives = actives or [None] * n
    kv_lens = kv_lens or [None] * n
    heads = heads or [None] * n
    n_hd = head_dim_blocks(cfg, ps[0])
    if n_hd == 1:
        qkvs = [_gqa_decode_qkv(p, cfg, x, pos, cross)
                for p, x, pos in zip(ps, xs, poss)]
    else:  # the head_dim fallback: q and the new k/v gathered whole
        qs = _whole_hd(ctxs, [_q_proj(p, cfg, x) for p, x in zip(ps, xs)],
                       n_hd)
        kvs = [(None, None)] * n if cross else [
            _kv_proj(p, cfg, x) for p, x in zip(ps, xs)]
        if not cross:
            kvs = list(zip(_whole_hd(ctxs, [k for k, _ in kvs], n_hd),
                           _whole_hd(ctxs, [v for _, v in kvs], n_hd)))
        qkvs = [_decode_post(cfg, q, k, v, pos, qn, kn)
                for q, (k, v), pos, (qn, kn) in zip(
                    qs, kvs, poss, _qk_norms(ps, cfg, ctxs, n_hd))]
    shards = _shards(ctxs, ks, "ck" if cross else "k")
    if not cross:
        for (_, k, v), ck, cv, pos, act, sh in zip(
                qkvs, ks, vs, poss, actives, shards or [None] * n):
            write_token(ck, k, pos, act, sh)
            write_token(cv, v, pos, act, sh)
    qs = [q for q, _, _ in qkvs]
    if shards is None:
        outs = [_decode_attend(cfg, q, ck, cv, pos, window, cross, kvl,
                               backend, h)
                for q, ck, cv, pos, kvl, h in zip(qs, ks, vs, poss, kv_lens,
                                                  heads)]
    else:
        outs = _partials_merged(
            ctxs, qs, ks, vs, poss, shards, heads, backend,
            "ck" if cross else "k", ks[0].shape[2] == cfg.n_kv_heads,
            _slopes(cfg, xs[0].device), window=None if cross else window,
            kv_lens=kv_lens, causal=not cross)
    return [torch.einsum("bshk,hkd->bsd", _hd_cols(c, o, n_hd),
                         p["wo"].to(x.dtype))
            for c, o, p, x in zip(ctxs, outs, ps, xs)]


def mla_decode_group(ps, cfg: ModelConfig, ctxs, xs, lats, krs, poss,
                     actives=None, backend: str = "kernel", heads=None):
    """:func:`apply_mla_decode` on a group's slots (per-slot lists; the
    latent caches written in place), returning each slot's output
    projection partial sum."""
    n = len(ctxs)
    actives = actives or [None] * n
    shards = _shards(ctxs, lats, "latent")
    if shards is None:
        return [apply_mla_decode(p, cfg, x, lat, kr, pos, act, backend)[0]
                for p, x, lat, kr, pos, act in zip(ps, xs, lats, krs, poss,
                                                    actives)]
    qs = []
    for p, x, lat, kr, pos, act, sh in zip(ps, xs, lats, krs, poss,
                                           actives, shards):
        q_eff, new_latent, new_krope = _mla_decode_q(p, cfg, x, pos)
        write_token(lat, new_latent, pos, act, sh)
        write_token(kr, new_krope, pos, act, sh)
        qs.append(q_eff)
    keys = [mla_keys(lat, kr)[:, :, None, :] for lat, kr in zip(lats, krs)]
    values = [lat[:, :, None, :] for lat in lats]
    faithful = mla_softmax_scale(cfg)
    outs = _partials_merged(ctxs, qs, keys, values, poss, shards,
                            heads or [None] * n, backend, "latent", True,
                            scale=faithful, kv_lens=[None] * n)
    return [_mla_out(p, x, o) for p, x, o in zip(ps, xs, outs)]
