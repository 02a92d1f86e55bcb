"""Block functions — the BPRR placement granularity; the counterpart of
the reference's ``repro/models/blocks.py`` for decoders (GQA or MLA
attention, dense or MoE FFN), RWKV6 and Mamba2/zamba2 stacks, and the
encoder and cross-attention decoder blocks of encoder-decoder stacks.

* ``init_<kind>(pb, cfg)``                 -> params
* ``<kind>_full(params, cfg, h, ...)``     -> (h, state / cache entry)
* ``<kind>_decode(params, cfg, h, state, ...)`` -> (h, state / cache)

The attention decode functions update their KV (or MLA latent) cache in
place (see ``attention``); the recurrent decode functions return new state
tensors, which the caller writes into its pool.  ``moe_rows=True`` routes
each batch row through the MoE alone (the engine's pooled steps, where the
reference vmaps its rows).

``decoder_block_{full,decode}_group`` run a decoder block on the slots of
a device group (``layers.GroupCtx``): the per-slot tensors and params are
lists in slot order, the slots run the block's halves in lockstep, and the
output projection's and the MLP's partial sums are added over each model
row.  The engine's pooled steps run every decoder block through them, a
solo server on its one ``layers.NULL`` slot; the solo and group blocks
share their attention and residual bodies (``_mixer_*``, ``_residual``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (ParamBuilder, apply_mlp, apply_norm,
                                       apply_rope, gather_model, init_mlp,
                                       init_norm, mlp_group, reduce_model,
                                       rope_angles)

_BIG = 1 << 30


def check_supported(cfg: ModelConfig):
    """``ValueError`` for a config of no known block family."""
    if not cfg.is_enc_dec and \
            cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(f"unknown block family {cfg.family!r} for "
                         f"{cfg.name!r}")


def stack_block_kinds(cfg: ModelConfig):
    """Per-block kind tuple (length ``cfg.n_layers``) in BPRR block order:
    ``decoder`` for dense stacks, ``rwkv`` for RWKV6, for zamba2 ``mamba``
    everywhere except the last block of each shared-attention period,
    ``mamba_shared`` (a mamba mixer followed by the parameter-shared
    attention+MLP block), and ``enc`` then ``dec`` blocks for
    encoder-decoder stacks."""
    check_supported(cfg)
    if cfg.is_enc_dec:
        return ("enc",) * cfg.n_enc_layers + ("dec",) * cfg.n_dec_layers
    if cfg.family == "hybrid":
        period = cfg.shared_attn_period
        n_mega = (cfg.n_layers // period) * period
        return tuple(
            "mamba_shared" if (i < n_mega and i % period == period - 1)
            else "mamba" for i in range(cfg.n_layers))
    if cfg.family == "ssm":
        return ("rwkv",) * cfg.n_layers
    return ("decoder",) * cfg.n_layers


def window_for_layer(cfg: ModelConfig, layer_idx: int):
    """Per-layer sliding window (gemma3's local:global pattern) as a python
    int, or None without a window."""
    if cfg.sliding_window <= 0:
        return None
    if cfg.local_global_period <= 0:
        return cfg.sliding_window
    is_global = (int(layer_idx) + 1) % cfg.local_global_period == 0
    return _BIG if is_global else cfg.sliding_window


def init_decoder_block(pb: ParamBuilder, cfg: ModelConfig):
    check_supported(cfg)
    c = pb.child()
    c.sub("ln1", init_norm, cfg)
    c.sub("attn", attn.init_mla if cfg.attn_kind == "mla" else attn.init_gqa,
          cfg)
    c.sub("ln2", init_norm, cfg)
    c.sub("ffn", moe.init_moe if cfg.is_moe else init_mlp, cfg)
    if cfg.sandwich_norm:
        c.sub("post_ln1", init_norm, cfg)
        c.sub("post_ln2", init_norm, cfg)
    return c.params


def _mixer_full(params, cfg: ModelConfig, x, positions, win, prefix_kv,
                backend: str, heads=None):
    """Attention (GQA or MLA) over a full sequence: (output, cache entry of
    the positions in ``x``).  ``heads``: the global index of the params'
    first query head (a group slot's)."""
    if cfg.attn_kind == "mla":
        a, kv = attn.apply_mla_full(params["attn"], cfg, x, positions,
                                    prefix_kv=prefix_kv, backend=backend)
        return a, {"latent": kv[0], "krope": kv[1]}
    a, kv = attn.apply_gqa_full(params["attn"], cfg, x, positions, win,
                                prefix_kv=prefix_kv, backend=backend,
                                heads=heads)
    return a, {"k": kv[0], "v": kv[1]}


def _mixer_decode(params, cfg: ModelConfig, x, cache, pos, win, active,
                  backend: str, heads=None):
    """Single-token attention; writes the cache in place (``active`` rows
    only).  Returns (output, cache)."""
    if cfg.attn_kind == "mla":
        a, lat, kr = attn.apply_mla_decode(
            params["attn"], cfg, x, cache["latent"], cache["krope"], pos,
            active=active, backend=backend)
        return a, {"latent": lat, "krope": kr}
    a, ck, cv = attn.apply_gqa_decode(params["attn"], cfg, x, cache["k"],
                                      cache["v"], pos, win, active=active,
                                      backend=backend, heads=heads)
    return a, {"k": ck, "v": cv}


def _residual(params, cfg: ModelConfig, h, y, post: str):
    """``h + y``, ``y`` through the sandwich post-norm ``post`` first."""
    if cfg.sandwich_norm:
        y = apply_norm(params[post], cfg, y)
    return h + y


def decoder_block_full(params, cfg: ModelConfig, h, positions, layer_idx=0,
                       prefix_kv=None, backend: str = "kernel",
                       moe_rows: bool = False):
    """Full-sequence decoder block.  Returns (h, cache_entry, aux) — the
    MoE's aux terms, or {} for a dense FFN.

    ``prefix_kv``: optional already-cached prefix for chunked prefill
    covering [0, P) — (k, v) for GQA, (latent, krope) for MLA;
    ``positions`` must then be ``P + arange(S)``.  The returned cache entry
    covers only the positions in ``h``."""
    x = apply_norm(params["ln1"], cfg, h)
    a, cache = _mixer_full(params, cfg, x, positions,
                           window_for_layer(cfg, layer_idx), prefix_kv,
                           backend)
    h, aux = _ffn(params, cfg, _residual(params, cfg, h, a, "post_ln1"),
                  moe_rows)
    return h, cache, aux


def decoder_block_attn_decode(params, cfg: ModelConfig, h, cache, pos,
                              layer_idx=0, active=None,
                              backend: str = "kernel"):
    """Attention half of :func:`decoder_block_decode`: ln1 -> attention ->
    residual.  Writes the cache in place (``active`` rows only)."""
    x = apply_norm(params["ln1"], cfg, h)
    a, cache = _mixer_decode(params, cfg, x, cache, pos,
                             window_for_layer(cfg, layer_idx), active,
                             backend)
    return _residual(params, cfg, h, a, "post_ln1"), cache


def _ffn(params, cfg: ModelConfig, h, moe_rows: bool = False):
    """ln2 -> MLP or MoE -> (sandwich post-norm) -> residual; returns (h,
    aux)."""
    x = apply_norm(params["ln2"], cfg, h)
    aux = {}
    if cfg.is_moe:
        m, aux = moe.apply_moe(params["ffn"], cfg, x, per_row=moe_rows)
    else:
        m = apply_mlp(params["ffn"], cfg, x)
    return _residual(params, cfg, h, m, "post_ln2"), aux


def decoder_block_ffn(params, cfg: ModelConfig, h, moe_rows: bool = False):
    """FFN half: ln2 -> MLP or MoE -> residual (position-free)."""
    return _ffn(params, cfg, h, moe_rows)[0]


def decoder_block_decode(params, cfg: ModelConfig, h, cache, pos,
                         layer_idx=0, active=None, backend: str = "kernel",
                         moe_rows: bool = False):
    """Single-token decoder block.  h (B,1,d); pos (B,).  Returns
    (h, cache) with the cache updated in place."""
    h, cache = decoder_block_attn_decode(params, cfg, h, cache, pos,
                                         layer_idx, active=active,
                                         backend=backend)
    return decoder_block_ffn(params, cfg, h, moe_rows), cache


# ---------------------------------------------------------------------------
# Decoder blocks on a device group
# ---------------------------------------------------------------------------


def _first_head(cfg: ModelConfig, ctx, attn_params) -> int:
    """Global index of a slot's first query head (None when it holds
    all)."""
    n = attn_params["wq" if "wq" in attn_params else "wuq"].shape[-2]
    return None if n == cfg.n_heads else ctx.j * n


def _attn_reduce(ps, cfg: ModelConfig, ctxs, parts):
    """The output projection's partials summed over each model row (heads
    sharded), or the slots' whole outputs."""
    n = ps[0]["attn"]["wo"].shape[0]
    return parts if n == cfg.n_heads else reduce_model(ctxs, parts)


def _ffn_group(ps, cfg: ModelConfig, ctxs, hs, rows_split: bool,
               moe_ep: bool = False):
    """``_ffn`` on a group: ln2 -> MLP (TP) or MoE (per-row, or the pure EP
    all-to-all over a (data, model) token grid when ``moe_ep``) -> residual."""
    xs = [apply_norm(p["ln2"], cfg, h) for p, h in zip(ps, hs)]
    fs = [p["ffn"] for p in ps]
    if not cfg.is_moe:
        ms = mlp_group(fs, cfg, ctxs, xs)
    elif ctxs[0].mesh is None:  # a solo server's one slot
        ms = [moe.apply_moe(fs[0], cfg, xs[0], per_row=True)[0]]
    elif moe_ep:
        # each model slot takes its chunk of the row block's rows
        loc = [x.chunk(c.n_model, dim=0)[c.j] for c, x in zip(ctxs, xs)]
        routed, _ = moe._apply_moe_ep(fs, cfg, ctxs, loc)
        ms = moe._shared_expert_group(fs, cfg, ctxs, xs,
                                      gather_model(ctxs, routed, dim=0))
    else:
        ms = moe.apply_moe_group(fs, cfg, ctxs, xs, rows_split)
    return [_residual(p, cfg, h, m, "post_ln2")
            for p, h, m in zip(ps, hs, ms)]


def decoder_block_full_group(ps, cfg: ModelConfig, ctxs, hs, poss,
                             layer_idx=0, prefixes=None,
                             backend: str = "kernel",
                             rows_split: bool = False):
    """:func:`decoder_block_full` on a group (per-row MoE).  ``poss``:
    per-slot positions; ``prefixes``: per-slot ``prefix_kv`` (or None).
    Returns (per-slot h, per-slot cache entries of the chunk)."""
    win = window_for_layer(cfg, layer_idx)
    prefixes = prefixes or [None] * len(ctxs)
    outs = [_mixer_full(p, cfg, apply_norm(p["ln1"], cfg, h), positions,
                        win, pre, backend, _first_head(cfg, c, p["attn"]))
            for p, c, h, positions, pre in zip(ps, ctxs, hs, poss,
                                                prefixes)]
    a = _attn_reduce(ps, cfg, ctxs, [o[0] for o in outs])
    hs = [_residual(p, cfg, h, y, "post_ln1") for p, h, y in zip(ps, hs, a)]
    return _ffn_group(ps, cfg, ctxs, hs, rows_split), [o[1] for o in outs]


def decoder_block_decode_group(ps, cfg: ModelConfig, ctxs, hs, caches,
                               poss, layer_idx=0, actives=None,
                               backend: str = "kernel",
                               rows_split: bool = False,
                               moe_ep: bool = False):
    """:func:`decoder_block_decode` on a group: per-slot h (B_i, 1, d),
    caches (written in place on the ``actives`` rows), positions.  Returns
    per-slot h."""
    win = window_for_layer(cfg, layer_idx)
    actives = actives or [None] * len(ctxs)
    parts = [_mixer_decode(p, cfg, apply_norm(p["ln1"], cfg, h), cache, pos,
                           win, act, backend,
                           _first_head(cfg, c, p["attn"]))[0]
             for p, c, h, cache, pos, act in zip(ps, ctxs, hs, caches, poss,
                                                 actives)]
    a = _attn_reduce(ps, cfg, ctxs, parts)
    hs = [_residual(p, cfg, h, y, "post_ln1") for p, h, y in zip(ps, hs, a)]
    return _ffn_group(ps, cfg, ctxs, hs, rows_split, moe_ep)


# ---------------------------------------------------------------------------
# Encoder / cross-attention decoder blocks (encoder-decoder stacks)
# ---------------------------------------------------------------------------


def init_encoder_block(pb: ParamBuilder, cfg: ModelConfig):
    c = pb.child()
    c.sub("ln1", init_norm, cfg)
    c.sub("attn", attn.init_gqa, cfg)
    c.sub("ln2", init_norm, cfg)
    c.sub("ffn", init_mlp, cfg)
    return c.params


def encoder_block_full(params, cfg: ModelConfig, h, positions,
                       backend: str = "kernel"):
    """Bidirectional self-attention encoder block over (B, S_enc, d); it
    holds no serving state."""
    x = apply_norm(params["ln1"], cfg, h)
    q = attn._q_proj(params["attn"], cfg, x)
    k, v = attn._kv_proj(params["attn"], cfg, x)
    if cfg.pos_kind == "rope":
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = attn._attend_full(cfg, q, k, v, positions, positions, None, None,
                            False, 0, backend)
    h = h + torch.einsum("bshk,hkd->bsd", out,
                         params["attn"]["wo"].to(x.dtype))
    x = apply_norm(params["ln2"], cfg, h)
    return h + apply_mlp(params["ffn"], cfg, x)


def init_cross_decoder_block(pb: ParamBuilder, cfg: ModelConfig):
    c = pb.child()
    c.sub("ln1", init_norm, cfg)
    c.sub("self_attn", attn.init_gqa, cfg)
    c.sub("ln_cross", init_norm, cfg)
    c.sub("cross_attn", attn.init_gqa, cfg)
    c.sub("ln2", init_norm, cfg)
    c.sub("ffn", init_mlp, cfg)
    return c.params


def cross_decoder_block_full(params, cfg: ModelConfig, h, positions, enc_h,
                             prefix_kv=None, enc_kv=None,
                             backend: str = "kernel"):
    """Decoder block with cross attention.  Returns (h, {"k", "v", "ck",
    "cv"}).  ``prefix_kv``: the cached self-attention (k, v) of [0, P)
    (chunked prefill, as in :func:`decoder_block_full`); ``enc_kv``: the
    already-projected cross (k, v), which skips the projection of
    ``enc_h`` (it does not depend on the chunk, so a chunked prefill
    projects it at offset 0 and reads it back from the pool after)."""
    x = apply_norm(params["ln1"], cfg, h)
    a, kv = attn.apply_gqa_full(params["self_attn"], cfg, x, positions,
                                prefix_kv=prefix_kv, backend=backend)
    h = h + a
    x = apply_norm(params["ln_cross"], cfg, h)
    ck, cv = attn.gqa_encoder_kv(params["cross_attn"], cfg, enc_h) \
        if enc_kv is None else enc_kv
    a, _ = attn.apply_gqa_full(params["cross_attn"], cfg, x, positions,
                               cross_kv=(ck, cv), backend=backend)
    h = h + a
    x = apply_norm(params["ln2"], cfg, h)
    h = h + apply_mlp(params["ffn"], cfg, x)
    return h, {"k": kv[0], "v": kv[1], "ck": ck, "cv": cv}


def cross_decoder_block_decode(params, cfg: ModelConfig, h, cache, pos,
                               enc_len=None, active=None,
                               backend: str = "kernel"):
    """Single-token cross-decoder block: K1 twice, causal self attention
    (the new K/V written in place on ``active`` rows) and non-causal cross
    attention over ``ck``/``cv``.  ``enc_len`` (B,): valid encoder
    positions per row, for cross caches allocated longer than the
    session's encoder output (the pooled steps); None attends over the
    whole cross cache (the monolithic decode).  Returns (h, cache)."""
    x = apply_norm(params["ln1"], cfg, h)
    a, ck, cv = attn.apply_gqa_decode(params["self_attn"], cfg, x,
                                      cache["k"], cache["v"], pos,
                                      active=active, backend=backend)
    h = h + a
    x = apply_norm(params["ln_cross"], cfg, h)
    a, _, _ = attn.apply_gqa_decode(params["cross_attn"], cfg, x,
                                    cache["ck"], cache["cv"], pos,
                                    cross=True, kv_len=enc_len,
                                    backend=backend)
    h = h + a
    x = apply_norm(params["ln2"], cfg, h)
    h = h + apply_mlp(params["ffn"], cfg, x)
    return h, {"k": ck, "v": cv, "ck": cache["ck"], "cv": cache["cv"]}


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------


def init_mamba_block(pb: ParamBuilder, cfg: ModelConfig):
    c = pb.child()
    c.sub("ln", init_norm, cfg)
    c.sub("mixer", ssm.init_mamba, cfg)
    return c.params


def mamba_block_full(params, cfg: ModelConfig, h, backend: str = "kernel"):
    x = apply_norm(params["ln"], cfg, h)
    y, state = ssm.apply_mamba_full(params["mixer"], cfg, x, backend=backend)
    return h + y, state


def mamba_block_decode(params, cfg: ModelConfig, h, state):
    """One token; the step is elementwise and launches no kernel."""
    x = apply_norm(params["ln"], cfg, h)
    y, state = ssm.apply_mamba_decode(params["mixer"], cfg, x, state)
    return h + y, state


# ---------------------------------------------------------------------------
# Zamba2 shared attention block (one set of params for every invocation)
# ---------------------------------------------------------------------------


def init_zamba_shared(pb: ParamBuilder, cfg: ModelConfig):
    """Attention+MLP on concat(hidden, embedding0), width 2*d_model."""
    width = 2 * cfg.d_model
    c = pb.child()
    c.sub("ln1", init_norm, cfg, width)
    c.sub("attn", attn.init_gqa, cfg, width)
    c.sub("ln2", init_norm, cfg, width)
    c.sub("ffn", init_mlp, cfg, width)
    return c.params


def zamba_shared_full(params, cfg: ModelConfig, h, emb0, positions,
                      backend: str = "kernel"):
    """Returns (h, {"k", "v"}) — a KV cache entry per invocation."""
    x = apply_norm(params["ln1"], cfg, torch.cat([h, emb0], dim=-1))
    a, kv = attn.apply_gqa_full(params["attn"], cfg, x, positions,
                                backend=backend)
    h = h + a
    x = apply_norm(params["ln2"], cfg, torch.cat([h, emb0], dim=-1))
    return h + apply_mlp(params["ffn"], cfg, x), {"k": kv[0], "v": kv[1]}


def zamba_shared_decode(params, cfg: ModelConfig, h, emb0, cache, pos,
                        active=None, backend: str = "kernel"):
    """One token; writes K/V into ``cache`` in place at ``pos`` (``active``
    rows only).  Returns (h, cache)."""
    x = apply_norm(params["ln1"], cfg, torch.cat([h, emb0], dim=-1))
    a, ck, cv = attn.apply_gqa_decode(params["attn"], cfg, x, cache["k"],
                                      cache["v"], pos, active=active,
                                      backend=backend)
    h = h + a
    x = apply_norm(params["ln2"], cfg, torch.cat([h, emb0], dim=-1))
    return h + apply_mlp(params["ffn"], cfg, x), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# RWKV6 block
# ---------------------------------------------------------------------------


def init_rwkv_block(pb: ParamBuilder, cfg: ModelConfig):
    c = pb.child()
    c.sub("ln1", init_norm, cfg)
    c.sub("tm", ssm.init_rwkv_tm, cfg)
    c.sub("ln2", init_norm, cfg)
    c.sub("cm", ssm.init_rwkv_cm, cfg)
    return c.params


def rwkv_block_full(params, cfg: ModelConfig, h, backend: str = "kernel"):
    x = apply_norm(params["ln1"], cfg, h)
    y, tm_state = ssm.apply_rwkv_tm_full(params["tm"], cfg, x,
                                         backend=backend)
    h = h + y
    x = apply_norm(params["ln2"], cfg, h)
    y, cm_shift = ssm.apply_rwkv_cm(params["cm"], cfg, x)
    return h + y, {"wkv": tm_state["wkv"], "shift_tm": tm_state["shift"],
                   "shift_cm": cm_shift}


def rwkv_block_decode(params, cfg: ModelConfig, h, state):
    """One token; the step is elementwise and launches no kernel."""
    x = apply_norm(params["ln1"], cfg, h)
    y, tm_state = ssm.apply_rwkv_tm_decode(
        params["tm"], cfg, x, {"wkv": state["wkv"],
                               "shift": state["shift_tm"]})
    h = h + y
    x = apply_norm(params["ln2"], cfg, h)
    y, cm_shift = ssm.apply_rwkv_cm(params["cm"], cfg, x,
                                    shift_state=state["shift_cm"])
    return h + y, {"wkv": tm_state["wkv"], "shift_tm": tm_state["shift"],
                   "shift_cm": cm_shift}
