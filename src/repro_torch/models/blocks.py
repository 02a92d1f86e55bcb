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

``<kind>_{full,decode}_group`` run a block on the slots of a device group
(``layers.GroupCtx``): the per-slot tensors and params are lists in slot
order, the slots run the block's halves in lockstep, and the output
projections' and the MLP's partial sums are added over each model row.
Under ``seq_act`` a block's input and output are each slot's sequence
block of the residual stream: each half's normed input is gathered over
the model row (``_normed``) and its partial sums reduce-scattered back
(``layers.reduce_out``).
Attention on a slot that holds a time shard of its cache merges K1's
partials over the row (``attention.gqa_decode_group``); the recurrent
mixers gather their state heads (``ssm.*_group``).  The engine's pooled
steps run every block kind through them, a solo server on its one
``layers.NULL`` slot.  The solo forms of the encoder, cross-decoder,
Mamba2, zamba2-shared and RWKV6 blocks are their group forms on ``NULL``;
the decoder's keep their own body (the monolithic MoE routes the whole
batch) and share its attention and residual halves (``_mixer_*``,
``_residual``).  The training step runs the same group forms under
autograd on the plain versions (``models.train_loss`` over a group), the
decoder's as :func:`decoder_block_train_group` (the MoE over the whole
batch).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (NULL, ParamBuilder, apply_mlp,
                                       apply_norm, apply_rope, gather_model,
                                       gather_seq, init_mlp, init_norm,
                                       mlp_group, reduce_out, rope_angles,
                                       seq_block)

_BIG = 1 << 30


def check_supported(cfg: ModelConfig):
    """``ValueError`` for a config of no known block family."""
    if not cfg.is_enc_dec and \
            cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(f"unknown block family {cfg.family!r} for "
                         f"{cfg.name!r}")


def stack_block_kinds(cfg: ModelConfig):
    """Per-block kind tuple (length ``cfg.n_layers``) in BPRR block order:
    ``decoder`` for dense stacks (an MoE stack's ``n_dense_layers``
    leading dense blocks ``lead``), ``rwkv`` for RWKV6, for zamba2 ``mamba``
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
    n_lead = cfg.n_dense_layers
    return ("lead",) * n_lead + ("decoder",) * (cfg.n_layers - n_lead)


def resolve_kind(cfg: ModelConfig, kind: str):
    """(config, kind) a block of ``kind`` runs as: a ``lead`` block (a
    leading dense block of an MoE stack) is a ``decoder`` block under
    ``cfg.lead_config()``; every other kind is itself under ``cfg``."""
    return (cfg.lead_config(), "decoder") if kind == "lead" else (cfg, kind)


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
                  moe_rows, backend)
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


def _ffn(params, cfg: ModelConfig, h, moe_rows: bool = False,
         backend: str = "kernel", with_aux: bool = True):
    """ln2 -> MLP or MoE -> (sandwich post-norm) -> residual; returns (h,
    aux)."""
    x = apply_norm(params["ln2"], cfg, h)
    aux = {}
    if cfg.is_moe:
        m, aux = moe.apply_moe(params["ffn"], cfg, x, per_row=moe_rows,
                               backend=backend, with_aux=with_aux)
    else:
        m = apply_mlp(params["ffn"], cfg, x)
    return _residual(params, cfg, h, m, "post_ln2"), aux


def decoder_block_ffn(params, cfg: ModelConfig, h, moe_rows: bool = False,
                      backend: str = "kernel"):
    """FFN half: ln2 -> MLP or MoE -> residual (position-free)."""
    return _ffn(params, cfg, h, moe_rows, backend, with_aux=False)[0]


def decoder_block_decode(params, cfg: ModelConfig, h, cache, pos,
                         layer_idx=0, active=None, backend: str = "kernel",
                         moe_rows: bool = False):
    """Single-token decoder block.  h (B,1,d); pos (B,).  Returns
    (h, cache) with the cache updated in place."""
    h, cache = decoder_block_attn_decode(params, cfg, h, cache, pos,
                                         layer_idx, active=active,
                                         backend=backend)
    return decoder_block_ffn(params, cfg, h, moe_rows, backend), cache


# ---------------------------------------------------------------------------
# Blocks on a device group
# ---------------------------------------------------------------------------


def _first_head(cfg: ModelConfig, ctx, attn_params) -> int:
    """Global index of a slot's first query head (None when it holds
    all)."""
    n = attn_params["wq" if "wq" in attn_params else "wuq"].shape[-2]
    return None if n == cfg.n_heads else ctx.j * n


def _attn_reduce(aps, cfg: ModelConfig, ctxs, parts):
    """The output projection's partials (``aps``: the slots' attention
    params; heads or ``head_dim`` rows of ``wo`` sharded) summed over each
    model row, or the slots' whole outputs — onto the residual stream's
    layout (``layers.reduce_out``)."""
    whole = tuple(aps[0]["wo"].shape[:2]) == (cfg.n_heads, cfg.head_dim)
    return reduce_out(ctxs, parts, not whole)


def _normed(ps, cfg: ModelConfig, ctxs, hs, norm: str, concat=None):
    """``norm(h)`` of each slot's residual block (``concat``: per-slot
    tensors joined to h first, zamba2's embedding), gathered whole over
    the model row under ``seq_act`` — a mixer's or an FFN's input."""
    return gather_seq(ctxs, [
        apply_norm(p[norm], cfg, h if e is None else torch.cat([h, e], -1))
        for p, h, e in zip(ps, hs, concat or [None] * len(hs))])


def _gqa_full_group(aps, cfg: ModelConfig, ctxs, xs, poss, win=None,
                    prefixes=None, cross_kvs=None, backend: str = "kernel"):
    """``apply_gqa_full`` on each slot's heads (or under the ``head_dim``
    fallback / ``attn_seq_q``, ``attention.gqa_full_split_group``),
    reduced over the row: (per-slot output, per-slot chunk (k, v) or
    None)."""
    n = len(ctxs)
    if attn.gqa_split(cfg, aps, ctxs):
        outs, kvs = attn.gqa_full_split_group(aps, cfg, ctxs, xs, poss, win,
                                              prefixes, cross_kvs,
                                              backend=backend)
        return _attn_reduce(aps, cfg, ctxs, outs), kvs
    prefixes = prefixes or [None] * n
    cross_kvs = cross_kvs or [None] * n
    outs = [attn.apply_gqa_full(a, cfg, x, positions, win, prefix_kv=pre,
                                cross_kv=ckv, backend=backend,
                                heads=_first_head(cfg, c, a))
            for a, c, x, positions, pre, ckv in zip(aps, ctxs, xs, poss,
                                                    prefixes, cross_kvs)]
    return (_attn_reduce(aps, cfg, ctxs, [o[0] for o in outs]),
            [o[1] for o in outs])


def _attn_decode_group(aps, cfg: ModelConfig, ctxs, xs, ks, vs, poss,
                       win=None, actives=None, backend: str = "kernel",
                       cross: bool = False, kv_lens=None):
    """Single-token GQA attention of each slot's heads (the caches ``ks``
    / ``vs`` written in place on self attention), reduced over the row."""
    heads = [_first_head(cfg, c, a) for c, a in zip(ctxs, aps)]
    parts = attn.gqa_decode_group(aps, cfg, ctxs, xs, ks, vs, poss, win,
                                  actives, cross, kv_lens, backend, heads)
    return _attn_reduce(aps, cfg, ctxs, parts)


def _mixer_decode_group(aps, cfg: ModelConfig, ctxs, xs, caches, poss,
                        win, actives, backend: str):
    """A decoder's attention (GQA or MLA) on a group, reduced."""
    if cfg.attn_kind != "mla":
        return _attn_decode_group(aps, cfg, ctxs, xs,
                                  [c["k"] for c in caches],
                                  [c["v"] for c in caches], poss, win,
                                  actives, backend)
    heads = [_first_head(cfg, c, a) for c, a in zip(ctxs, aps)]
    parts = attn.mla_decode_group(aps, cfg, ctxs, xs,
                                  [c["latent"] for c in caches],
                                  [c["krope"] for c in caches], poss,
                                  actives, backend, heads)
    return _attn_reduce(aps, cfg, ctxs, parts)


def _ffn_group(ps, cfg: ModelConfig, ctxs, hs, rows_split: bool,
               moe_ep: bool = False, batch_moe: bool = False,
               backend: str = "kernel"):
    """``_ffn`` on a group: ln2 -> MLP (TP) or MoE (per-row, the pure EP
    all-to-all over a (data, model) token grid when ``moe_ep``, or the
    whole batch's routing when ``batch_moe``) -> residual.  Under
    ``seq_act`` the MoE routes the gathered rows, as without it, and
    each slot keeps its block of the output."""
    xs = _normed(ps, cfg, ctxs, hs, "ln2")
    fs = [p["ffn"] for p in ps]
    if cfg.moe_dropless and ctxs[0].mesh is not None:
        raise NotImplementedError("the dropless MoE serves on solo servers "
                                  "only")
    if not cfg.is_moe:
        ms = mlp_group(fs, cfg, ctxs, xs)
    elif batch_moe:
        ms = moe.apply_moe_batch_group(fs, cfg, ctxs, xs)[0]
    elif ctxs[0].mesh is None:  # a solo server's one slot
        ms = [moe.apply_moe(fs[0], cfg, xs[0], per_row=True,
                            backend=backend, with_aux=False)[0]]
    elif moe_ep:
        # each model slot takes its chunk of the row block's rows
        loc = [x.chunk(c.n_model, dim=0)[c.j] for c, x in zip(ctxs, xs)]
        routed, _ = moe._apply_moe_ep(fs, cfg, ctxs, loc)
        ms = moe._shared_expert_group(fs, cfg, ctxs, xs,
                                      gather_model(ctxs, routed, dim=0))
    else:
        ms = moe.apply_moe_group(fs, cfg, ctxs, xs, rows_split)
    if cfg.is_moe:
        ms = [seq_block(c, m) for c, m in zip(ctxs, ms)]
    return [_residual(p, cfg, h, m, "post_ln2")
            for p, h, m in zip(ps, hs, ms)]


def _mlp_residual_group(ps, cfg: ModelConfig, ctxs, hs, norm="ln2",
                        concat=None):
    """``h + MLP(norm(h))`` on a group (``concat``: per-slot tensors joined
    to h before the norm, zamba2's embedding)."""
    xs = _normed(ps, cfg, ctxs, hs, norm, concat)
    ms = mlp_group([p["ffn"] for p in ps], cfg, ctxs, xs)
    return [h + m for h, m in zip(hs, ms)]


def decoder_block_full_group(ps, cfg: ModelConfig, ctxs, hs, poss,
                             layer_idx=0, prefixes=None,
                             backend: str = "kernel",
                             rows_split: bool = False):
    """:func:`decoder_block_full` on a group (per-row MoE).  ``poss``:
    per-slot positions; ``prefixes``: per-slot ``prefix_kv`` (or None), the
    whole prefix (gathered from the slots' time shards by the caller).
    Returns (per-slot h, per-slot cache entries of the chunk)."""
    hs, caches = _attn_full_group(ps, cfg, ctxs, hs, poss, layer_idx,
                                  prefixes, backend)
    return _ffn_group(ps, cfg, ctxs, hs, rows_split, backend=backend), \
        caches


def _attn_full_group(ps, cfg: ModelConfig, ctxs, hs, poss, layer_idx,
                     prefixes, backend: str):
    """ln1 -> attention of each slot's heads, reduced -> residual: (per-slot
    h, per-slot cache entries of the chunk)."""
    win = window_for_layer(cfg, layer_idx)
    prefixes = prefixes or [None] * len(ctxs)
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    aps = [p["attn"] for p in ps]
    if cfg.attn_kind != "mla" and attn.gqa_split(cfg, aps, ctxs):
        ys, kvs = attn.gqa_full_split_group(aps, cfg, ctxs, xs, poss, win,
                                            prefixes, backend=backend)
        outs = [(y, {"k": k, "v": v}) for y, (k, v) in zip(ys, kvs)]
    else:
        outs = [_mixer_full(p, cfg, x, positions, win, pre, backend,
                            _first_head(cfg, c, p["attn"]))
                for p, c, x, positions, pre in zip(ps, ctxs, xs, poss,
                                                    prefixes)]
    a = _attn_reduce(aps, cfg, ctxs, [o[0] for o in outs])
    return ([_residual(p, cfg, h, y, "post_ln1")
             for p, h, y in zip(ps, hs, a)], [o[1] for o in outs])


def decoder_block_batch_group(ps, cfg: ModelConfig, ctxs, hs, poss,
                              layer_idx=0, backend: str = "kernel"):
    """The decoder block of a whole batch on a group — the training step's
    and the group ``prefill``'s: each slot's block of the rows, attention
    as in :func:`decoder_block_full_group` and the MoE over the whole
    batch (``moe.apply_moe_batch_group``).  Returns (per-slot h, per-slot
    cache entries of the sequence, aux: the MoE's terms on slot 0's
    device, or {})."""
    hs, caches = _attn_full_group(ps, cfg, ctxs, hs, poss, layer_idx, None,
                                  backend)
    if not cfg.is_moe:
        return _ffn_group(ps, cfg, ctxs, hs, True), caches, {}
    fs, c0 = [p["ffn"] for p in ps], ctxs[0]
    # each slot's normed residual block: under seq_act its own positions
    xs = [apply_norm(p["ln2"], cfg, h) for p, h in zip(ps, hs)]
    if moe.expert_alloc(cfg.n_experts) != cfg.n_experts and moe.ep_grid(
            c0, hs[0].shape[0] * c0.row_block()[1],
            hs[0].shape[1] * c0.seq[1]):
        ms, aux = _moe_ep_batch(fs, cfg, ctxs, xs)
    else:
        ms, aux = moe.apply_moe_batch_group(fs, cfg, ctxs, xs)
    return [_residual(p, cfg, h, m, "post_ln2")
            for p, h, m in zip(ps, hs, ms)], caches, aux


def _moe_ep_batch(fs, cfg: ModelConfig, ctxs, xs):
    """A whole batch's MoE through the pure-EP all-to-all
    (``moe._apply_moe_ep``) with the reference's token grid: each slot
    routes its block of the rows at its model index's block of the
    positions — under ``seq_act`` its own block of the residual stream
    (``xs``: each slot's normed block), else cut from the whole sequence.
    Returns (per-slot outputs on the residual stream's layout, aux)."""
    split = ctxs[0].seq[1] > 1
    whole = gather_seq(ctxs, xs) if split and cfg.n_shared_experts else xs
    loc = xs if split else [x.chunk(c.n_model, dim=1)[c.j]
                            for c, x in zip(ctxs, xs)]
    routed, aux = moe._apply_moe_ep(fs, cfg, ctxs, loc)
    if not split:
        routed = gather_model(ctxs, routed, dim=1)
    return moe._shared_expert_group(fs, cfg, ctxs, whole, routed,
                                    block=split), aux


def decoder_block_train_group(ps, cfg: ModelConfig, ctxs, hs, poss,
                              layer_idx=0, backend: str = "plain"):
    """The training step's decoder block on a group
    (:func:`decoder_block_batch_group` without its caches).  Returns
    (per-slot h, aux)."""
    hs, _, aux = decoder_block_batch_group(ps, cfg, ctxs, hs, poss,
                                           layer_idx, backend)
    return hs, aux


def decoder_block_decode_group(ps, cfg: ModelConfig, ctxs, hs, caches,
                               poss, layer_idx=0, actives=None,
                               backend: str = "kernel",
                               rows_split: bool = False,
                               moe_ep: bool = False,
                               batch_moe: bool = False):
    """:func:`decoder_block_decode` on a group: per-slot h (B_i, 1, d),
    caches (written in place on the ``actives`` rows), positions.
    ``batch_moe``: the MoE routes the whole batch (the group
    ``decode_step``; the pooled steps route rows).  Returns per-slot h."""
    win = window_for_layer(cfg, layer_idx)
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    a = _mixer_decode_group([p["attn"] for p in ps], cfg, ctxs, xs, caches,
                            poss, win, actives, backend)
    hs = [_residual(p, cfg, h, y, "post_ln1") for p, h, y in zip(ps, hs, a)]
    return _ffn_group(ps, cfg, ctxs, hs, rows_split, moe_ep, batch_moe,
                      backend)


def encoder_block_full_group(ps, cfg: ModelConfig, ctxs, hs, poss,
                             backend: str = "kernel"):
    """:func:`encoder_block_full` on a group: bidirectional attention of
    each slot's heads over its KV heads (or under the ``head_dim``
    fallback / ``attn_seq_q``, ``attention.gqa_full_split_group``),
    reduced; the MLP.  Per-slot h."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    aps = [p["attn"] for p in ps]
    if attn.gqa_split(cfg, aps, ctxs):
        ys = _attn_reduce(aps, cfg, ctxs, attn.gqa_full_split_group(
            aps, cfg, ctxs, xs, poss, encoder=True, backend=backend)[0])
        return _mlp_residual_group(ps, cfg, ctxs,
                                   [h + y for h, y in zip(hs, ys)])
    parts = []
    for a, c, x, positions in zip(aps, ctxs, xs, poss):
        q = attn._q_proj(a, cfg, x)
        k, v = attn._kv_proj(a, cfg, x)
        if cfg.pos_kind == "rope":
            cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        k, v = attn._kv_slice(cfg, _first_head(cfg, c, a), q.shape[2], k, v)
        out = attn._attend_full(cfg, q, k, v, positions, positions, None,
                                None, False, 0, backend)
        parts.append(torch.einsum("bshk,hkd->bsd", out,
                                  a["wo"].to(x.dtype)))
    ys = _attn_reduce(aps, cfg, ctxs, parts)
    return _mlp_residual_group(ps, cfg, ctxs,
                               [h + y for h, y in zip(hs, ys)])


def cross_decoder_block_full_group(ps, cfg: ModelConfig, ctxs, hs, poss,
                                   enc_hs, prefixes=None, enc_kvs=None,
                                   backend: str = "kernel"):
    """:func:`cross_decoder_block_full` on a group.  ``prefixes`` /
    ``enc_kvs``: per-slot whole prefixes and cross (k, v) of the slot's
    KV heads (or None).  Returns (per-slot h, per-slot {"k", "v", "ck",
    "cv"})."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    ys, kvs = _gqa_full_group([p["self_attn"] for p in ps], cfg, ctxs, xs,
                              poss, prefixes=prefixes, backend=backend)
    hs = [h + y for h, y in zip(hs, ys)]
    xs = _normed(ps, cfg, ctxs, hs, "ln_cross")
    ckvs = enc_kvs if enc_kvs and enc_kvs[0] is not None else \
        attn.gqa_encoder_kv_group([p["cross_attn"] for p in ps], cfg, ctxs,
                                  enc_hs)
    ys, _ = _gqa_full_group([p["cross_attn"] for p in ps], cfg, ctxs, xs,
                            poss, cross_kvs=ckvs, backend=backend)
    hs = _mlp_residual_group(ps, cfg, ctxs, [h + y for h, y in zip(hs, ys)])
    return hs, [{"k": kv[0], "v": kv[1], "ck": ckv[0], "cv": ckv[1]}
                for kv, ckv in zip(kvs, ckvs)]


def cross_decoder_block_decode_group(ps, cfg: ModelConfig, ctxs, hs,
                                     caches, poss, enc_lens=None,
                                     actives=None, backend: str = "kernel"):
    """:func:`cross_decoder_block_decode` on a group (the self caches
    written in place on ``actives`` rows).  Per-slot h."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    ys = _attn_decode_group([p["self_attn"] for p in ps], cfg, ctxs, xs,
                            [c["k"] for c in caches],
                            [c["v"] for c in caches], poss, None, actives,
                            backend)
    hs = [h + y for h, y in zip(hs, ys)]
    xs = _normed(ps, cfg, ctxs, hs, "ln_cross")
    ys = _attn_decode_group([p["cross_attn"] for p in ps], cfg, ctxs, xs,
                            [c["ck"] for c in caches],
                            [c["cv"] for c in caches], poss, backend=backend,
                            cross=True, kv_lens=enc_lens)
    return _mlp_residual_group(ps, cfg, ctxs, [h + y for h, y in zip(hs, ys)])


def mamba_block_full_group(ps, cfg: ModelConfig, ctxs, hs,
                           backend: str = "kernel"):
    """:func:`mamba_block_full` on a group: (per-slot h, per-slot state)."""
    xs = _normed(ps, cfg, ctxs, hs, "ln")
    ys, states = ssm.mamba_full_group([p["mixer"] for p in ps], cfg, ctxs,
                                      xs, backend)
    return [h + y for h, y in zip(hs, ys)], states


def mamba_block_decode_group(ps, cfg: ModelConfig, ctxs, hs, states):
    """:func:`mamba_block_decode` on a group."""
    xs = _normed(ps, cfg, ctxs, hs, "ln")
    ys, states = ssm.mamba_decode_group([p["mixer"] for p in ps], cfg, ctxs,
                                        xs, states)
    return [h + y for h, y in zip(hs, ys)], states


def zamba_shared_full_group(ps, cfg: ModelConfig, ctxs, hs, emb0s, poss,
                            backend: str = "kernel"):
    """:func:`zamba_shared_full` on a group (``ps``: the slots' shared
    params): (per-slot h, per-slot {"k", "v"})."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1", emb0s)
    ys, kvs = _gqa_full_group([p["attn"] for p in ps], cfg, ctxs, xs, poss,
                              backend=backend)
    hs = _mlp_residual_group(ps, cfg, ctxs, [h + y for h, y in zip(hs, ys)],
                             "ln2", emb0s)
    return hs, [{"k": kv[0], "v": kv[1]} for kv in kvs]


def zamba_shared_decode_group(ps, cfg: ModelConfig, ctxs, hs, emb0s, caches,
                              poss, actives=None, backend: str = "kernel"):
    """:func:`zamba_shared_decode` on a group (K/V written in place on
    ``actives`` rows).  Per-slot h."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1", emb0s)
    ys = _attn_decode_group([p["attn"] for p in ps], cfg, ctxs, xs,
                            [c["k"] for c in caches],
                            [c["v"] for c in caches], poss, None, actives,
                            backend)
    return _mlp_residual_group(ps, cfg, ctxs, [h + y for h, y in zip(hs, ys)],
                               "ln2", emb0s)


def rwkv_block_full_group(ps, cfg: ModelConfig, ctxs, hs,
                          backend: str = "kernel"):
    """:func:`rwkv_block_full` on a group: (per-slot h, per-slot state)."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    ys, tms = ssm.rwkv_tm_full_group([p["tm"] for p in ps], cfg, ctxs, xs,
                                     backend)
    hs = [h + y for h, y in zip(hs, ys)]
    xs = _normed(ps, cfg, ctxs, hs, "ln2")
    cms = ssm.rwkv_cm_group([p["cm"] for p in ps], cfg, ctxs, xs)
    return ([h + y for h, (y, _) in zip(hs, cms)],
            [{"wkv": tm["wkv"], "shift_tm": tm["shift"], "shift_cm": sh}
             for tm, (_, sh) in zip(tms, cms)])


def rwkv_block_decode_group(ps, cfg: ModelConfig, ctxs, hs, states):
    """:func:`rwkv_block_decode` on a group."""
    xs = _normed(ps, cfg, ctxs, hs, "ln1")
    ys, tms = ssm.rwkv_tm_decode_group(
        [p["tm"] for p in ps], cfg, ctxs, xs,
        [{"wkv": st["wkv"], "shift": st["shift_tm"]} for st in states])
    hs = [h + y for h, y in zip(hs, ys)]
    xs = _normed(ps, cfg, ctxs, hs, "ln2")
    cms = ssm.rwkv_cm_group([p["cm"] for p in ps], cfg, ctxs, xs,
                            [st["shift_cm"] for st in states])
    return ([h + y for h, (y, _) in zip(hs, cms)],
            [{"wkv": tm["wkv"], "shift_tm": tm["shift"], "shift_cm": sh}
             for tm, (_, sh) in zip(tms, cms)])


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
    return encoder_block_full_group([params], cfg, [NULL], [h], [positions],
                                    backend)[0]


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
    hs, caches = cross_decoder_block_full_group(
        [params], cfg, [NULL], [h], [positions], [enc_h], [prefix_kv],
        [enc_kv], backend)
    return hs[0], caches[0]


def cross_decoder_block_decode(params, cfg: ModelConfig, h, cache, pos,
                               enc_len=None, active=None,
                               backend: str = "kernel"):
    """Single-token cross-decoder block: K1 twice, causal self attention
    (the new K/V written in place on ``active`` rows) and non-causal cross
    attention over ``ck``/``cv``.  ``enc_len`` (B,): valid encoder
    positions per row, for cross caches allocated longer than the
    session's encoder output (the pooled steps); None attends over the
    whole cross cache (the monolithic decode).  Returns (h, cache)."""
    h = cross_decoder_block_decode_group(
        [params], cfg, [NULL], [h], [cache], [pos], [enc_len], [active],
        backend)[0]
    return h, cache


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------


def init_mamba_block(pb: ParamBuilder, cfg: ModelConfig):
    c = pb.child()
    c.sub("ln", init_norm, cfg)
    c.sub("mixer", ssm.init_mamba, cfg)
    return c.params


def mamba_block_full(params, cfg: ModelConfig, h, backend: str = "kernel"):
    hs, states = mamba_block_full_group([params], cfg, [NULL], [h], backend)
    return hs[0], states[0]


def mamba_block_decode(params, cfg: ModelConfig, h, state):
    """One token; the step is elementwise and launches no kernel."""
    hs, states = mamba_block_decode_group([params], cfg, [NULL], [h],
                                          [state])
    return hs[0], states[0]


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
    hs, kvs = zamba_shared_full_group([params], cfg, [NULL], [h], [emb0],
                                      [positions], backend)
    return hs[0], kvs[0]


def zamba_shared_decode(params, cfg: ModelConfig, h, emb0, cache, pos,
                        active=None, backend: str = "kernel"):
    """One token; writes K/V into ``cache`` in place at ``pos`` (``active``
    rows only).  Returns (h, cache)."""
    h = zamba_shared_decode_group([params], cfg, [NULL], [h], [emb0],
                                  [cache], [pos], [active], backend)[0]
    return h, cache


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
    hs, states = rwkv_block_full_group([params], cfg, [NULL], [h], backend)
    return hs[0], states[0]


def rwkv_block_decode(params, cfg: ModelConfig, h, state):
    """One token; the step is elementwise and launches no kernel."""
    hs, states = rwkv_block_decode_group([params], cfg, [NULL], [h], [state])
    return hs[0], states[0]
