"""Model API: param init, prefill, decode — the counterpart of the
reference's ``repro/models/model.py`` for decoders (dense or MoE, GQA or
MLA), RWKV6, zamba2 hybrids and encoder-decoder stacks.

A stack is a list of segments (``stack_plan``) of stacked per-layer
params, as in the reference:

* dense:   ``[("blocks", decoder, n_layers)]``
* MoE with ``n_dense_layers`` leading dense blocks (DeepSeek-V2's
  ``first_k_dense_replace``): ``[("lead", lead, n_dense_layers),
  ("blocks", decoder, n_layers - n_dense_layers)]``; a lead block is a
  decoder block run under ``cfg.lead_config()`` (a dense SwiGLU FFN of
  width ``d_ff``), so ``blocks`` stays the MoE run
* rwkv6:   ``[("blocks", rwkv, n_layers)]``
* enc-dec: ``[("enc", enc, n_enc_layers), ("dec", dec, n_dec_layers)]``;
  the encoder runs over the frames, the decoder over the tokens with
  cross attention to the encoder output; encoder blocks hold no cache
* zamba2:  ``[("mega", period mamba blocks + shared attn, n_mega),
  ("tail", mamba, n_tail)]`` with the shared attention params in
  ``params["shared"]``; mega leaves are ``(n_mega, period, ...)``.

The reference scans the segments with ``lax.scan``; here a Python loop
walks the layers over views of the stacked leaves (no copies).  The
reference's jit has no counterpart: PyTorch runs eagerly.  ``decode_step``
updates the caches in place and returns the same cache tree.
``train_loss`` is the reference's next-token loss, on the plain versions
(the hand-written kernels have no backward), with each layer optionally
recomputed in the backward pass (``remat``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import mla_cache_views
from repro_torch.models.layers import (ParamBuilder, embed_frames,
                                       embed_tokens, init_embedding, lm_head,
                                       param_dtype)

# sequence chunks of the loss's LM head (bounds the f32 logits' memory)
_LOSS_CHUNKS = 4


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict (None: 0)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# Stack plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentSpec:
    name: str
    kind: str  # decoder | lead | enc | dec | rwkv | mamba | mega
    n: int  # number of stacked steps
    blocks_per_step: int = 1

    @property
    def n_blocks(self) -> int:
        return self.n * self.blocks_per_step


def stack_plan(cfg: ModelConfig) -> List[SegmentSpec]:
    B.check_supported(cfg)
    if cfg.is_enc_dec:
        return [SegmentSpec("enc", "enc", cfg.n_enc_layers),
                SegmentSpec("dec", "dec", cfg.n_dec_layers)]
    if cfg.family == "hybrid":
        period = cfg.shared_attn_period
        n_mega, n_tail = divmod(cfg.n_layers, period)
        plan = [SegmentSpec("mega", "mega", n_mega, blocks_per_step=period)]
        if n_tail:
            plan.append(SegmentSpec("tail", "mamba", n_tail))
        return plan
    if cfg.family == "ssm":
        return [SegmentSpec("blocks", "rwkv", cfg.n_layers)]
    n_lead = cfg.n_dense_layers
    return ([SegmentSpec("lead", "lead", n_lead)] if n_lead else []) + \
        [SegmentSpec("blocks", "decoder", cfg.n_layers - n_lead)]


_SEG_INIT = {"decoder": B.init_decoder_block, "rwkv": B.init_rwkv_block,
             "mamba": B.init_mamba_block, "enc": B.init_encoder_block,
             "dec": B.init_cross_decoder_block}


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random params with the reference's tree, shapes, dtypes and init
    scales (``model.py:114``), drawn from ``generator`` (other values than
    the reference's PRNG).  For standalone runs on the card; parity tests
    bridge the reference's own params instead (``repro_torch.weights``).
    Each stacked leaf is drawn in f32 and then cast, so the largest leaf
    costs 4 bytes per element of transient memory."""
    params: Dict = {"embed": init_embedding(ParamBuilder(generator, device),
                                            cfg),
                    "segments": {}}
    for seg in stack_plan(cfg):
        if seg.kind == "mega":
            pb = ParamBuilder(generator, device,
                              lead=(seg.n, seg.blocks_per_step))
            params["segments"][seg.name] = {
                "mamba": B.init_mamba_block(pb, cfg)}
        else:
            pb = ParamBuilder(generator, device, lead=(seg.n,))
            c, kind = B.resolve_kind(cfg, seg.kind)
            params["segments"][seg.name] = _SEG_INIT[kind](pb, c)
    if cfg.family == "hybrid":
        params["shared"] = B.init_zamba_shared(
            ParamBuilder(generator, device), cfg)
    return params


def init_params_shapes(cfg: ModelConfig):
    """(params, axes): the params tree as meta tensors — shapes and dtypes,
    no data, no generator — and its logical-axes tree
    (``launch.sharding.param_axes``); the reference's
    ``init_params_shapes`` (``model.py:146``)."""
    from repro_torch.launch.sharding import param_axes

    params = init_params(cfg, None, "meta")
    return params, param_axes(cfg, params)


def hybrid_mamba_stack(params, cfg: ModelConfig):
    """All ``n_layers`` mamba block params stacked on axis 0 in BPRR block
    order (hybrid family): the mega leaves ``(n_mega, per, ...)`` flattened
    and the tail appended.  With a tail this copies every mamba leaf, as
    the reference's concatenation does; the serving path slices
    :func:`block_param_range` instead."""
    return block_param_range(params, cfg, "mamba", 0, cfg.n_layers)


def block_param_range(params, cfg: ModelConfig, kind: str, lo: int, hi: int):
    """Per-layer block params stacked on axis 0 for absolute blocks
    ``[lo, hi)``, all of one ``kind`` (``blocks.stack_block_kinds``).

    Decoder and rwkv ranges, and mamba ranges that lie inside the mega
    segment or inside the tail, are VIEWS of the stacked leaves, so
    replicas of a block on several virtual servers share one copy on the
    device.  A mamba range that straddles the mega/tail boundary is the one
    copy: of just that range.  "mamba_shared" blocks return their mamba
    mixer params; the shared attention half lives in ``params["shared"]``."""
    segs = params["segments"]
    if kind == "lead":
        return tree_map(lambda x: x[lo:hi], segs["lead"])
    if kind == "decoder" and cfg.n_dense_layers:
        n = cfg.n_dense_layers
        return tree_map(lambda x: x[lo - n:hi - n], segs["blocks"])
    if kind in ("decoder", "rwkv"):
        return tree_map(lambda x: x[lo:hi], segs["blocks"])
    if kind == "enc":
        return tree_map(lambda x: x[lo:hi], segs["enc"])
    if kind == "dec":
        ne = cfg.n_enc_layers
        return tree_map(lambda x: x[lo - ne:hi - ne], segs["dec"])
    if kind not in ("mamba", "mamba_shared"):
        B.check_supported(cfg)
        raise ValueError(f"unknown block kind {kind!r}; supported: decoder, "
                         "lead, rwkv, mamba, mamba_shared, enc, dec")
    n_mega = stack_plan(cfg)[0].n_blocks
    mega = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]),
                    segs["mega"]["mamba"])  # views of contiguous leaves
    if hi <= n_mega:
        return tree_map(lambda x: x[lo:hi], mega)
    tail = segs["tail"]
    if lo >= n_mega:
        return tree_map(lambda x: x[lo - n_mega:hi - n_mega], tail)
    return _tree_cat([tree_map(lambda x: x[lo:], mega),
                      tree_map(lambda x: x[:hi - n_mega], tail)])


def _tree_cat(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_cat([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees, dim=0)


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked params (or cache) tree, as views."""
    return tree_map(lambda x: x[i], stacked)


def unstack(stacked, n: int):
    """The ``n`` layers of a stacked tree, as views (``layer_params`` of
    each).  One ``unbind`` a leaf: differentiated, its backward stacks the
    layers' gradients once, where indexing layer by layer would give each
    layer a gradient of the whole stacked leaf to add up."""
    if isinstance(stacked, dict):
        per_key = {k: unstack(v, n) for k, v in stacked.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return stacked.unbind(0)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _stack_tree(entries):
    """Stack a list of same-structure cache trees on a new axis 0."""
    if isinstance(entries[0], dict):
        return {k: _stack_tree([e[k] for e in entries]) for k in entries[0]}
    return torch.stack(entries)


# cache leaves with a time axis (axis 2 of a stacked (layers, B, T, ...)
# leaf); the recurrent states ("wkv", "shift_*", "ssm", "conv") have none.
# An MLA layer's "latent" and "krope" are two column blocks of one buffer
# (``attention.mla_cache_views``)
LENGTH_KEYS = frozenset({"k", "v", "latent", "krope"})


def _grow_tree(tree, cache_len: Optional[int], cur_len: int):
    if "latent" in tree:  # MLA: one joint (.., T, lora + rope) buffer
        buf = torch.cat([tree["latent"], tree["krope"]], dim=-1)
        return mla_cache_views(_grow(buf, cache_len, cur_len),
                               tree["latent"].shape[-1])
    return {k: (_grow_tree(v, cache_len, cur_len) if isinstance(v, dict)
                else _grow(v, cache_len, cur_len) if k in LENGTH_KEYS
                else v)
            for k, v in tree.items()}


def _call(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat`` nothing inside ``fn`` is kept for the
    backward pass, which runs ``fn`` again (the reference's
    ``jax.checkpoint(policy=nothing_saveable)`` around each scan step).
    The stack draws no random numbers, so no RNG state is kept.

    The recompute runs ``fn`` whole: its early stop is off, for the
    training step and the dry run's count alike.  Early stop ends a
    recompute once the backward has what it needs, which in a group's
    lockstep slot loop cuts the last slot's recompute alone, so a train
    cell's count would depend on the slot that stands in."""
    if not remat:
        return fn(*args)
    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)


def _caster(cast: Optional[torch.dtype]):
    """A function casting every leaf of a tree (or None) to ``cast``
    (identity for ``cast`` None)."""
    if cast is None:
        return lambda tree: tree
    return lambda tree: None if tree is None else \
        tree_map(lambda x: x.to(cast), tree)


def forward_full(params, cfg: ModelConfig, batch, collect_caches=False,
                 cache_len: Optional[int] = None, backend: str = "kernel",
                 remat: bool = False, cast: Optional[torch.dtype] = None,
                 ctxs=None):
    """Run the stack over full sequences.  Returns (h_final, aux, caches);
    aux sums the MoE terms over the layers (zero without MoE); caches is
    {segment: stacked cache tree} when ``collect_caches`` (K/V time axes
    grown to ``cache_len`` when given; an enc-dec stack's cross K/V keep
    the encoder length).  Enc-dec stacks take ``batch["frames"]`` (B,
    S_enc, frame_dim) beside the tokens.  ``remat`` recomputes each layer
    (a zamba2 mega step: its mamba blocks and the shared attention) in the
    backward pass instead of keeping its activations.  ``cast``: run in
    that dtype on params stored in another — the embedding rows are
    gathered and then cast, and each layer's leaves are cast as the layer
    runs and dropped after it, so no cast copy of the whole stack exists.

    ``ctxs`` (a group's ``layers.GroupCtx`` list): the stack over a device
    group, the training step's form — ``params`` per-slot trees (each
    slot's TP / EP shards, ``embed_fsdp`` leaves gathered), ``batch``
    per-slot dicts of the slot's rows (row block ``i`` on data index
    ``i``); each layer's group form (``blocks.*_group``; the decoder's
    :func:`blocks.decoder_block_train_group`, the MoE over the whole
    batch) runs once per layer, under ``remat`` recomputed in the
    backward pass (what it keeps is each layer's input: under ``seq_act``
    the slot's sequence block).  Returns (per-slot h — the slot's ``seq``
    block of the positions under ``seq_act`` — aux on slot 0's device,
    {})."""
    if ctxs is not None:
        if collect_caches or cast is not None:
            raise ValueError("forward_full over a group collects no caches "
                             "and casts nothing (the training step's form)")
        return _forward_full_group(params, cfg, batch, ctxs, backend, remat)
    if cfg.is_enc_dec:
        return _forward_encdec(params, cfg, batch, collect_caches,
                               cache_len, backend, remat, cast)
    up = _caster(cast)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    h = up(embed_tokens(params["embed"], cfg, tokens))
    emb0 = h
    shared = up(params.get("shared"))  # zamba2's shared attention
    caches: Dict = {}
    aux_total = {"moe_aux_loss": torch.zeros((), device=tokens.device),
                 "moe_drop_frac": torch.zeros((), device=tokens.device)}

    def decoder(p, h, i, c=cfg):
        return B.decoder_block_full(p, c, h, positions, i, backend=backend)

    def recurrent(p, h, blk):
        return blk(p, cfg, h, backend=backend)

    def mega(p, h, shared, emb0):
        states = []
        for pj in unstack(p["mamba"], cfg.shared_attn_period):
            h, st = B.mamba_block_full(pj, cfg, h, backend=backend)
            states.append(st)
        h, kv = B.zamba_shared_full(shared, cfg, h, emb0, positions,
                                    backend=backend)
        return h, {"mamba": _stack_tree(states), "attn": kv}

    for seg in stack_plan(cfg):
        seg_params = params["segments"][seg.name]
        entries = []
        c, kind = B.resolve_kind(cfg, seg.kind)
        for i, p in enumerate(unstack(seg_params, seg.n)):
            p = up(p)
            if kind == "decoder":
                h, cache, aux = _call(remat, decoder, p, h, i, c)
                for key, val in aux.items():
                    aux_total[key] = aux_total[key] + val
            elif seg.kind in ("rwkv", "mamba"):
                blk = (B.rwkv_block_full if seg.kind == "rwkv"
                       else B.mamba_block_full)
                h, cache = _call(remat, recurrent, p, h, blk)
            else:  # mega: period mamba blocks, then the shared attention
                h, cache = _call(remat, mega, p, h, shared, emb0)
            if collect_caches:
                entries.append(cache)
        if collect_caches:
            caches[seg.name] = _grow_tree(_stack_tree(entries), cache_len, S)
    return h, aux_total, caches


def _forward_encdec(params, cfg: ModelConfig, batch, collect_caches,
                    cache_len: Optional[int], backend: str,
                    remat: bool = False, cast: Optional[torch.dtype] = None):
    """Encoder over the frames (exact length, non-causal), then the
    decoder over the tokens with cross attention to the encoder output."""
    up = _caster(cast)
    frames, tokens = batch["frames"], batch["tokens"]
    S = tokens.shape[1]
    enc_pos = torch.arange(frames.shape[1], device=tokens.device)
    dec_pos = torch.arange(S, device=tokens.device)
    enc_h = embed_frames({"frame_proj": up(params["embed"]["frame_proj"])},
                         cfg, frames)
    segs = params["segments"]

    def enc(p, h):
        return B.encoder_block_full(p, cfg, h, enc_pos, backend=backend)

    def dec(p, h, enc_h):
        return B.cross_decoder_block_full(p, cfg, h, dec_pos, enc_h,
                                          backend=backend)

    for p in unstack(segs["enc"], cfg.n_enc_layers):
        enc_h = _call(remat, enc, up(p), enc_h)
    h = up(embed_tokens(params["embed"], cfg, tokens))
    entries = []
    for p in unstack(segs["dec"], cfg.n_dec_layers):
        h, cache = _call(remat, dec, up(p), h, enc_h)
        entries.append(cache)
    caches: Dict = {}
    if collect_caches:
        caches["dec"] = _grow_tree(_stack_tree(entries), cache_len, S)
    aux = {"moe_aux_loss": torch.zeros((), device=tokens.device),
           "moe_drop_frac": torch.zeros((), device=tokens.device)}
    return h, aux, caches


def _full_layer_group(cfg: ModelConfig, seg: SegmentSpec, pl, ctxs, hs, poss,
                      layer_idx: int, backend: str, shared=None, emb0s=None,
                      encs=None):
    """One step of segment ``seg`` over a group's slots (``pl``: each
    slot's layer params; the decoder's MoE over the whole batch): (per-slot
    h, per-slot cache entries of the sequence or None, aux)."""
    c, kind = B.resolve_kind(cfg, seg.kind)
    if kind == "decoder":
        return B.decoder_block_batch_group(pl, c, ctxs, hs, poss, layer_idx,
                                           backend)
    if seg.kind == "enc":
        return B.encoder_block_full_group(pl, cfg, ctxs, hs, poss,
                                          backend), None, {}
    if seg.kind == "dec":
        hs, entries = B.cross_decoder_block_full_group(
            pl, cfg, ctxs, hs, poss, encs, backend=backend)
        return hs, entries, {}
    if seg.kind in ("rwkv", "mamba"):
        blk = (B.rwkv_block_full_group if seg.kind == "rwkv"
               else B.mamba_block_full_group)
        hs, states = blk(pl, cfg, ctxs, hs, backend)
        return hs, states, {}
    states = []  # mega: period mamba blocks, then the shared attention
    for pj in _slot_layers(pl, "mamba", seg.blocks_per_step):
        hs, st = B.mamba_block_full_group(pj, cfg, ctxs, hs, backend)
        states.append(st)
    hs, kvs = B.zamba_shared_full_group(shared, cfg, ctxs, hs, emb0s, poss,
                                        backend)
    return hs, [{"mamba": _stack_tree([st[s] for st in states]),
                 "attn": kvs[s]} for s in range(len(ctxs))], {}


def _forward_full_group(ps, cfg: ModelConfig, batches, ctxs, backend: str,
                        remat: bool, collect=None):
    """:func:`forward_full` over a group (see there).  ``collect(seg, i,
    entries)``: called with each layer's per-slot cache entries (the
    group ``prefill``'s).  Under ``seq_act`` the residual stream — the
    embedding's output, every block's input and output, and the per-slot
    h returned — is each slot's ``seq`` block of the positions (the
    encoder's of the frames, gathered whole for the cross attention)."""
    from repro_torch.models.layers import (embed_tokens_group, gather_seq,
                                           seq_block)

    dev0 = batches[0]["tokens"].device
    # the MoE terms of the training step's loss (slot 0's scalars; the
    # group prefill keeps none)
    aux_total = {} if collect is not None else {
        "moe_aux_loss": torch.zeros((), device=dev0),
        "moe_drop_frac": torch.zeros((), device=dev0)}
    toks = [b["tokens"] for b in batches]
    dctxs = _pass_ctxs(ctxs, batches, "tokens")
    poss = [torch.arange(t.shape[1], device=t.device) for t in toks]
    segs = [p["segments"] for p in ps]
    shared = [p.get("shared") for p in ps]
    encs = ectxs = None
    if cfg.is_enc_dec:
        frames = [b["frames"] for b in batches]
        ectxs = _pass_ctxs(ctxs, batches, "frames")
        enc_poss = [torch.arange(f.shape[1], device=f.device)
                    for f in frames]
        encs = [seq_block(c, embed_frames(
            {"frame_proj": p["embed"]["frame_proj"]}, cfg, f))
            for c, p, f in zip(ectxs, ps, frames)]
    hs = emb0s = None

    def layer(seg, i, pl, hs, shared, emb0s, encs):
        if seg.kind == "enc":
            return _full_layer_group(cfg, seg, pl, ectxs, hs, enc_poss, i,
                                     backend)
        return _full_layer_group(cfg, seg, pl, dctxs, hs, poss, i,
                                 backend, shared, emb0s, encs)

    for seg in stack_plan(cfg):
        if seg.kind != "enc" and hs is None:
            if encs is not None:  # the cross attention's keys: whole
                encs = gather_seq(ectxs, encs)
            hs = emb0s = embed_tokens_group([p["embed"] for p in ps], cfg,
                                            dctxs, toks)
        for i, pl in enumerate(_slot_layers(segs, seg.name, seg.n)):
            if seg.kind == "enc":
                encs = _call(remat, lambda *a: layer(*a)[0], seg, i, pl,
                             encs, None, None, None)
                continue
            if collect is None:  # the training step keeps no caches
                hs, aux = _call(remat, lambda *a: layer(*a)[::2], seg, i,
                                pl, hs, shared, emb0s, encs)
                for key, val in aux.items():
                    aux_total[key] = aux_total[key] + val
            else:
                hs, entries, _ = layer(seg, i, pl, hs, shared, emb0s, encs)
                collect(seg, i, entries)
    return hs, aux_total, {}


def _pass_ctxs(ctxs, batches, key: str):
    """The slots for a full-sequence pass over the per-slot ``batches``'
    ``key`` leaf (rows, positions): their ``seq`` / ``q_rows`` blocks at
    the global batch (``layers.GroupCtx.at_seq``)."""
    from repro_torch.models.layers import seq_ctxs

    x = batches[0][key]
    return seq_ctxs(ctxs, x.shape[0] * ctxs[0].row_block()[1], x.shape[1])


def _slot_layers(ps, name: str, n: int):
    """The ``n`` layers of each slot's stacked subtree ``name`` (views), as
    one per-slot list a layer."""
    per_slot = [unstack(p[name], n) for p in ps]
    return [[layers[i] for layers in per_slot] for i in range(n)]


def _grow(x, cache_len: Optional[int], cur_len: int):
    """Zero-pad a stacked (layers, B, T, ...) cache leaf to ``cache_len``."""
    if cache_len is None or cache_len == cur_len:
        return x
    if cache_len < cur_len:
        raise ValueError("cache_len must be >= prefill length")
    pad = x.new_zeros(x.shape[:2] + (cache_len - cur_len,) + x.shape[3:])
    return torch.cat([x, pad], dim=2)


# ---------------------------------------------------------------------------
# Loss (next-token CE, chunked over the sequence to bound logits memory)
# ---------------------------------------------------------------------------


def train_loss(params, cfg: ModelConfig, batch, remat: bool = True,
               ctxs=None):
    """Mean next-token cross-entropy (+ 0.01 x the MoE aux loss per layer),
    as the reference's ``train_loss``: the LM head over ``_LOSS_CHUNKS``
    sequence chunks, f32 logsumexp minus the gold logit, the last position
    masked, the sum over B x (S - 1).  Runs the plain versions (the
    reference trains on its XLA path).  Returns (loss, metrics).

    ``ctxs``: over a device group (``forward_full``'s per-slot ``params``
    and ``batch``): the vocab-parallel LM head gives each position's
    logsumexp and gold logit across the model row
    (``layers.lm_head_xent_group``), each data row block's sum comes from
    its model-0 slot, and the data slots' sums are added in slot order and
    normalised over the global B x (S - 1); the loss and metrics sit on
    slot 0's device."""
    if ctxs is not None:
        return _train_loss_group(params, cfg, batch, remat, ctxs)
    h, aux, _ = forward_full(params, cfg, batch, backend="plain",
                             remat=remat)
    tokens = batch["tokens"]
    Bsz, S = tokens.shape
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for idx, labels, sl in _loss_chunks(tokens):
        logits = lm_head(params["embed"], cfg, h[:, sl]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        ce = (logz - gold) * (idx < S - 1)[None, :]
        total = total + ce.sum()
    return _loss_metrics(cfg, total / (Bsz * (S - 1)), aux)


def _loss_chunks(tokens):
    """(positions, labels, slice) of each of the loss's sequence chunks:
    the labels are the next tokens (the last position has none and is
    masked)."""
    S = tokens.shape[1]
    n_chunks = (_LOSS_CHUNKS if S % _LOSS_CHUNKS == 0 and S >= _LOSS_CHUNKS
                else 1)
    csz = S // n_chunks
    for i in range(n_chunks):
        idx = torch.arange(i * csz, (i + 1) * csz, device=tokens.device)
        yield (idx, tokens[:, torch.clamp(idx + 1, max=S - 1)],
               slice(i * csz, (i + 1) * csz))


def _train_loss_group(ps, cfg: ModelConfig, batches, remat: bool, ctxs):
    """:func:`train_loss` over a group (see there)."""
    from repro_torch.models.layers import (gather_seq, lm_head_xent_group,
                                           row_heads)

    hs, aux, _ = forward_full(ps, cfg, batches, backend="plain",
                              remat=remat, ctxs=ctxs)
    # the vocab-parallel head takes every position on each model slot
    hs = gather_seq(_pass_ctxs(ctxs, batches, "tokens"), hs)
    toks = [b["tokens"] for b in batches]
    B_l, S = toks[0].shape
    totals = [torch.zeros((), dtype=torch.float32, device=t.device)
              for t in toks]
    chunks = [list(_loss_chunks(t)) for t in toks]
    for k in range(len(chunks[0])):
        lses, golds = lm_head_xent_group(
            [p["embed"] for p in ps], cfg, ctxs,
            [h[:, ch[k][2]] for h, ch in zip(hs, chunks)],
            [ch[k][1] for ch in chunks])
        for s, (ch, lse, gold) in enumerate(zip(chunks, lses, golds)):
            ce = (lse - gold) * (ch[k][0] < S - 1)[None, :]
            totals[s] = totals[s] + ce.sum()
    heads = row_heads(ctxs)
    total = ctxs[0].all_reduce_sum(ctxs[0].peers(totals, heads))
    return _loss_metrics(cfg, total / (B_l * len(heads) * (S - 1)), aux)


def _loss_metrics(cfg: ModelConfig, loss, aux):
    """(loss, metrics): the CE loss plus the MoE aux loss per layer."""
    metrics = {"ce_loss": loss}
    if cfg.is_moe:
        loss = loss + 0.01 * aux["moe_aux_loss"] / max(1, cfg.n_layers)
        metrics["moe_aux_loss"] = aux["moe_aux_loss"]
        metrics["moe_drop_frac"] = aux["moe_drop_frac"] / max(1,
                                                               cfg.n_layers)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, batch, cache_len: Optional[int] = None,
            backend: str = "kernel", ctxs=None):
    """Process the prompt; returns (last-token logits, caches).

    ``ctxs`` (a group's ``layers.GroupCtx`` list, the rules of a prefill
    cell): the prompt over a device group — ``params`` per-slot trees (each
    slot's shards under the rules), ``batch`` per-slot dicts of the slot's
    rows.  Each layer runs its group form (the decoder's MoE over the whole
    batch, as this monolithic prefill routes it) and writes its cache
    entries into each slot's shard of the caches as
    ``launch.sharding.cache_shardings`` lays them out
    (:func:`slot_decode_caches`: rows over the batch axes, KV heads or the
    ``kv_time`` shards over ``model``).  Under ``seq_act`` the residual
    stream is each slot's sequence block; under ``attn_seq_q`` each slot
    attends its block of the query rows; under the ``head_dim`` fallback
    each slot projects its head_dim columns (``blocks``,
    ``attention.gqa_full_split_group``).  Returns (per-slot logits of the
    whole vocabulary, gathered over the model row; per-slot caches)."""
    if ctxs is not None:
        return _prefill_group(params, cfg, batch, cache_len, backend, ctxs)
    h, _, caches = forward_full(params, cfg, batch, collect_caches=True,
                                cache_len=cache_len, backend=backend)
    logits = lm_head(params["embed"], cfg, h[:, -1:])
    return logits[:, 0], caches


def slot_decode_caches(cfg: ModelConfig, ctx, batch_size: int,
                       cache_len: int, enc_len: Optional[int] = None,
                       device=None):
    """Zero caches of one group slot (``ctx``): its block of
    ``init_decode_caches(cfg, batch_size, cache_len, enc_len)`` (the whole
    batch) under ``launch.sharding.cache_shardings`` of ``ctx``'s rules, on
    ``device`` (default the slot's).  An MLA layer's latent and krope stay
    the two views of one buffer."""
    from repro_torch.launch.sharding import ShardingCtx, cache_shardings

    # the whole tree's shapes, on meta tensors no counting mode sees (they
    # are not the step's allocations)
    with _disable_current_modes():
        whole = init_decode_caches(cfg, batch_size, cache_len, enc_len,
                                   "meta")
    specs = cache_shardings(cfg, ShardingCtx(ctx.mesh, ctx.rules), whole)
    return slot_zeros(whole, specs, ctx.mesh, ctx.slot,
                      ctx.device if device is None else device)


def slot_zeros(tree, specs, mesh, slot: int, device):
    """Zero state of one slot of a cache or pool tree (tensors or meta
    tensors of the whole leaves): each leaf's block under its spec
    (``launch.sharding.slot_index``), an MLA layer's latent / krope as
    the views of one joint buffer."""
    from repro_torch.launch.sharding import slot_index

    def block(shape, spec):
        idx = slot_index(shape, spec, mesh, slot)
        return tuple(len(range(*sl.indices(n))) for sl, n in zip(idx, shape))

    out = {}
    if "latent" in tree:
        lat, kr = tree["latent"], tree["krope"]
        shape = tuple(lat.shape[:-1]) + (lat.shape[-1] + kr.shape[-1],)
        out = mla_cache_views(torch.zeros(block(shape, specs["latent"]),
                                          dtype=lat.dtype, device=device),
                              lat.shape[-1])
    for key, x in tree.items():
        if key not in out:
            out[key] = slot_zeros(x, specs[key], mesh, slot, device) \
                if isinstance(x, dict) else torch.zeros(
                    block(tuple(x.shape), specs[key]), dtype=x.dtype,
                    device=device)
    return out


def _write_time(leaf, chunk, t0: int):
    """In place: positions [0, S) of ``chunk`` (B, S, ...) into the time
    shard ``leaf`` (B, W, ...) whose first position is ``t0`` — the part
    it holds."""
    a, b = max(0, t0), min(chunk.shape[1], t0 + leaf.shape[1])
    if a < b:
        leaf[:, a - t0:b - t0].copy_(chunk[:, a:b].to(leaf.dtype))


def _write_entry(ctx, cache, entry):
    """In place: one layer's cache ``entry`` of the whole sequence into the
    slot's layer ``cache`` — a time leaf's shard of the positions, a
    recurrent state whole."""
    for key, x in entry.items():
        leaf = cache[key]
        if isinstance(x, dict):
            _write_entry(ctx, leaf, x)
        elif key in LENGTH_KEYS or key in ("ck", "cv"):
            _write_time(leaf, x, ctx.time_block(key)[0] * leaf.shape[1])
        else:
            leaf.copy_(x.to(leaf.dtype))


def _prefill_group(ps, cfg: ModelConfig, batches, cache_len, backend: str,
                   ctxs):
    """:func:`prefill` over a group (see there)."""
    from repro_torch.models.layers import last_position, lm_head_group

    toks = [b["tokens"] for b in batches]
    S = toks[0].shape[1]
    T = cache_len or S
    enc_len = batches[0]["frames"].shape[1] if cfg.is_enc_dec else None
    rows = toks[0].shape[0] * ctxs[0].row_block()[1]
    caches = [slot_decode_caches(cfg, c, rows, T, enc_len, t.device)
              for c, t in zip(ctxs, toks)]

    def collect(seg, i, entries):
        if entries is None:
            return
        for c, cache, entry in zip(ctxs, caches, entries):
            _write_entry(c, layer_params(cache[seg.name], i), entry)

    with torch.no_grad():
        hs, _, _ = _forward_full_group(ps, cfg, batches, ctxs, backend,
                                       False, collect)
        logits = lm_head_group([p["embed"] for p in ps], cfg, ctxs,
                               last_position(
                                   _pass_ctxs(ctxs, batches, "tokens"), hs))
    return [x[:, 0] for x in logits], caches


def upcast_prefill_logits(params, cfg: ModelConfig, batch,
                          vocab_chunk: Optional[int] = 1 << 14):
    """The last position's logits of ``prefill`` on ``params`` cast to f32
    on the plain versions (the f32 twin of a bf16 model) without an f32
    copy of the tree: ``forward_full(cast=)`` casts one layer at a time,
    and the LM head casts its weight ``vocab_chunk`` columns at a time
    (all at once for None).  A cast up is exact, so this is the function
    of ``prefill`` on the whole tree cast up front."""
    cfg = cfg.replace(param_dtype="float32", act_dtype="float32")
    h, _, _ = forward_full(params, cfg, batch, backend="plain",
                           cast=torch.float32)
    return lm_head(params["embed"], cfg, h[:, -1:],
                   vocab_chunk=vocab_chunk)[:, 0]


def _write_state(cache, state):
    """In place: copy a block's new recurrent state into its cache views."""
    for key, val in state.items():
        cache[key].copy_(val)


def decode_step(params, cfg: ModelConfig, caches, tokens, pos,
                backend: str = "kernel", ctxs=None):
    """One decode step.  tokens (B,), pos int or (B,) tensor.  Returns
    (logits, caches); the caches are updated in place.

    ``ctxs`` (a group's ``layers.GroupCtx`` list, the rules of a decode
    cell): the step over a device group — ``params``, ``caches`` and
    ``tokens`` per slot (the slot's shards, its caches as
    :func:`slot_decode_caches` lays them out, its rows' ids; ``pos`` an int
    or a per-slot list).  Each layer runs its block's group form
    (``blocks.*_decode_group``; the MoE over the whole batch): a slot that
    holds a ``kv_time`` shard writes the token only where it owns the
    position, and its attention merges K1's partials over its time row.
    Returns (per-slot logits of the whole vocabulary, per-slot caches)."""
    if ctxs is not None:
        return _decode_step_group(params, cfg, caches, tokens, pos, backend,
                                  ctxs)
    h = embed_tokens(params["embed"], cfg, tokens[:, None])
    emb0 = h
    Bsz = tokens.shape[0]
    if isinstance(pos, torch.Tensor):
        pos_t = pos.reshape(-1).expand(Bsz)
    else:
        pos_t = torch.full((Bsz,), int(pos), device=tokens.device)
    for seg in stack_plan(cfg):
        if seg.kind == "enc":
            continue  # no decode-time work: the cross K/V are cached
        seg_params = params["segments"][seg.name]
        cache = caches[seg.name]
        seg_cfg, kind = B.resolve_kind(cfg, seg.kind)
        for i in range(seg.n):
            p, c = layer_params(seg_params, i), layer_params(cache, i)
            if kind == "decoder":
                h, _ = B.decoder_block_decode(p, seg_cfg, h, c, pos_t, i,
                                              backend=backend)
            elif seg.kind == "dec":
                h, _ = B.cross_decoder_block_decode(p, cfg, h, c, pos_t,
                                                    backend=backend)
            elif seg.kind in ("rwkv", "mamba"):
                blk = (B.rwkv_block_decode if seg.kind == "rwkv"
                       else B.mamba_block_decode)
                h, st = blk(p, cfg, h, c)
                _write_state(c, st)
            else:  # mega
                for j in range(seg.blocks_per_step):
                    cj = layer_params(c["mamba"], j)
                    h, st = B.mamba_block_decode(
                        layer_params(p["mamba"], j), cfg, h, cj)
                    _write_state(cj, st)
                h, _ = B.zamba_shared_decode(params["shared"], cfg, h, emb0,
                                             c["attn"], pos_t,
                                             backend=backend)
    logits = lm_head(params["embed"], cfg, h)
    return logits[:, 0], caches


def _decode_layer_group(cfg: ModelConfig, seg: SegmentSpec, pl, cl, ctxs, hs,
                        poss, layer_idx: int, backend: str, shared=None,
                        emb0s=None):
    """One step of segment ``seg`` of the group ``decode_step`` (``pl`` /
    ``cl``: each slot's layer params and caches, written in place).
    Returns per-slot h."""
    c, kind = B.resolve_kind(cfg, seg.kind)
    if kind == "decoder":
        return B.decoder_block_decode_group(pl, c, ctxs, hs, cl, poss,
                                            layer_idx, backend=backend,
                                            batch_moe=True)
    if seg.kind == "dec":
        return B.cross_decoder_block_decode_group(pl, cfg, ctxs, hs, cl,
                                                  poss, backend=backend)
    if seg.kind in ("rwkv", "mamba"):
        blk = (B.rwkv_block_decode_group if seg.kind == "rwkv"
               else B.mamba_block_decode_group)
        hs, states = blk(pl, cfg, ctxs, hs, cl)
        for c, st in zip(cl, states):
            _write_state(c, st)
        return hs
    for j, pj in enumerate(_slot_layers(pl, "mamba", seg.blocks_per_step)):
        cj = [layer_params(c["mamba"], j) for c in cl]
        hs, states = B.mamba_block_decode_group(pj, cfg, ctxs, hs, cj)
        for c, st in zip(cj, states):
            _write_state(c, st)
    return B.zamba_shared_decode_group(shared, cfg, ctxs, hs, emb0s,
                                       [c["attn"] for c in cl], poss,
                                       backend=backend)


def _decode_step_group(ps, cfg: ModelConfig, caches, tokens, pos,
                       backend: str, ctxs):
    """:func:`decode_step` over a group (see there)."""
    from repro_torch.models.layers import embed_tokens_group, lm_head_group

    hs = emb0s = embed_tokens_group([p["embed"] for p in ps], cfg, ctxs,
                                    [t[:, None] for t in tokens])
    poss = []
    for k, t in enumerate(tokens):
        p = pos[k] if isinstance(pos, (list, tuple)) else pos
        poss.append(p.reshape(-1).expand(t.shape[0])
                    if isinstance(p, torch.Tensor) else
                    torch.full((t.shape[0],), int(p), device=t.device))
    shared = [p.get("shared") for p in ps]
    with torch.no_grad():
        for seg in stack_plan(cfg):
            if seg.kind == "enc":
                continue  # no decode-time work: the cross K/V are cached
            layers = _slot_layers([p["segments"] for p in ps], seg.name,
                                  seg.n)
            for i, pl in enumerate(layers):
                cl = [layer_params(c[seg.name], i) for c in caches]
                hs = _decode_layer_group(cfg, seg, pl, cl, ctxs, hs, poss, i,
                                         backend, shared, emb0s)
        logits = lm_head_group([p["embed"] for p in ps], cfg, ctxs, hs)
    return [x[:, 0] for x in logits], caches


def recurrent_state(cfg: ModelConfig, kind: str, lead, device):
    """Zero recurrent state leaves (f32) of one block kind, with stacked
    ``lead`` dims (layers, rows, ...)."""
    f32 = torch.float32
    if kind == "rwkv":
        h, hd = cfg.ssm_heads, cfg.ssm_head_dim
        return {"wkv": torch.zeros(lead + (h, hd, hd), dtype=f32,
                                   device=device),
                "shift_tm": torch.zeros(lead + (cfg.d_model,), dtype=f32,
                                        device=device),
                "shift_cm": torch.zeros(lead + (cfg.d_model,), dtype=f32,
                                        device=device)}
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {"ssm": torch.zeros(lead + (cfg.ssm_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state), dtype=f32,
                               device=device),
            "conv": torch.zeros(lead + (cfg.conv_width - 1, conv_dim),
                                dtype=f32, device=device)}


def init_decode_caches(cfg: ModelConfig, batch_size: int, cache_len: int,
                       enc_len: Optional[int] = None, device="cuda"):
    """Zero-initialised cache tree for decode at a given cache length (an
    MLA layer's latent and krope as views of one buffer; an enc-dec
    stack's cross K/V at ``enc_len`` positions, ``cache_len`` without)."""
    def kv(n):
        if cfg.attn_kind == "mla":
            lora = cfg.kv_lora_rank
            return mla_cache_views(torch.zeros(
                (n, batch_size, cache_len, lora + cfg.rope_head_dim),
                dtype=param_dtype(cfg), device=device), lora)
        shape = (n, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=param_dtype(cfg),
                                 device=device),
                "v": torch.zeros(shape, dtype=param_dtype(cfg),
                                 device=device)}

    caches: Dict = {}
    for seg in stack_plan(cfg):
        if B.resolve_kind(cfg, seg.kind)[1] == "decoder":
            caches[seg.name] = kv(seg.n)
        elif seg.kind == "dec":
            ckv = (seg.n, batch_size, enc_len or cache_len, cfg.n_kv_heads,
                   cfg.head_dim)
            caches[seg.name] = dict(kv(seg.n), **{
                key: torch.zeros(ckv, dtype=param_dtype(cfg), device=device)
                for key in ("ck", "cv")})
        elif seg.kind == "enc":
            continue
        elif seg.kind in ("rwkv", "mamba"):
            caches[seg.name] = recurrent_state(cfg, seg.kind,
                                                (seg.n, batch_size), device)
        else:  # mega
            caches[seg.name] = {
                "mamba": recurrent_state(
                    cfg, "mamba", (seg.n, seg.blocks_per_step, batch_size),
                    device),
                "attn": kv(seg.n)}
    return caches
