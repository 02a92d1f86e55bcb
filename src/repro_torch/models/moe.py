"""Mixture-of-Experts FFN: top-k token-choice routing with capacity
dispatch — the counterpart of the reference's ``repro/models/moe.py``.

Dispatch is sort-based, as in the reference: a stable argsort by expert id
groups the (token, choice) pairs, each expert keeps its first ``C`` of them
(``_capacity``), the kept tokens are gathered into an ``(E, C, d)`` buffer,
the expert SwiGLU runs as three batched products, and each token sums its
kept slots' weighted outputs.  Tokens beyond an expert's capacity are
dropped; the residual carries them through.

``per_row=True`` is the engine's pooled layout.  The reference's pooled
steps ``vmap`` a batch-1 block over the pool rows, so each row routes
alone: its own capacity from its own token count ``T`` (1 in decode), and
no other row's tokens (a masked row's garbage included) can take its
slots.  Here the rows are a real batch, so the dispatch ranks within each
(row, expert) pair — a stable sort on ``row * E + expert`` — into an
``(E, rows * C, d)`` buffer.  ``per_row=False`` (the monolithic
``prefill`` / ``decode_step``) pools the whole batch, as the reference
does outside the engine.

Determinism and the host: the combine gathers each token's ``k`` slots and
adds them in ascending slot order (the reference's scatter-add order), not
with ``index_add_``, whose CUDA atomics change the float order from run to
run.  Counts come from ``scatter_add_`` and the capacity from sizes only,
so nothing here reads a device value on the host.

The expert products are plain ``torch.bmm`` calls: the reference computes
them outside any Pallas kernel.

Device groups (``layers.GroupCtx``; the slots' tensors as lists in slot
order).  ``apply_moe_group`` is the per-row layout on a group: each slot
routes its rows (a model row's slots route the same rows alike), every
slot runs its expert block — experts over the axes the ``experts`` rule
names, the expert FFN's columns over ``model`` where ``expert_mlp`` says
so (Llama-4-Scout: experts over ``data``, FFN over ``model``) — on the
tokens every row block sends it, and each slot gathers its rows' expert
outputs back, adding the FFN shards' partials in slot order.
``_apply_moe_ep`` is the reference's pure EP over the whole group with
padded experts (DeepSeek): each slot routes its own tokens with a local
capacity, sends each expert block's slots to the slot that holds it, and
takes the outputs back — the all-to-all as per-slot sends in slot order;
``_ep_eligible`` is its gate.  ``apply_moe_batch_group`` is the
training step's: the whole-batch routing of ``apply_moe`` over the data
slots' rows (capacity positions and the aux terms summed over the data
slots), each expert holder running the kept tokens of every row block.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamBuilder, param_dtype,
                                       reduce_model, reduce_out, row_heads)

EP_PAD_GROUP = 256  # pad expert allocation to the full-chip EP group size
EP_MIN_EXPERTS = 64  # only pad expert-rich archs


def expert_alloc(E: int) -> int:
    """Experts allocated in the weights: padded to a multiple of 256 for
    archs with many experts (deepseek 160 -> 256; the dummy experts receive
    no tokens); small-E archs stay unpadded."""
    if E >= EP_MIN_EXPERTS:
        return ((E + EP_PAD_GROUP - 1) // EP_PAD_GROUP) * EP_PAD_GROUP
    return E


def init_moe(pb: ParamBuilder, cfg: ModelConfig):
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    Ea = expert_alloc(E)
    dt = param_dtype(cfg)
    c = pb.child()
    c.dense("router", (d, E), torch.float32)
    c.dense("wg", (Ea, d, f), dt)
    c.dense("wu", (Ea, d, f), dt)
    c.dense("wo", (Ea, f, d), dt)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        c.dense("swg", (d, fs), dt)
        c.dense("swu", (d, fs), dt)
        c.dense("swo", (fs, d), dt)
    return c.params


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(np.ceil(n_tokens * cfg.moe_top_k / cfg.n_experts
                    * cfg.capacity_factor))
    return max(8, int(np.ceil(c / 8) * 8))  # pad to a multiple of 8


def _top_k(probs, k: int):
    """``jax.lax.top_k`` order: descending, the lower index first on ties
    (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(params, cfg: ModelConfig, xf):
    """Softmax router with renormalised top-k weights.  xf: (N, d)."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, cfg.moe_top_k)  # (N, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return top_w, top_e, probs


def _sort_dispatch(xf, top_w, top_e, E_slots: int, C: int, rows: int = 1,
                   before=None):
    """Sort-based capacity dispatch of ``rows`` independent row groups of
    ``T = N / rows`` tokens each.  xf (N, d); top_w/top_e (N, k).
    ``before`` (E_slots,): each expert's choices that precede these tokens
    in a larger batch sharing the capacity (its first positions are
    theirs; ``rows`` 1).

    Returns (xe (E_slots, rows * C, d), slot_of (N, k) — each choice's slot
    in the flattened buffer, ``E_slots * rows * C`` where dropped —,
    slot_weight (E_slots * rows * C,), counts (rows, E_slots), kept (rows,)).
    Slot ``e * rows * C + r * C + i`` holds the i-th token of row ``r``
    routed to expert ``e``, in (token, choice) order."""
    N, d = xf.shape
    k = top_e.shape[-1]
    T = N // rows
    dev = xf.device
    n_slots = E_slots * rows * C
    token_flat = torch.arange(N, device=dev).repeat_interleave(k)
    key = (token_flat // T) * E_slots + top_e.reshape(-1)  # row * E + e
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    counts = torch.zeros(rows * E_slots, dtype=torch.long, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * k, device=dev) - starts[sorted_key]
    r_s, e_s = sorted_key // E_slots, sorted_key % E_slots
    if before is not None:
        rank = rank + before[e_s]
    keep = rank < C
    slot = torch.where(keep, e_s * (rows * C) + r_s * C + rank, n_slots)
    slot_token = torch.full((n_slots + 1,), N, dtype=torch.long, device=dev)
    slot_token.scatter_(0, slot, token_flat[order])
    slot_weight = torch.zeros((n_slots + 1,), dtype=torch.float32,
                              device=dev)
    slot_weight.scatter_(0, slot, top_w.reshape(-1)[order].float())
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = x_pad[slot_token[:n_slots]].reshape(E_slots, rows * C, d)
    counts = counts.reshape(rows, E_slots)
    kept = torch.zeros(rows, dtype=torch.long, device=dev).scatter_add_(
        0, r_s, keep.long())
    return xe, slot_of.reshape(N, k), slot_weight[:n_slots], counts, kept


def _combine(ye, slot_of, slot_weight):
    """out[t] = sum of its kept slots' weighted outputs, added in ascending
    slot order starting from zero (the reference's scatter-add order);
    dropped choices add an exact zero."""
    d = ye.shape[-1]
    yf = ye.reshape(-1, d) * slot_weight[:, None].to(ye.dtype)
    yf = torch.cat([yf, yf.new_zeros((1, d))], dim=0)
    slots = torch.sort(slot_of, dim=-1).values
    out = ye.new_zeros((slot_of.shape[0], d))
    for j in range(slots.shape[1]):
        out = out + yf[slots[:, j]]
    return out


def _expert_mlp(xe, wg, wu, wo):
    g = F.silu(torch.bmm(xe, wg.to(xe.dtype)))
    u = torch.bmm(xe, wu.to(xe.dtype))
    return torch.bmm(g * u, wo.to(xe.dtype))


def _shared_expert(params, cfg: ModelConfig, x, out):
    if cfg.n_shared_experts:
        gs = F.silu(x @ params["swg"].to(x.dtype))
        us = x @ params["swu"].to(x.dtype)
        out = out + (gs * us) @ params["swo"].to(x.dtype)
    return out


def apply_moe(params, cfg: ModelConfig, x, per_row: bool = False):
    """x (B, S, d) -> (out (B, S, d), aux): routed top-k experts plus the
    optional shared expert.

    ``per_row``: route each of the B rows alone, with the capacity of its
    S tokens (the engine's pooled steps; the reference vmaps its rows
    there); otherwise the B * S tokens share one capacity.  ``aux`` holds
    the load-balancing loss and the dropped share of the (token, choice)
    pairs — 0-d tensors, or (B,) per row under ``per_row``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    rows = B if per_row else 1
    T = B * S // rows
    C = _capacity(cfg, T)
    xf = x.reshape(B * S, d)
    top_w, top_e, probs = router_topk(params, cfg, xf)
    xe, slot_of, slot_weight, counts, kept = _sort_dispatch(
        xf, top_w, top_e, E, C, rows)
    ye = _expert_mlp(xe, params["wg"][:E], params["wu"][:E],
                     params["wo"][:E])
    out = _combine(ye, slot_of, slot_weight).reshape(B, S, d)
    out = _shared_expert(params, cfg, x, out)
    n_choices = max(T * k, 1)
    frac = counts.float() / n_choices
    mean_prob = probs.reshape(rows, T, E).mean(dim=1)
    aux = {"moe_aux_loss": E * (frac * mean_prob).sum(dim=-1),
           "moe_drop_frac": 1.0 - kept.float() / n_choices}
    if not per_row:
        aux = {key: v[0] for key, v in aux.items()}
    return out, aux


# ---------------------------------------------------------------------------
# Device groups
# ---------------------------------------------------------------------------


def _expert_block(ctx, cfg: ModelConfig, n_local: int):
    """First expert index of a slot's ``n_local`` expert weights."""
    if n_local == expert_alloc(cfg.n_experts):
        return 0
    return ctx.block("experts")[0] * n_local


def _holder(ctx, b: int, n_blocks: int, f: Optional[int]) -> int:
    """The slot holding expert block ``b`` (of ``n_blocks``) and FFN shard
    ``f`` that serves ``ctx``'s rows: the expert and FFN axes from the
    block and shard, every other axis from ``ctx``."""
    coords = {}
    if n_blocks > 1:
        ax = ctx.rules.get("experts")
        axes = ax if isinstance(ax, tuple) else (ax,)
        for a in reversed(axes):
            b, coords[a] = divmod(b, ctx.sizes[a])
    if f is not None:
        coords["model"] = f
    return ctx.slot_at(**coords)


def _shared_expert_group(ps, cfg: ModelConfig, ctxs, xs, outs,
                         block: bool = False):
    """``outs`` plus the shared expert of ``xs`` (whole sequences), its
    column-split partials summed over the model row; ``block``: ``outs``
    are the slots' ``seq`` blocks, and the shared expert's sum is
    reduce-scattered onto them (``layers.reduce_out``)."""
    if not cfg.n_shared_experts:
        return outs
    parts = [(F.silu(x @ p["swg"].to(x.dtype)) * (x @ p["swu"].to(x.dtype)))
             @ p["swo"].to(x.dtype) for p, x in zip(ps, xs)]
    split = ps[0]["swo"].shape[0] < cfg.d_ff_expert * cfg.n_shared_experts
    if block:
        parts = reduce_out(ctxs, parts, split)
    elif split:
        parts = reduce_model(ctxs, parts)
    return [o + y for o, y in zip(outs, parts)]


def apply_moe_group(ps, cfg: ModelConfig, ctxs, xs, rows_split: bool):
    """Per-row MoE on a device group (``apply_moe(per_row=True)`` of the
    group's rows).  ``ps``: per-slot FFN params; ``xs``: per-slot (B_i,
    S, d) rows — row block ``i`` on the slots of data index ``i`` when
    ``rows_split``, else every row on every slot.  Returns per-slot
    outputs like ``xs``."""
    E = cfg.n_experts
    n_local = ps[0]["wg"].shape[0]
    f_split = ps[0]["wg"].shape[-1] < cfg.d_ff_expert
    disp = []
    for p, x in zip(ps, xs):
        B, S, d = x.shape
        xf = x.reshape(B * S, d)
        top_w, top_e, _ = router_topk(p, cfg, xf)
        disp.append(_sort_dispatch(xf, top_w, top_e, E,
                                   _capacity(cfg, S), B)[:3])
    ye = []
    for s, (p, c) in enumerate(zip(ps, ctxs)):
        e0 = _expert_block(c, cfg, n_local)
        n = max(0, min(n_local, E - e0))
        srcs = ([c.slot_at(data=i) for i in range(c.n_data)] if rows_split
                else [s])
        ye.append(None if n == 0 else _expert_mlp(
            torch.cat([c.receive(disp[t][0][e0:e0 + n], t) for t in srcs],
                      dim=1),
            p["wg"][:n], p["wu"][:n], p["wo"][:n]))
    n_blocks = expert_alloc(E) // n_local
    outs = []
    for s, (c, x) in enumerate(zip(ctxs, xs)):
        xe, slot_of, slot_weight = disp[s]
        width = xe.shape[1]
        off = c.i * width if rows_split else 0
        blocks = []
        for b in range(-(-E // n_local)):
            parts = [ye[_holder(c, b, n_blocks, f)][:, off:off + width]
                     for f in (range(c.n_model) if f_split else [None])]
            blocks.append(c.all_reduce_sum(parts) if f_split else
                          c.receive(parts[0], _holder(c, b, n_blocks, None)))
        y = torch.cat(blocks, dim=0)
        outs.append(_combine(y, slot_of, slot_weight).reshape(x.shape))
    return _shared_expert_group(ps, cfg, ctxs, xs, outs)


def apply_moe_batch_group(ps, cfg: ModelConfig, ctxs, xs):
    """``apply_moe`` of the whole batch on a group, the training step's
    MoE (and the group forms of ``prefill`` / ``decode_step``): ``xs``
    per-slot (B_l, S, d) rows, each slot's block of the batch rows
    (``GroupCtx.row_block``; every model slot of a row block routes its
    rows alike).  The routing is the global batch's, as the reference's
    shardings leave it: the capacity is that of all B * S tokens, each
    expert's capacity positions run over the row blocks in row order (a
    slot's local rank plus the counts of the row blocks before it,
    gathered over its ``row_column``), the expert holders take the kept
    tokens of every row block (of their pod, where the experts replicate
    over pods), and the aux loss and drop fraction come from the
    per-expert counts and router probabilities summed over the row
    blocks.  Returns (per-slot outputs like ``xs``, aux) — aux on slot
    0's device."""
    E, k = cfg.n_experts, cfg.moe_top_k
    n_local = ps[0]["wg"].shape[0]
    f_split = ps[0]["wg"].shape[-1] < cfg.d_ff_expert
    T_l = xs[0].shape[0] * xs[0].shape[1]
    T = T_l * ctxs[0].row_block()[1]
    pods = "pod" in ctxs[0]._axes("experts")
    C = _capacity(cfg, T)
    routed = []
    for p, x in zip(ps, xs):
        xf = x.reshape(T_l, x.shape[-1])
        top_w, top_e, probs = router_topk(p, cfg, xf)
        key = top_e.reshape(-1)
        counts = torch.zeros(E, dtype=torch.long, device=x.device)
        routed.append((xf, top_w, top_e, probs,
                       counts.scatter_add_(0, key, torch.ones_like(key))))
    disp = []
    for c, (xf, top_w, top_e, _, _) in zip(ctxs, routed):
        # each expert's choices on the earlier row blocks come first
        col = c.all_gather([r[4][None] for r in c.peers(routed,
                                                        c.row_column())],
                           dim=0)
        xe, slot_of, slot_weight, _, kept = _sort_dispatch(
            xf, top_w, top_e, E, C, before=col[:c.row_block()[0]].sum(dim=0))
        disp.append((xe, slot_of, slot_weight, kept[0], col.sum(dim=0)))
    ye = []
    for p, c in zip(ps, ctxs):
        e0 = _expert_block(c, cfg, n_local)
        n = max(0, min(n_local, E - e0))
        # the kept tokens of every row block (disjoint buffer positions)
        srcs = c.line(tuple(a for a in c._axes("batch")
                            if pods or a != "pod"))
        ye.append(None if n == 0 else _expert_mlp(
            sum(c.receive(d[0][e0:e0 + n], t)
                for t, d in zip(srcs, c.peers(disp, srcs))),
            p["wg"][:n], p["wu"][:n], p["wo"][:n]))
    n_blocks = expert_alloc(E) // n_local
    outs = []
    for s, (c, x) in enumerate(zip(ctxs, xs)):
        _, slot_of, slot_weight, _, _ = disp[s]
        blocks = []
        for b in range(-(-E // n_local)):
            parts = c.peers(ye, [_holder(c, b, n_blocks, f) for f in
                                 (range(c.n_model) if f_split else [None])])
            blocks.append(c.all_reduce_sum(parts) if f_split else
                          c.receive(parts[0], _holder(c, b, n_blocks, None)))
        y = torch.cat(blocks, dim=0)
        outs.append(_combine(y, slot_of, slot_weight).reshape(x.shape))
    outs = _shared_expert_group(ps, cfg, ctxs, xs, outs)
    c0 = ctxs[0]
    heads = row_heads(ctxs)
    counts = c0.to_here(disp[0][4]).float()
    kept = sum(c0.to_here(d[3].float()) for d in c0.peers(disp, heads))
    mean_prob = sum(c0.to_here(r[3].sum(dim=0))
                    for r in c0.peers(routed, heads)) / T
    n_choices = max(T * k, 1)
    aux = {"moe_aux_loss": E * (counts / n_choices * mean_prob).sum(),
           "moe_drop_frac": 1.0 - kept / n_choices}
    return outs, aux


def _ep_eligible(params, cfg: ModelConfig, ctx, x) -> bool:
    """The pure-EP path serves: a group, padded expert weights, and a
    (batch, seq) token grid the (data, model) slots divide."""
    return params["wg"].shape[0] != cfg.n_experts and \
        ep_grid(ctx, x.shape[0], x.shape[1])


def ep_grid(ctx, B: int, S: int) -> bool:
    """A group whose (pod, data) x model slots divide a (B, S) token grid,
    its rows over ``batch``: the reference's ``_ep_eligible`` but for its
    test of padded expert weights."""
    if ctx.mesh is None:
        return False
    n_data = ctx.sizes.get("pod", 1) * ctx.n_data
    return (S % ctx.n_model == 0 and B % n_data == 0
            and ctx.rules.get("batch") is not None)


def _apply_moe_ep(ps, cfg: ModelConfig, ctxs, xs):
    """Pure expert parallelism over each pod's (data, model) slots (the
    reference's shard_map body, its all-to-alls over those axes).
    ``ps``: per-slot params, each holding its block of ``E_alloc /
    n_ep`` padded experts whole; ``xs``: per-slot (B_l, S_l, d) tokens,
    each slot's own.  Each slot routes its tokens with the capacity of
    its ``T_l`` tokens, sends expert block ``t``'s slots to the pod's
    slot ``t`` (ascending source order), runs its experts and sends the
    outputs back.  Returns (per-slot routed outputs, aux) — aux over every
    slot's tokens, on slot 0's device; no shared expert."""
    E, k = cfg.n_experts, cfg.moe_top_k
    E_per = ps[0]["wg"].shape[0]
    ep_axes = tuple(a for a in ("data", "model") if a in ctxs[0].sizes)
    disp = []
    for p, c, x in zip(ps, ctxs, xs):
        T_l = x.shape[0] * x.shape[1]
        xf = x.reshape(T_l, x.shape[-1])
        top_w, top_e, probs = router_topk(p, cfg, xf)
        C = max(8, int(np.ceil(T_l * k / E * cfg.capacity_factor / 8) * 8))
        n_ep = len(c.line(ep_axes))
        disp.append(_sort_dispatch(xf, top_w, top_e, E_per * n_ep, C)
                    + (probs, T_l * k))
    ye = []
    for p, c in zip(ps, ctxs):
        grp = c.line(ep_axes)
        t = grp.index(c.slot)
        ye.append(_expert_mlp(torch.cat(
            [c.receive(d[0][t * E_per:(t + 1) * E_per], s)
             for s, d in zip(grp, c.peers(disp, grp))], dim=1),
            p["wg"], p["wu"], p["wo"]))
    outs = []
    for c, x, d in zip(ctxs, xs, disp):
        grp = c.line(ep_axes)
        s, C = grp.index(c.slot), d[0].shape[1]
        ret = torch.cat([c.receive(y[:, s * C:(s + 1) * C], t)
                         for t, y in zip(grp, c.peers(ye, grp))], dim=0)
        outs.append(_combine(ret, d[1], d[2]).reshape(x.shape))
    c0 = ctxs[0]
    every = c0.peers(disp, range(c0.mesh.devices.size))
    tot = float(max(sum(d[6] for d in every), 1))
    counts = sum(c0.to_here(d[3][0, :E].float()) for d in every)
    mean_prob = sum(c0.to_here(d[5].mean(dim=0)) for d in every) / len(every)
    kept = sum(c0.to_here(d[4][0].float()) for d in every)
    aux = {"moe_aux_loss": E * (counts / tot * mean_prob).sum(),
           "moe_drop_frac": 1.0 - kept / tot}
    return outs, aux


__all__ = ["EP_MIN_EXPERTS", "EP_PAD_GROUP", "apply_moe",
           "apply_moe_batch_group", "apply_moe_group", "expert_alloc",
           "init_moe", "router_topk"]
