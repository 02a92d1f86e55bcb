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

DeepSeek-V2's published options (``ModelConfig``; all off by default, and
the reference has none of them): group-limited greedy routing
(``moe_n_group`` / ``moe_topk_group``: each group of experts scores its
best member, the top groups are kept and the top-k taken inside them),
the chosen softmax weights scaled by ``moe_routed_scale`` instead of
renormalised (``moe_norm_topk`` False), and ``moe_dropless``: every
(token, expert) choice is computed whatever the load.  The dropless layer
sorts the choices by expert and runs the grouped expert products
(``kernels.moe_experts.grouped_experts``) over them, the offsets counted
on the device, so it syncs nothing and runs no expert that no token
chose; a token's output is its own choices' weighted sum, whatever else
the call holds, so ``per_row`` changes nothing there.  Its weights are
not padded (``init_moe``): a solo server holds ``n_experts``.

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
training step's: the whole-batch routing of ``apply_moe`` over the slots'
token blocks (their rows, and under ``seq_act`` their positions), each
choice ranked at its token's global index, each source putting only its
kept rows into the holders' (n_local, C, d) blocks and taking back only
their outputs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moe_experts
from repro_torch.kernels.runtime import use_kernel
from repro_torch.launch.costs import collective_ops
from repro_torch.models.layers import (ParamBuilder, gather_seq, param_dtype,
                                       reduce_model, reduce_out)

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
    Ea = E if cfg.moe_dropless else expert_alloc(E)
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
    """Softmax router (f32) with renormalised top-k weights, or, with
    ``moe_norm_topk`` off, the chosen softmax weights times
    ``moe_routed_scale``; with ``moe_n_group``, group-limited greedy:
    the top-k is taken among the experts of the ``moe_topk_group`` groups
    whose best member scores highest.  xf: (N, d)."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    scores = probs
    if cfg.moe_n_group:
        N, E = probs.shape
        per = E // cfg.moe_n_group
        best = probs.reshape(N, cfg.moe_n_group, per).amax(dim=-1)
        kept = _top_k(best, cfg.moe_topk_group)[1]
        keep = torch.zeros_like(best, dtype=torch.bool).scatter_(1, kept,
                                                                 True)
        scores = probs.masked_fill(
            ~keep.repeat_interleave(per, dim=1), 0.0)
    top_w, top_e = _top_k(scores, cfg.moe_top_k)  # (N, k)
    if cfg.moe_norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    else:
        top_w = top_w * cfg.moe_routed_scale
    return top_w, top_e, probs


def _sort_dispatch(xf, top_w, top_e, E_slots: int, C: int, rows: int = 1):
    """Sort-based capacity dispatch of ``rows`` independent row groups of
    ``T = N / rows`` tokens each.  xf (N, d); top_w/top_e (N, k).

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


def apply_moe(params, cfg: ModelConfig, x, per_row: bool = False,
              backend: str = "kernel", with_aux: bool = True):
    """x (B, S, d) -> (out (B, S, d), aux): routed top-k experts plus the
    optional shared expert.

    ``per_row``: route each of the B rows alone, with the capacity of its
    S tokens (the engine's pooled steps; the reference vmaps its rows
    there); otherwise the B * S tokens share one capacity.  ``aux`` holds
    the load-balancing loss and the dropped share of the (token, choice)
    pairs — 0-d tensors, or (B,) per row under ``per_row``.
    ``moe_dropless`` configs take :func:`apply_moe_dropless` (``backend``:
    its expert products on the card's grouped GEMM, or the plain loop;
    ``with_aux`` False: no aux terms, as serving reads none)."""
    if cfg.moe_dropless:
        return apply_moe_dropless(params, cfg, x, per_row, backend,
                                  with_aux)
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


def apply_moe_dropless(params, cfg: ModelConfig, x, per_row: bool = False,
                       backend: str = "kernel", with_aux: bool = True):
    """:func:`apply_moe` with every (token, choice) pair computed: the N k
    choices sorted by expert (stable, so in (token, choice) order within
    an expert), their rows gathered, each expert's SwiGLU over its rows
    alone (``kernels.moe_experts``: the grouped GEMM on the card under the
    kernel backend, else the plain loop), the outputs put back in (token,
    choice) order and each token's choices summed in f32 with their
    weights.  Nothing is dropped, so ``moe_drop_frac`` is 0; ``per_row``
    shapes the aux terms only, which ``with_aux`` False leaves out."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    N = B * S
    xf = x.reshape(N, d)
    top_w, top_e, probs = router_topk(params, cfg, xf)
    e = top_e.reshape(-1)
    order = torch.argsort(e, stable=True)
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, e, torch.ones_like(e, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    rows = xf[order // k]
    w = (params["wg"], params["wu"], params["wo"])
    if use_kernel(backend, x):
        ys = moe_experts.grouped_experts(rows, *w, offs)
    else:
        ys = moe_experts.grouped_experts_ref(rows, *w, offs)
    y = torch.empty_like(ys)
    y[order] = ys
    out = (y.reshape(N, k, d).float() * top_w[..., None]).sum(dim=1)
    out = _shared_expert(params, cfg, x, out.to(x.dtype).reshape(B, S, d))
    if not with_aux:
        return out, {}
    rows_n = B if per_row else 1
    T = N // rows_n
    key = (torch.arange(N, device=x.device).repeat_interleave(k) // T) * E \
        + e
    per = torch.zeros(rows_n * E, dtype=torch.float32, device=x.device)
    per.scatter_add_(0, key, torch.ones_like(key, dtype=torch.float32))
    frac = per.reshape(rows_n, E) / max(T * k, 1)
    mean_prob = probs.reshape(rows_n, T, E).mean(dim=1)
    aux = {"moe_aux_loss": E * (frac * mean_prob).sum(dim=-1),
           "moe_drop_frac": torch.zeros(rows_n, device=x.device)}
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
    """``apply_moe`` of the whole batch on a group: the training step's MoE
    and the group forms of ``prefill`` / ``decode_step``.  ``xs``: per
    slot, its tokens (B_l, S_l, d): its block of the batch rows
    (``GroupCtx.row_block``) and, under ``seq_act``, its own block of
    their positions (``GroupCtx.seq``), else every position (a model
    row's slots then route alike).

    The routing is the whole batch's, as the reference's shardings leave
    it: the capacity is that of all B * S tokens, and each (token, choice)
    takes its expert's capacity position at the token's global (row,
    position) index — its rank among its row's choices of the expert on
    this slot, after those of every earlier row and of the slots holding
    the row's earlier positions (the token blocks' per-(row, expert)
    counts, gathered).  Each expert holder's (n_local, C, d) block (the
    reference's ``xe`` split over ``experts``) takes from each source
    only its kept rows of the holder's experts, put at their positions;
    the holder runs its experts on the block, the holders of a block add
    their FFN shards' partial sums over the model row in slot order, and
    each source takes back only its kept rows' outputs, from the holder
    at its model index, and combines them.  The shared expert runs on
    the whole sequence, cut (or reduce-scattered) to the slot's block.
    The aux loss and drop fraction come from the per-expert counts, kept
    choices and router probabilities summed over the token blocks.
    Returns (per-slot outputs like ``xs``, aux) — aux on slot 0's
    device.

    Shapes come from sizes alone, so nothing syncs: a source's put and
    take run over all its (token, choice) pairs, the ones it does not
    send landing on a spare row of the block (or reading a zero row).
    The count records what a put-based all-to-all moves, the kept rows
    (with their int64 positions on the way out), as device values
    (``layers.CollectiveCount``); on meta tensors (the dry run's count)
    every source is taken to fill its even share of each expert's
    capacity."""
    E, k = cfg.n_experts, cfg.moe_top_k
    c0 = ctxs[0]
    n_local = ps[0]["wg"].shape[0]
    n_blocks = expert_alloc(E) // n_local
    n_real = -(-E // n_local)  # the blocks that hold a routed expert
    f_split = ps[0]["wg"].shape[-1] < cfg.d_ff_expert
    split = c0.seq[1] > 1
    B_l, S_l, d = xs[0].shape
    N = B_l * S_l
    bax = c0._axes("batch")
    rank_axes = bax + (("model",) if split else ())
    n_tok = len(c0.line(rank_axes))
    T = N * n_tok
    C = _capacity(cfg, T)
    even = min(N * k // E, C // n_tok)
    m = min(k, n_local)  # the most choices a token has in one block
    pods = "pod" in c0._axes("experts")
    routed = []
    for p, x in zip(ps, xs):
        xf = x.reshape(N, d)
        top_w, top_e, probs = router_topk(p, cfg, xf)
        row = torch.arange(N, device=x.device).repeat_interleave(k) // S_l
        key = row * E + top_e.reshape(-1)
        cnt = torch.zeros(B_l * E, dtype=torch.long, device=x.device)
        routed.append((xf, top_w, key, probs,
                       cnt.scatter_add_(0, key, torch.ones_like(key))))
    disp = []
    for c, (xf, top_w, key, _, cnt) in zip(ctxs, routed):
        line = c.line(rank_axes)
        # the choices of each expert before each of this slot's rows: of
        # the earlier token blocks' rows, of this row on the earlier
        # position blocks
        G = c.all_gather([r[4][None] for r in c.peers(routed, line)],
                         dim=0).reshape(-1, c.seq[1], B_l, E)
        rb, j = divmod(line.index(c.slot), c.seq[1])
        row_tot = G[rb].sum(dim=0)
        before = (G[:rb].sum(dim=(0, 1, 2)) + torch.cumsum(row_tot, 0)
                  - row_tot + G[rb, :j].sum(dim=0)).reshape(-1)
        order = torch.argsort(key, stable=True)
        skey = key[order]
        pos = torch.empty_like(key)
        pos[order] = (torch.arange(N * k, device=xf.device)
                      - (torch.cumsum(cnt, 0) - cnt)[skey] + before[skey])
        e = key % E
        keep = pos < C
        # each choice's slot in the whole batch's (E, C) buffer; E * C
        # where it is dropped
        gslot = torch.where(keep, e * C + pos, E * C)
        q = {"xf": xf, "idx": [], "w": [], "sent": [],
             "kept": torch.zeros(E, dtype=torch.long,
                                 device=xf.device).scatter_add_(
                 0, e, keep.long()),
             "counts": G.sum(dim=(0, 1, 2))}
        w = top_w.float()
        for b in range(n_real):
            lo, hi = b * n_local * C, min((b + 1) * n_local, E) * C
            # each token's choices in block b, as rows of the block in
            # slot order (its spare row past them): m columns hold them
            idx = torch.where((gslot >= lo) & (gslot < hi), gslot - lo,
                              max(0, hi - lo)).reshape(N, k)
            w_b = w
            if k > 1:
                idx, col = torch.sort(idx, dim=1)
                idx, w_b = idx[:, :m], w.gather(1, col[:, :m])
            q["idx"].append(idx)
            q["w"].append(w_b)
            # the rows it sends block b: its kept choices of those experts
            q["sent"].append(max(0, min(n_local, E - b * n_local)) * even
                             if xf.is_meta else
                             q["kept"][b * n_local:(b + 1) * n_local].sum())
        disp.append(q)
    src_axes = tuple(a for a in bax if pods or a != "pod") + \
        (("model",) if split else ())
    ye = []
    for p, c in zip(ps, ctxs):
        e0 = _expert_block(c, cfg, n_local)
        n = max(0, min(n_local, E - e0))
        if n == 0:
            ye.append(None)
            continue
        b = e0 // n_local
        block = torch.zeros((n * C + 1, d), dtype=xs[0].dtype,
                            device=c.device)
        srcs = c.line(src_axes)
        for t, q in zip(srcs, c.peers(disp, srcs)):
            x = c.receive(q["xf"], t, "moe-dispatch",
                          q["sent"][b] * (d * q["xf"].element_size() + 8))
            idx = c.to_here(q["idx"][b])
            for i in range(idx.shape[1]):
                block.index_put_((idx[:, i],), x)
        y = _expert_mlp(block[:n * C].reshape(n, C, d), p["wg"][:n],
                        p["wu"][:n], p["wo"][:n]).reshape(n * C, d)
        ye.append(torch.cat([y, y.new_zeros((1, d))]))
    if f_split:
        # the FFN shards' partial sums, added over each block's model row
        # (the holders of a block hold the same rows), as the reference's
        # row-split expert projection all-reduces over ``model``
        ye = [c.all_reduce_sum(c.peers(ye, c.model_row())) for c in ctxs]
    outs = []
    for c, x, q in zip(ctxs, xs, disp):
        # each token adds its kept choices' weighted outputs in the order
        # of their slots in the whole batch's buffer (apply_moe's): block
        # by block, each block's in slot order; its other columns add 0.
        # Top-1: a token's one choice lies in one block, its output the
        # sum of the blocks' rows (zero rows elsewhere), weighted once
        out, y = x.new_zeros((N, d)), None
        for b in range(n_real):
            h = _holder(c, b, n_blocks, c.j if f_split else None)
            idx = q["idx"][b]
            yh = c.peers(ye, [h])[0]
            part = c.receive(yh[idx.reshape(-1).to(yh.device)], h,
                             "moe-return", q["sent"][b] * d * yh.element_size())
            if k == 1:
                y = part if y is None else y + part
                continue
            part = part.reshape(N, idx.shape[1], d)
            for i in range(idx.shape[1]):
                out = out + part[:, i] * q["w"][b][:, i, None].to(out.dtype)
        if k == 1:
            out = out + y * q["w"][0].to(out.dtype)
        outs.append(out.reshape(x.shape))
    whole = gather_seq(ctxs, xs) if split and cfg.n_shared_experts else xs
    outs = _shared_expert_group(ps, cfg, ctxs, whole, outs, block=split)
    line = c0.line(rank_axes)
    kept = sum(c0.to_here(q["kept"].sum().float())
               for q in c0.peers(disp, line))
    mean_prob = sum(c0.to_here(r[3].sum(dim=0))
                    for r in c0.peers(routed, line)) / T
    n_choices = max(T * k, 1)
    aux = {"moe_aux_loss": E * (disp[0]["counts"].float() / n_choices
                                * mean_prob).sum(),
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
           "apply_moe_batch_group", "apply_moe_dropless", "apply_moe_group",
           "expert_alloc",
           "init_moe", "router_topk"]
