"""Training step: loss and gradients (with remat), grad-accum
micro-batching, the optimizer update, and the int8-compressed all-reduce —
the counterparts of the reference's ``repro/training/train_step.py``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  It takes gradients with ``torch.autograd.grad`` over the param
leaves (``state["params"]`` need not require grad: the step differentiates
detached aliases of them), updates the params and the optimizer state in
place, and makes no host sync: the metrics stay on the device.

With ``sh`` (``launch.sharding.make_ctx`` of a device-group mesh) the step
runs over the group's slots (:class:`GroupLayout`): the state holds each
slot's shards (``init_train_state(..., sh=)``; ``embed_fsdp`` leaves split
over ``data`` (and ``pod``), heads / MLP / vocab over ``model``, experts
where the rules put them); a step all-gathers each slot's ``embed_fsdp``
shards over the slots the rule splits them over, takes the gradients of
every slot's leaves in one backward pass of ``models.train_loss(ctxs=)``,
sums each leaf's gradient over the slots that hold its block in slot order
(the data-parallel all-reduce, a reduce-scatter onto the ``embed_fsdp``
shards; a leaf split on ``head_dim`` over its data column), clips by the global norm with each element counted once, and
updates each slot's shard — AdamW's state mirroring the shards, Adafactor's
whole on every slot (its factored moments are means over a whole leaf)
with its update computed on each slot's block
(:meth:`GroupLayout.factored_update`) — so replicas stay bit-equal.  The
batch is per slot (``data.shard_batch(batch, mesh, sh)``).

``int8_allreduce`` is the reference's compressed gradient all-reduce over a
``torch.distributed`` process group: a reduce-scatter of int8 chunks and
their scales (``all_to_all_single``), the dequantised local sum, a second
int8 quantisation and an all-gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import train_loss
from repro_torch.training.optimizer import (Optimizer, make_optimizer,
                                            tree_items, tree_leaves,
                                            tree_map, tree_unflatten)


@dataclass(frozen=True)
class TrainHParams:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    grad_accum: int = 1  # microbatches per step
    remat: bool = True


def init_train_state(generator: Optional[torch.Generator],
                     cfg: ModelConfig, opt: Optimizer, params=None,
                     device="cuda", sh=None):
    """{"params", "opt", "step"}: params drawn from ``generator`` on
    ``device`` (``models.init_params``) unless given (e.g. bridged from the
    reference), the optimizer's f32 state beside them, and ``step`` an
    int32 device tensor.  With ``sh`` over a mesh: the group state of
    those params (:meth:`GroupLayout.init_state`)."""
    from repro_torch.models.model import init_params

    if params is None:
        params = init_params(cfg, generator, device)
    if sh is not None and sh.mesh is not None:
        return GroupLayout(cfg, sh).init_state(params, opt)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# A group's training state
# ---------------------------------------------------------------------------


class GroupLayout:
    """Where a device group's slots hold a model's training state under
    ``sh``'s rules: per param leaf (``tree_items`` order) its spec
    (``param_shardings`` of ``param_axes``), its ``embed_fsdp`` dim, and
    per slot its block index and the slots holding the same block — of
    the leaf (the clip's owners: the first of them) and of the leaf with
    its ``embed_fsdp`` dim gathered (the gradient's replica set)."""

    def __init__(self, cfg: ModelConfig, sh):
        from repro_torch.launch.sharding import (fsdp_dim, param_axes,
                                                 param_shardings,
                                                 replica_slots, slot_index)
        from repro_torch.models.layers import group_ctxs
        from repro_torch.models.model import init_params

        self.cfg, self.sh, self.mesh = cfg, sh, sh.mesh
        self.like = init_params(cfg, None, "meta")
        axes = param_axes(cfg, self.like)
        specs = param_shardings(cfg, sh, axes, self.like)
        self.ctxs = group_ctxs(sh.mesh, sh.rules, stand_in=sh.stand_in)
        self._indices = {}
        n = len(self.ctxs)
        self.leaves = []
        for (_, x), (_, ax), (_, sp) in zip(tree_items(self.like),
                                            tree_items(axes),
                                            tree_items(specs)):
            d = fsdp_dim(ax, sp)
            gspec = tuple(None if k == d else e for k, e in enumerate(sp))
            self.leaves.append({
                "shape": tuple(x.shape), "spec": sp, "fsdp": d,
                "index": [slot_index(tuple(x.shape), sp, self.mesh, s)
                          for s in range(n)],
                "owners": [min(replica_slots(self.mesh, sp, s))
                           for s in range(n)],
                "replicas": [replica_slots(self.mesh, gspec, s)
                             for s in range(n)]})

    def _slots(self, fn, slot_trees=None):
        """Per slot, a params-like tree of ``fn(slot, leaf_no, leaves)``
        (``leaves``: that leaf of each of ``slot_trees``)."""
        flat = None if slot_trees is None else \
            [tree_leaves(t) for t in slot_trees]
        return [tree_unflatten(self.like, [
            fn(s, k, None if flat is None else [f[k] for f in flat])
            for k in range(len(self.leaves))])
            for s in range(len(self.ctxs))]

    def shard(self, tree):
        """Per-slot trees of each slot's block of every leaf of ``tree``
        (a params-like tree), copies on the slot's device: replicas are
        each slot's own."""
        whole = tree_leaves(tree)

        def one(s, k, _):
            blk = whole[k][self.leaves[k]["index"][s]]
            out = torch.empty(blk.shape, dtype=blk.dtype,
                              device=self.ctxs[s].device)
            return out.copy_(blk)

        return self._slots(one)

    def unshard(self, slot_trees):
        """The whole params-like tree from its per-slot blocks, on slot 0's
        device (each block from the first slot holding it)."""
        c0 = self.ctxs[0]
        flat = [tree_leaves(t) for t in slot_trees]
        out = []
        for k, leaf in enumerate(self.leaves):
            owners = sorted(set(leaf["owners"]))
            out.append(c0.gather_blocks([f[k] for f in c0.peers(flat,
                                                                owners)],
                                        [leaf["index"][s] for s in owners],
                                        leaf["shape"]))
        return tree_unflatten(self.like, out)

    def loss_and_grads(self, slot_params, batches, remat: bool = True):
        """(loss, metrics, per-slot gradients) of ``models.train_loss``
        over the group at ``slot_params`` (each slot's shards, not
        differentiated themselves) on per-slot ``batches``: the gradient
        of each slot's leaves with their ``embed_fsdp`` dim gathered, in
        one backward pass (not yet reduced: :meth:`reduce_grads`)."""
        live = [tree_map(lambda p: p.detach().requires_grad_(True), t)
                for t in self.gather_fsdp(slot_params)]
        leaves = [tree_leaves(t) for t in live]
        with torch.enable_grad():
            loss, metrics = train_loss(live, self.cfg, batches, remat=remat,
                                       ctxs=self.ctxs)
            grads = torch.autograd.grad(
                loss, [x for ls in leaves for x in ls], allow_unused=True,
                materialize_grads=True)
        n = len(leaves[0])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, [
            tree_unflatten(live[s], grads[s * n:(s + 1) * n])
            for s in range(len(live))]

    def gather_fsdp(self, slot_trees):
        """Per slot, its leaves with the ``embed_fsdp`` dim all-gathered
        over the slots the rule splits it over — its data column, or its
        (pod, data) plane (the others as they are)."""
        def one(s, k, leaves):
            d, c = self.leaves[k]["fsdp"], self.ctxs[s]
            if d is None:
                return leaves[s]
            ax = self.leaves[k]["spec"][d]
            return c.all_gather(c.peers(leaves, c.line(
                ax if isinstance(ax, tuple) else (ax,))), dim=d)

        return self._slots(one, slot_trees)

    def reduce_grads(self, slot_grads):
        """Per slot, each leaf's gradient summed in slot order over the
        slots holding its (gathered) block — and its ``embed_fsdp`` block
        kept (a reduce-scatter)."""
        def one(s, k, grads):
            leaf, c = self.leaves[k], self.ctxs[s]
            reps, d = leaf["replicas"][s], leaf["fsdp"]
            g = grads[s] if len(reps) == 1 else c.all_reduce_sum(
                c.peers(grads, reps), scatter=d is not None)
            if d is not None:
                idx = [slice(None)] * g.dim()
                idx[d] = leaf["index"][s][d]
                g = g[tuple(idx)]
            return g

        return self._slots(one, slot_grads)

    def global_sq(self, slot_grads):
        """Per slot, the squared L2 norm of the whole gradient — each
        element once: a slot sums the leaves whose block it owns, and the
        slots' sums are added in slot order on every slot."""
        flat = [tree_leaves(t) for t in slot_grads]
        part = [sum((torch.sum(torch.square(g.float()))
                     for k, g in enumerate(gs)
                     if self.leaves[k]["owners"][s] == s),
                    torch.zeros((), device=gs[0].device))
                for s, gs in enumerate(flat)]
        every = range(int(self.mesh.devices.size))
        return [c.all_reduce_sum(c.peers(part, every)) for c in self.ctxs]

    def _axes(self, k: int, dims) -> tuple:
        """The mesh axes that split leaf ``k``'s ``dims``."""
        sp, out = self.leaves[k]["spec"], ()
        for d in dims:
            e = sp[d] if d < len(sp) else None
            out += () if e is None else e if isinstance(e, tuple) else (e,)
        return out

    def _index(self, k: int, s: int):
        """Slot ``s``'s block index of leaf ``k`` (any slot of the mesh,
        the stand-in's peers too)."""
        from repro_torch.launch.sharding import slot_index

        hit = self._indices.get((k, s))
        if hit is None:
            leaf = self.leaves[k]
            hit = self._indices[(k, s)] = slot_index(
                leaf["shape"], leaf["spec"], self.mesh, s)
        return hit

    def _moment(self, k, fac, parts, summed, olds, rhos):
        """Per slot, the whole new moment of leaf ``k`` (its state leaf
        ``olds``, written in place) from the slots' ``parts``: sums of
        the squares over dim ``summed`` of their blocks (None: the squares
        themselves).  A slot adds the partial sums of the slots that split
        that dim in slot order and divides by its whole length, decays its
        block of the moment and gathers the whole moment from the blocks
        of the slots that split the other dims."""
        shape = self.leaves[k]["shape"]
        kept = [d for d in range(len(shape)) if d != summed]
        out = []
        for s, c in enumerate(self.ctxs):
            mean = parts[s]
            if summed is not None:
                mean = c.all_reduce_sum(c.peers(parts, sorted(
                    c.line(self._axes(k, [summed]))))) / shape[summed]
            idx = self._index(k, c.slot)
            out.append(fac.moment(olds[s][tuple(idx[d] for d in kept)],
                                  mean, rhos[s]))
        for s, c in enumerate(self.ctxs):
            line = c.line(self._axes(k, kept))
            whole = c.gather_blocks(c.peers(out, line), [
                tuple(self._index(k, t)[d] for d in kept) for t in line],
                olds[s].shape)
            olds[s].copy_(whole)
        return out

    def factored_update(self, fac, slot_params, slot_grads, slot_stats,
                        steps):
        """Adafactor's update (``fac``: ``Optimizer.factored``) of each
        slot's blocks of the params from its blocks of the gradients, the
        state whole on every slot and bit-equal across slots, as the
        reference keeps it: the row and column means of the squares are
        the slots' partial sums over the dim that a leaf's slots split,
        added in slot order, then put together whole from the blocks of
        the dims they keep (a gather); each slot preconditions its block
        from the whole moments, and the update's RMS adds the sums of
        squares of the slots that own a block (each element once) in slot
        order.  A leaf at a time: no f32 temporary outgrows a slot's
        block."""
        params = [tree_leaves(t) for t in slot_params]
        grads = [tree_leaves(t) for t in slot_grads]
        stats = [[] for _ in self.ctxs]
        for s, st in enumerate(slot_stats):
            tree_map(lambda _, x, s=s: stats[s].append(x), self.like, st)
        rhos = [fac.rho(t) for t in steps]
        c0 = self.ctxs[0]
        for k, leaf in enumerate(self.leaves):
            shape = leaf["shape"]
            g2 = [fac.squares(g[k]) for g in grads]
            if len(shape) >= 2:
                rows = [x.sum(dim=-1) for x in g2]
                cols = [x.sum(dim=-2) for x in g2]
                del g2
                nd = len(shape)
                self._moment(k, fac, rows, nd - 1,
                             [st[k]["vr"] for st in stats], rhos)
                self._moment(k, fac, cols, nd - 2,
                             [st[k]["vc"] for st in stats], rhos)
                upds = [fac.precondition(g[k], st[k]["vr"], st[k]["vc"],
                                         self._index(k, c.slot))
                        for g, st, c in zip(grads, stats, self.ctxs)]
            else:
                vs = self._moment(k, fac, g2, None,
                                  [st[k]["v"] for st in stats], rhos)
                del g2
                upds = [fac.precondition(g[k], v)
                        for g, v in zip(grads, vs)]
            sqs = [torch.sum(torch.square(u)) for u in upds]
            owners = sorted(c0.line(self._axes(k, range(len(shape)))))
            n = math.prod(shape)
            for s, c in enumerate(self.ctxs):
                fac.apply(params[s][k], upds[s],
                          c.all_reduce_sum(c.peers(sqs, owners)) / n)
            del upds

    def init_state(self, params, opt: Optimizer):
        """A fresh group state of the whole ``params``: each slot's shards,
        the optimizer's state of them (AdamW's) or of the whole leaves on
        every slot (Adafactor's), and a zero step a slot."""
        slot_params = self.shard(params)
        if opt.replicated_state:
            whole = opt.init(params)
            opts = [tree_map(lambda x, c=c: _copy_to(x, c.device), whole)
                    for c in self.ctxs]
        else:
            opts = [opt.init(p) for p in slot_params]
        return {"params": slot_params, "opt": opts,
                "step": [torch.zeros((), dtype=torch.int32, device=c.device)
                         for c in self.ctxs]}

    def shard_state(self, state):
        """The group state of a whole ``{"params", "opt", "step"}``:
        per-slot lists — params, AdamW's moments sharded like them,
        Adafactor's state whole on every slot — and a step a slot."""
        opt = state["opt"]
        if "stats" in opt:
            opts = [tree_map(lambda x, c=c: _copy_to(x, c.device), opt)
                    for c in self.ctxs]
        else:
            ms, vs = self.shard(opt["m"]), self.shard(opt["v"])
            opts = [{"m": m, "v": v} for m, v in zip(ms, vs)]
        return {"params": self.shard(state["params"]), "opt": opts,
                "step": [_copy_to(state["step"], c.device)
                         for c in self.ctxs]}

    def unshard_state(self, state):
        """The whole ``{"params", "opt", "step"}`` of a group state (on
        slot 0's device): the solo state's tree."""
        opt = state["opt"]
        if "stats" in opt[0]:
            whole = opt[0]
        else:
            whole = {"m": self.unshard([o["m"] for o in opt]),
                     "v": self.unshard([o["v"] for o in opt])}
        return {"params": self.unshard(state["params"]), "opt": whole,
                "step": state["step"][0]}


def _copy_to(x, device):
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def _micro_batch(ctxs, batches, n: int, m: int):
    """Per slot, its rows of micro-batch ``m`` of ``n``: the global batch's
    rows [m B/n, (m+1) B/n), as the solo step splits it, over the row
    blocks in row order — each slot's part taken from the slot of its
    ``row_column`` that holds those rows."""
    out = []
    for c in ctxs:
        B_l = batches[c.slot]["tokens"].shape[0]
        b = B_l // n
        rb, n_rb = c.row_block()
        g = m * n_rb + rb
        src = c.row_column()[g // n]
        lo = (g % n) * b
        out.append({k: c.receive(v[lo:lo + b], src)
                    for k, v in batches[src].items()})
    return out


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    hp: TrainHParams = TrainHParams(), sh=None):
    """Returns train_step(state, batch) -> (state, metrics); the returned
    state is ``state``, updated in place.  ``sh`` (a ``ShardingCtx`` over
    a mesh): the step over the group's slots, ``state`` a group state and
    ``batch`` per-slot (see the module docstring)."""
    if sh is not None and sh.mesh is not None:
        return _group_train_step(cfg, opt, hp, GroupLayout(cfg, sh))

    def grads_of(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = train_loss(live, cfg, mb, remat=hp.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return tree_unflatten(live, grads), metrics

    def accumulated(params, batch):
        n = hp.grad_accum
        micro = [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()} for i in range(n)]
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        per_mb = []
        for mb in micro:
            g, metrics = grads_of(params, mb)
            tree_map(lambda a, b: a.add_(b.float()), g_acc, g)
            per_mb.append(metrics)
        grads = tree_map(lambda g: g / n, g_acc)
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in per_mb[0]}
        return grads, metrics

    def train_step(state, batch):
        params = state["params"]
        if hp.grad_accum > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = grads_of(params, batch)
        opt.update(params, grads, state["opt"], state["step"])
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step


def _group_train_step(cfg: ModelConfig, opt: Optimizer, hp: TrainHParams,
                      lay: GroupLayout):
    ctxs = lay.ctxs
    n_slots = len(ctxs)

    def grads_of(slot_params, mbs):
        _, metrics, grads = lay.loss_and_grads(slot_params, mbs, hp.remat)
        return grads, metrics

    def accumulated(slot_params, batches):
        n = hp.grad_accum
        g_acc, per_mb = None, []
        for m in range(n):
            g, metrics = grads_of(slot_params,
                                  _micro_batch(ctxs, batches, n, m))
            if g_acc is None:
                g_acc = [tree_map(lambda x: x.float(), t) for t in g]
            else:
                for a, b in zip(g_acc, g):
                    tree_map(lambda x, y: x.add_(y.float()), a, b)
            per_mb.append(metrics)
        grads = [tree_map(lambda x: x / n, t) for t in g_acc]
        metrics = {k: torch.mean(torch.stack([mm[k] for mm in per_mb]))
                   for k in per_mb[0]}
        return grads, metrics

    def train_step(state, batch):
        params = state["params"]
        if hp.grad_accum > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = grads_of(params, batch)
        grads = lay.reduce_grads(grads)
        if opt.factored is not None:
            lay.factored_update(opt.factored, params, grads,
                                [o["stats"] for o in state["opt"]],
                                state["step"])
        else:
            sqs = lay.global_sq(grads)
            for s in range(n_slots):
                opt.update(params[s], grads[s], state["opt"][s],
                           state["step"][s], sq=sqs[s])
        state["step"] = [t + 1 for t in state["step"]]
        return state, metrics

    return train_step


def make_optimizer_for(cfg: ModelConfig, hp: TrainHParams) -> Optimizer:
    return make_optimizer(cfg.optimizer, lr=hp.learning_rate,
                          weight_decay=hp.weight_decay,
                          **({"grad_clip": hp.grad_clip}
                             if cfg.optimizer == "adamw" else {}))


# ---------------------------------------------------------------------------
# int8 gradient compression (the slow-link all-reduce)
# ---------------------------------------------------------------------------


def int8_quantize(x, dim: int = -1):
    """Symmetric per-slice int8 quantisation.  Returns (q, scale); the
    rounding is half-to-even, as ``jnp.round``."""
    amax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale):
    return q.float() * scale


def int8_allreduce(x, group=None):
    """Sum of ``x`` over the ranks of ``group`` (default: the world) with
    int8-compressed payloads: each rank's flat ``x``, zero-padded to a
    multiple of the group size, is cut into one chunk per rank and
    quantised per chunk; the reduce-scatter (``all_to_all_single``) hands
    each rank its chunk from everyone, which it dequantises and sums; the
    sum is quantised again and all-gathered.  ~4x less wire traffic than a
    bf16 all-reduce.  Sum, not mean: the caller divides if needed."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1)
    q, scale = int8_quantize(chunks)
    q_t, s_t = torch.empty_like(q), torch.empty_like(scale)
    dist.all_to_all_single(q_t, q, group=group)
    dist.all_to_all_single(s_t, scale, group=group)
    local_sum = torch.sum(int8_dequantize(q_t, s_t), dim=0)  # (chunk,)
    q2, s2 = int8_quantize(local_sum[None])
    q_all = [torch.empty_like(q2[0]) for _ in range(n)]
    s_all = [torch.empty_like(s2[0]) for _ in range(n)]
    dist.all_gather(q_all, q2[0], group=group)
    dist.all_gather(s_all, s2[0], group=group)
    out = int8_dequantize(torch.stack(q_all), torch.stack(s_all))
    out = out.reshape(-1)[:x.numel()]
    return out.reshape(x.shape).to(x.dtype)
