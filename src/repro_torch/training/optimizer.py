"""Optimizers: AdamW and Adafactor — the counterparts of the reference's
``repro/training/optimizer.py`` on nested dicts of tensors.

Both keep their state in f32 whatever the param dtype, and share one
interface:

    opt = make_optimizer(name, lr=..., ...)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, step)

``step`` is an int32 device tensor and the bias corrections are computed
from it on the device, so an update makes no host sync.  ``update`` runs
under ``torch.no_grad()`` and writes the params and the state in place
(the arithmetic of the reference's functional update, op for op); it
returns the same trees.  Leaves stay stacked ``(L, ...)`` as the param tree
holds them: Adafactor factors over the last two dims of a stacked leaf and
clips its update by the RMS of the whole leaf, as the reference does.
A device group's step runs Adafactor's arithmetic (:class:`Factored`) on
each slot's block of a leaf, its slot collectives in between
(``training.train_step.GroupLayout.factored_update``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import torch


@dataclass(frozen=True)
class Factored:
    """Adafactor's arithmetic of one leaf, in the pieces that a device
    group's step runs on each slot's block of the leaf between its slot
    collectives: the squares that the moments average, a moment's decay,
    the preconditioned update from the whole moments, and the update's
    RMS clip and write."""
    lr: float
    decay: float
    eps: float
    clip_threshold: float
    weight_decay: float

    def rho(self, step):
        return 1.0 - (step.float() + 1.0) ** (-self.decay)

    def squares(self, g):
        return torch.square(g.float()) + self.eps

    def moment(self, old, mean, rho):
        """The decayed moment: ``old`` moved toward this step's ``mean``."""
        return rho * old + (1 - rho) * mean

    def precondition(self, g, vr, vc=None, index=None):
        """``g``'s update: scaled by the factored second moment ``vr`` x
        ``vc`` (whole leaves' moments, the rows and columns of ``g``'s
        block ``index`` taken from them) or, with ``vc`` None, by the full
        moment ``vr`` of ``g``'s elements."""
        g = g.float()
        if vc is None:
            return g * torch.rsqrt(torch.clamp(vr, min=self.eps))
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                            min=self.eps)
        r, c = vr / denom, vc
        if index is not None:
            r, c = r[index[:-1]], c[index[:-2] + index[-1:]]
        prec = r[..., None] * c[..., None, :]
        return g * torch.rsqrt(torch.clamp(prec, min=self.eps))

    def apply(self, p, upd, mean_sq):
        """Writes ``p`` less its update ``upd``, clipped by the RMS of the
        whole leaf's update (``mean_sq``: its mean square)."""
        rms = torch.sqrt(mean_sq + self.eps)
        upd = upd / torch.clamp(rms / self.clip_threshold, min=1.0)
        _write(p, p.float() - self.lr * (upd + self.weight_decay * p.float()))


@dataclass(frozen=True)
class Optimizer:
    """``update(params, grads, state, step)``.  ``factored``: Adafactor's
    arithmetic (:class:`Factored`), whose state a device group keeps
    whole on every slot (``replicated_state``; its factored moments are
    row and column means over a whole leaf, and the reference's dry run
    replicates them); without it (AdamW) the state mirrors the params'
    shards."""
    init: Callable
    update: Callable
    name: str
    factored: Optional[Factored] = None

    @property
    def replicated_state(self) -> bool:
        return self.factored is not None


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) of every tensor leaf of a nested dict, dict keys sorted:
    the leaf order ``jax.tree_util`` gives the same tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree):
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the parallel trees ``rest``,
    in ``tree_items`` order; empty dicts (a parameterless norm) are kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in ``tree_items``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def clip_by_global_norm(grads, max_norm: float, sq=None):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling); no clip for ``max_norm <= 0``.  A device computation:
    the scale is min(1, max_norm / norm), never a host branch.  The leaves
    of ``grads`` are scaled in place (a step's gradients are its own
    temporaries: a copy would cost another params' worth of memory).
    ``sq``: the squared global norm when ``grads`` is a slot's shard of
    it (a group's, each element counted once over the slots)."""
    leaves = tree_leaves(grads)
    if max_norm <= 0:
        return grads, torch.zeros((), dtype=torch.float32,
                                  device=leaves[0].device)
    if sq is None:
        sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves:
        g.copy_(g.float() * scale)
    return grads, norm


def _write(p, newp_f32) -> None:
    """In place: the new f32 value of a param, cast to its dtype."""
    if p.dtype == torch.float32:
        p.copy_(newp_f32)
    else:
        p.copy_(newp_f32.to(p.dtype))


def make_adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.0,
               grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(params, grads, state, step, sq=None):
        clip_by_global_norm(grads, grad_clip, sq)
        t = step.float() + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * torch.square(g))
            step_ = lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                          + weight_decay * p.float())
            _write(p, p.float() - step_)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init=init, update=update, name="adamw")


def make_adafactor(lr: float = 1e-4, decay: float = 0.8, eps: float = 1e-30,
                   clip_threshold: float = 1.0,
                   weight_decay: float = 0.0) -> Optimizer:
    """Factored Adafactor (no momentum) — O(rows+cols) second-moment state
    for every leaf of two or more dims (``vr`` over the last dim, ``vc``
    over the second to last), a full ``v`` for 1-D leaves."""

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"stats": tree_map(one, params)}

    fac = Factored(lr, decay, eps, clip_threshold, weight_decay)

    @torch.no_grad()
    def leaf_update(p, g, s, step):
        rho = fac.rho(step)
        g2 = fac.squares(g)
        if "vr" in s:
            s["vr"].copy_(fac.moment(s["vr"], torch.mean(g2, dim=-1), rho))
            s["vc"].copy_(fac.moment(s["vc"], torch.mean(g2, dim=-2), rho))
            upd = fac.precondition(g, s["vr"], s["vc"])
        else:
            s["v"].copy_(fac.moment(s["v"], g2, rho))
            upd = fac.precondition(g, s["v"])
        fac.apply(p, upd, torch.mean(torch.square(upd)))

    @torch.no_grad()
    def update(params, grads, state, step):
        tree_map(lambda p, g, s: leaf_update(p, g, s, step), params, grads,
                 state["stats"])
        return params, state

    return Optimizer(init=init, update=update, name="adafactor",
                     factored=fac)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(f"unknown optimizer {name}")
