"""Training step: loss and gradients (with remat), grad-accum
micro-batching, the optimizer update, and the int8-compressed all-reduce —
the counterparts of the reference's ``repro/training/train_step.py``.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  It takes gradients with ``torch.autograd.grad`` over the param
leaves (``state["params"]`` need not require grad: the step differentiates
detached aliases of them), updates the params and the optimizer state in
place, and makes no host sync: the metrics stay on the device.  Sharding a
step over several devices is ROADMAP A10.

``int8_allreduce`` is the reference's compressed gradient all-reduce over a
``torch.distributed`` process group: a reduce-scatter of int8 chunks and
their scales (``all_to_all_single``), the dequantised local sum, a second
int8 quantisation and an all-gather.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import train_loss
from repro_torch.training.optimizer import (Optimizer, make_optimizer,
                                            tree_leaves,
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
                     device="cuda"):
    """{"params", "opt", "step"}: params drawn from ``generator`` on
    ``device`` (``models.init_params``) unless given (e.g. bridged from the
    reference), the optimizer's f32 state beside them, and ``step`` an
    int32 device tensor."""
    from repro_torch.models.model import init_params

    if params is None:
        params = init_params(cfg, generator, device)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    hp: TrainHParams = TrainHParams()):
    """Returns train_step(state, batch) -> (state, metrics); the returned
    state is ``state``, updated in place."""

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
