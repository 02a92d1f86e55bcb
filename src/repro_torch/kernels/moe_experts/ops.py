"""The grouped expert products of a dropless MoE layer: each expert's SwiGLU
over the routed (token, expert) rows alone, grouped by expert.

``grouped_experts(x, wg, wu, wo, offs)`` takes the rows sorted by expert
(``x`` (M, d)), the expert weights (``wg`` / ``wu`` (E, d, f), ``wo`` (E,
f, d)) and ``offs`` (E,) int32, the cumulative row counts on the rows'
device.  On the card the three products are PyTorch's grouped GEMM
(``torch._grouped_mm``: bf16 with f32 accumulation, sm_90), one launch
each over every expert: each expert's problem is its own rows, an expert
with no rows is a problem of zero rows whose weights are never read, and
the offsets stay on the device, so nothing syncs.  The SiLU and the gate
product run between them in bf16.  A CPU tensor goes to the plain version
(``ref.py``); a CUDA call the grouped GEMM cannot take raises — there is
no fallback.  A meta tensor inside ``runtime.count_meta_calls`` adds the
call's ``cost`` (every row live, ``min(E, M)`` experts read) and returns
an empty output.  ``grouped_experts.launches`` counts grouped GEMM
launches (three a call).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_experts.ref import grouped_experts_ref
from repro_torch.kernels.runtime import meta_calls, refuse_grad
from repro_torch.launch.costs import CostSummary, count_weight

PRODUCTS = 3  # gate, up and down: one grouped GEMM each


def grouped_experts_unsupported(x, wg, wo, offs) -> Optional[str]:
    """Reason the grouped GEMM cannot serve a call on the card, else
    None."""
    if x.dtype != torch.bfloat16 or wg.dtype != x.dtype or \
            wo.dtype != x.dtype:
        return f"dtypes x {x.dtype}, weights {wg.dtype}: it takes bfloat16"
    if x.dim() != 2 or wg.dim() != 3 or wo.dim() != 3:
        return (f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, wo "
                f"{tuple(wo.shape)}: it takes (M, d) rows over (E, d, f) "
                "and (E, f, d) weights")
    d, f = wg.shape[1], wg.shape[2]
    if d % 8 or f % 8:
        return f"widths d {d}, f {f}: its rows are copied 16 bytes at a time"
    if offs.dtype != torch.int32 or offs.shape != (wg.shape[0],):
        return (f"offsets {offs.dtype} {tuple(offs.shape)}: it takes (E,) "
                "int32 cumulative row counts")
    return None


def cost(x, wg, wu, wo, counts: Optional[Sequence[int]] = None
         ) -> CostSummary:
    """Bytes and flops of one call: the weights of each expert that has
    rows read once (``counts``: the rows of each expert; without it every
    row live and ``min(E, M)`` experts read), the rows read and the output
    written once, the offsets; three products of 2 d f flops a row."""
    M, d = x.shape
    f, E = wg.shape[-1], wg.shape[0]
    es = x.element_size()
    rows = M if counts is None else int(sum(counts))
    experts = min(E, M) if counts is None else sum(1 for c in counts if c)
    weights = experts * (2 * d * f + f * wo.shape[-1]) * wg.element_size()
    nbytes = weights + rows * (d + wo.shape[-1]) * es + 4 * E
    return CostSummary(flops=2 * rows * f * (2 * d + wo.shape[-1]),
                       bytes_accessed=nbytes)


def grouped_experts(x, wg, wu, wo, offs):
    """x (M, d) grouped by expert; offs (E,) int32 cumulative ends ->
    (M, d): row i through its expert's SwiGLU."""
    if x.device.type == "cpu":
        return grouped_experts_ref(x, wg, wu, wo, offs)
    refuse_grad("grouped_experts", x, wg, wu, wo)
    counting = meta_calls()
    if x.device.type == "meta" and counting is not None:
        counting.cost.scaled_add(cost(x, wg, wu, wo), count_weight())
        return x.new_empty(x.shape[:1] + wo.shape[-1:])
    if x.device.type != "cuda":
        raise ValueError(f"grouped_experts: no kernel for device {x.device}")
    reason = grouped_experts_unsupported(x, wg, wo, offs)
    if reason is not None:
        raise ValueError(f"grouped_experts does not take {reason}")
    g = torch._grouped_mm(x, wg, offs=offs)
    u = torch._grouped_mm(x, wu, offs=offs)
    y = torch._grouped_mm(F.silu(g).mul_(u), wo, offs=offs)
    grouped_experts.launches += PRODUCTS
    return y


grouped_experts.launches = 0
