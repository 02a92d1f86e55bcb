"""Roofline pricing of the port's steps and kernel calls on one H100.

The framework-free half of the reference's ``repro/launch/costs.py``:
``CostSummary`` (flops, bytes, collective bytes), ``roofline_terms`` and
``tau_from_step_cost`` with the reference's arithmetic, over this card's
published rates instead of the TPU's.  A ``CostSummary`` here comes from
shapes (``BlockServer.decode_step_cost``, the kernel wrappers' ``cost``),
not from a compiler's cost analysis.  A device group's step counts its
slot collectives as it runs on meta tensors
(``models.layers.count_collectives``): each call's wire bytes by the ring
model of the reference's ``parse_collectives`` (all-reduce 2(g-1)/g N,
all-gather (g-1)/g N_out, a point-to-point send N), priced over
``NVLINK_BW``.  The reference's other readers of XLA artifacts
(``summarize_compiled``, ``memory_summary``) have no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

# NVIDIA's H100 SXM data sheet, dense rates (no sparsity) at the 700 W
# power limit: HBM3 bytes/s; flop/s of the bf16 and TF32 tensor cores and
# of f32 on the CUDA cores
HBM_BW = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
# the same data sheet's NVLink 4 rate, 900 GB/s per GPU counting both
# directions: 450e9 B/s is what one direction of a ring step sees
NVLINK_BW = 450e9


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_count: int = 0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)

    def scaled_add(self, other: "CostSummary", k: float):
        self.flops += k * other.flops
        self.bytes_accessed += k * other.bytes_accessed
        self.coll_wire_bytes += k * other.coll_wire_bytes
        self.coll_count += int(k * other.coll_count)
        for kk, v in other.coll_by_kind.items():
            self.coll_by_kind[kk] = self.coll_by_kind.get(kk, 0.0) + k * v

    def to_dict(self):
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "coll_wire_bytes": self.coll_wire_bytes,
                "coll_count": self.coll_count,
                "coll_by_kind": dict(self.coll_by_kind)}


def tau_from_step_cost(cost: CostSummary, n_chips: int, m_blocks: int,
                       n_rows: int) -> float:
    """Per-block per-token decode τ (s) from one pooled decode step's cost.

    The step advances every pool row one token through all ``m_blocks``
    hosted blocks, so the roofline bound of ONE step amortises over
    ``m_blocks x n_rows`` (block, token) pairs — exactly the τ the paper's
    eq. (1) multiplies back up."""
    terms = roofline_terms(cost, n_chips)
    return terms["bound_s"] / max(1, int(m_blocks) * int(n_rows))


def roofline_terms(cost: CostSummary, n_chips: int,
                   dtype: str = "bfloat16") -> Dict:
    """The least time of ``cost`` on one card: flops over the peak of
    ``dtype`` (the bf16 tensor cores by default, as the reference prices
    every step), bytes over the HBM rate, collective wire bytes over
    NVLink; the largest bounds.  ``cost`` is per card (a group's per
    slot), so ``n_chips`` does not scale it (the reference's
    convention)."""
    compute_s = cost.flops / PEAK_FLOPS[dtype]
    memory_s = cost.bytes_accessed / HBM_BW
    collective_s = cost.coll_wire_bytes / NVLINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda t: t[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "compute_fraction_of_bound": (compute_s / total) if total > 0 else 0.0,
    }


def bound_ms(cost: CostSummary, dtype: str) -> Tuple[float, str]:
    """A kernel call's least time in ms and what bounds it ("bytes" or
    "operations"), its flops priced at the peak of ``dtype``."""
    t = roofline_terms(cost, 1, dtype)
    return (t["bound_s"] * 1e3,
            "bytes" if t["memory_s"] >= t["compute_s"] else "operations")
