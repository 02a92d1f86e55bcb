from repro_torch.kernels.moe_experts.ops import (grouped_experts,
                                                 grouped_experts_unsupported)
from repro_torch.kernels.moe_experts.ops import \
    cost as grouped_experts_cost
from repro_torch.kernels.moe_experts.ref import grouped_experts_ref

__all__ = ["grouped_experts", "grouped_experts_cost", "grouped_experts_ref",
           "grouped_experts_unsupported"]
