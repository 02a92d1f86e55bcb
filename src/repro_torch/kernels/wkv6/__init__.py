from repro_torch.kernels.wkv6.ops import (CHUNK, HEAD_DIMS, SUB_BLOCK, wkv6,
                                          wkv6_plan, wkv6_unsupported)
from repro_torch.kernels.wkv6.ops import cost as wkv6_cost
from repro_torch.kernels.wkv6.ref import (RWKV_CHUNK, wkv6_chunked,
                                          wkv6_recurrence)

__all__ = ["CHUNK", "HEAD_DIMS", "RWKV_CHUNK", "SUB_BLOCK", "wkv6", "wkv6_cost",
           "wkv6_chunked", "wkv6_plan", "wkv6_recurrence",
           "wkv6_unsupported"]
