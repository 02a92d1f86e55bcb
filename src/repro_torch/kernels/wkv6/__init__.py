from repro_torch.kernels.wkv6.ops import HEAD_DIMS, wkv6, wkv6_unsupported
from repro_torch.kernels.wkv6.ref import (RWKV_CHUNK, wkv6_chunked,
                                          wkv6_recurrence)

__all__ = ["HEAD_DIMS", "RWKV_CHUNK", "wkv6", "wkv6_chunked",
           "wkv6_recurrence", "wkv6_unsupported"]
