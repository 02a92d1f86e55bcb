from repro_torch.kernels.ssd.ops import STATE_SIZES, ssd, ssd_unsupported
from repro_torch.kernels.ssd.ref import (MAMBA_CHUNK, ssd_chunked,
                                         ssd_recurrence)

__all__ = ["MAMBA_CHUNK", "STATE_SIZES", "ssd", "ssd_chunked",
           "ssd_recurrence", "ssd_unsupported"]
