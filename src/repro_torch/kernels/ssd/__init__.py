from repro_torch.kernels.ssd.ops import (CHUNK, SHAPES, ssd, ssd_plan,
                                         ssd_unsupported)
from repro_torch.kernels.ssd.ops import cost as ssd_cost
from repro_torch.kernels.ssd.ref import (MAMBA_CHUNK, ssd_chunked,
                                         ssd_recurrence)

__all__ = ["CHUNK", "MAMBA_CHUNK", "SHAPES", "ssd", "ssd_cost",
           "ssd_chunked", "ssd_plan", "ssd_recurrence", "ssd_unsupported"]
