from repro_torch.kernels.flash_attention.ops import (
    HEAD_DIM_PAIRS, HEAD_DIMS, flash_attention, flash_attention_unsupported)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["HEAD_DIM_PAIRS", "HEAD_DIMS", "attention_ref", "flash_attention",
           "flash_attention_unsupported"]
