"""The grouped expert products of a traced window, for the ``moe_*``
readers: the calls that ``families.deepseek_v2.CALLS`` recorded inside the
window, and the device time of their kernels.  Where the family was never
loaded, or the program has no grouped expert products, every reading is
None."""
from __future__ import annotations

import sys

# the device kernels of PyTorch's grouped GEMM (torch._grouped_mm on
# sm_90, NVIDIA H100): the kernel that lays out each group's problem from
# the offsets, and CUTLASS's grouped-problem GEMM (its mangled name)
MOE_KERNELS = ("prepare_grouped_gemm_data", "GroupProblemShape")


def calls(w):
    fam = sys.modules.get("families.deepseek_v2")
    if fam is None or w.device is None:
        return []
    return fam.CALLS.inside(w.t_open, w.t_close)


def kernel_s(w) -> float:
    return w.device.kernel_s(MOE_KERNELS) if w.device is not None else 0.0
