"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain PyTorch
versions — one for each TPU kernel of the reference: K1 split-KV decode
attention, K2 prefill flash attention (bf16 on the tensor cores), K3 the
RWKV6 WKV recurrence and K4 the Mamba2 SSD scan (both chunked scans on the
tensor cores).  Sources live in ``csrc/`` and are built with ``nvcc`` at first
use (``runtime.py``).  Beside them, ``moe_experts``: a dropless MoE layer's
grouped expert products, on PyTorch's grouped GEMM.  Each wrapper's
``*_cost`` gives a call's bytes and flops from its inputs."""
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_cost, decode_attention_partials,
    decode_attention_partials_ref, decode_attention_ref,
    decode_attention_unsupported, decode_plan, head_group, merge_cost,
    merge_partials, merge_partials_ref)
from repro_torch.kernels.flash_attention import (DESIGNS, HEAD_DIM_PAIRS,
                                                 HEAD_DIM_PAIRS_F32,
                                                 HEAD_DIMS, attention_ref,
                                                 flash_attention,
                                                 flash_attention_cost,
                                                 flash_attention_unsupported)
from repro_torch.kernels.moe_experts import (grouped_experts,
                                             grouped_experts_cost,
                                             grouped_experts_ref,
                                             grouped_experts_unsupported)
from repro_torch.kernels.runtime import BACKENDS, NO_WINDOW, resolve_backend
from repro_torch.kernels.ssd import (ssd, ssd_chunked, ssd_cost, ssd_plan,
                                     ssd_recurrence, ssd_unsupported)
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked, wkv6_cost,
                                      wkv6_plan, wkv6_recurrence,
                                      wkv6_unsupported)

__all__ = ["BACKENDS", "DESIGNS", "HEAD_DIMS", "HEAD_DIM_PAIRS",
           "HEAD_DIM_PAIRS_F32", "NO_WINDOW", "attention_ref",
           "decode_attention", "decode_attention_cost",
           "decode_attention_partials", "decode_attention_partials_ref",
           "decode_attention_ref", "decode_attention_unsupported",
           "decode_plan", "merge_cost", "merge_partials",
           "merge_partials_ref", "flash_attention", "flash_attention_cost",
           "flash_attention_unsupported", "grouped_experts",
           "grouped_experts_cost", "grouped_experts_ref",
           "grouped_experts_unsupported", "head_group", "resolve_backend",
           "ssd", "ssd_chunked", "ssd_cost", "ssd_plan", "ssd_recurrence",
           "ssd_unsupported", "wkv6", "wkv6_chunked", "wkv6_cost",
           "wkv6_plan", "wkv6_recurrence", "wkv6_unsupported"]
