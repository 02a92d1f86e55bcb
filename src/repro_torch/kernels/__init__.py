"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain PyTorch
versions — one for each TPU kernel of the reference: K1 split-KV decode
attention, K2 prefill flash attention (bf16 on the tensor cores), K3 the
RWKV6 WKV recurrence and K4 the Mamba2 SSD scan (both chunked scans on the
tensor cores).  Sources live in ``csrc/`` and are built with ``nvcc`` at first
use (``runtime.py``)."""
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  decode_attention_unsupported,
                                                  decode_plan)
from repro_torch.kernels.flash_attention import (DESIGNS, HEAD_DIM_PAIRS,
                                                 HEAD_DIMS, attention_ref,
                                                 flash_attention,
                                                 flash_attention_unsupported)
from repro_torch.kernels.runtime import BACKENDS, NO_WINDOW, resolve_backend
from repro_torch.kernels.ssd import (ssd, ssd_chunked, ssd_plan,
                                     ssd_recurrence, ssd_unsupported)
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked, wkv6_plan,
                                      wkv6_recurrence, wkv6_unsupported)

__all__ = ["BACKENDS", "DESIGNS", "HEAD_DIMS", "HEAD_DIM_PAIRS", "NO_WINDOW",
           "attention_ref", "decode_attention", "decode_attention_ref",
           "decode_attention_unsupported", "decode_plan",
           "flash_attention", "flash_attention_unsupported",
           "resolve_backend", "ssd", "ssd_chunked", "ssd_plan",
           "ssd_recurrence", "ssd_unsupported", "wkv6", "wkv6_chunked",
           "wkv6_plan", "wkv6_recurrence", "wkv6_unsupported"]
