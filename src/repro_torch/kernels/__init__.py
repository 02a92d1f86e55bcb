"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain PyTorch
versions: K1 decode attention and K2 prefill flash attention, the two
kernels the dense-decoder serving path runs.  Sources live in ``csrc/``
and are built with ``nvcc`` at first use (``runtime.py``).  The WKV6 and
SSD kernels of the reference are still to be ported (ROADMAP)."""
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  decode_attention_unsupported)
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_unsupported)
from repro_torch.kernels.runtime import BACKENDS, NO_WINDOW, resolve_backend

__all__ = ["BACKENDS", "NO_WINDOW", "attention_ref", "decode_attention",
           "decode_attention_ref", "decode_attention_unsupported",
           "flash_attention", "flash_attention_unsupported",
           "resolve_backend"]
