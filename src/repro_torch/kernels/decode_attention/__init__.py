from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_unsupported, decode_plan, head_group)
from repro_torch.kernels.decode_attention.ops import \
    cost as decode_attention_cost
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_cost", "decode_attention_ref",
           "decode_attention_unsupported", "decode_plan", "head_group"]
