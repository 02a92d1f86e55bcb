from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_partials,
    decode_attention_unsupported, decode_plan, head_group, merge_cost,
    merge_partials)
from repro_torch.kernels.decode_attention.ops import \
    cost as decode_attention_cost
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, decode_attention_ref, merge_partials_ref)

__all__ = ["decode_attention", "decode_attention_cost",
           "decode_attention_partials", "decode_attention_partials_ref",
           "decode_attention_ref", "decode_attention_unsupported",
           "decode_plan", "head_group", "merge_cost", "merge_partials",
           "merge_partials_ref"]
