from repro_torch.models.blocks import stack_block_kinds
from repro_torch.models.model import (SegmentSpec, block_param_range,
                                      decode_step, forward_full,
                                      hybrid_mamba_stack, init_decode_caches,
                                      init_params, prefill, stack_plan,
                                      train_loss, upcast_prefill_logits)

__all__ = ["SegmentSpec", "block_param_range", "decode_step",
           "forward_full", "hybrid_mamba_stack", "init_decode_caches",
           "init_params", "prefill", "stack_block_kinds", "stack_plan",
           "train_loss", "upcast_prefill_logits"]
