from repro_torch.data.pipeline import (encdec_batches, lm_batches,
                                       make_batches, shard_batch)

__all__ = ["encdec_batches", "lm_batches", "make_batches", "shard_batch"]
