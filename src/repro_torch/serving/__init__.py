"""The geo serving stack of the port: slab cache pools, the continuous-
batching engine with failover replay, the scheduler, and the (copied)
fault model."""
from repro_torch.serving.engine import (BlockServer, EngineSession,
                                        GeoServingSystem, generate)
from repro_torch.serving.faults import (FailureDetector, FaultEvent,
                                        FaultPlan, NoCapacityError,
                                        recovery_replay_cost)
from repro_torch.serving.kv_cache import (SUPPORTED_KINDS, CachePool,
                                          StateSpec, bucket_for,
                                          default_prefill_buckets, kind_runs,
                                          make_pool_decode_step,
                                          make_pool_prefill_step,
                                          make_pool_round_step,
                                          new_block_cache,
                                          new_cache_pool_tree,
                                          state_spec_for, state_specs)
from repro_torch.serving.sampling import (SamplingSpec, make_round_tail,
                                          sample_tokens)
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           ServedRequest)

__all__ = [
    "BlockServer", "CachePool", "ContinuousBatchingScheduler",
    "EngineSession", "FailureDetector", "FaultEvent", "FaultPlan",
    "GeoServingSystem", "NoCapacityError", "SUPPORTED_KINDS",
    "SamplingSpec", "ServedRequest", "StateSpec", "bucket_for",
    "default_prefill_buckets", "generate", "kind_runs",
    "make_pool_decode_step", "make_pool_prefill_step",
    "make_pool_round_step", "make_round_tail", "new_block_cache",
    "new_cache_pool_tree", "recovery_replay_cost", "sample_tokens",
    "state_spec_for", "state_specs",
]
