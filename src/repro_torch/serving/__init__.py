"""The geo serving stack of the port: slab and paged cache pools
(PagePool free-list allocation, page-granular eq. (5)/(20) accounting,
preemption and resume), the continuous-batching engine with failover
replay and device-group (TP/EP) servers, per-session sampling policies on the port's threefry, the
scheduler, and the (copied) fault model."""
from repro_torch.launch.sharding import DeviceGroup
from repro_torch.serving.engine import (BlockServer, EngineSession,
                                        GeoServingSystem, generate)
from repro_torch.serving.faults import (FailureDetector, FaultEvent,
                                        FaultPlan, NoCapacityError,
                                        recovery_replay_cost)
from repro_torch.serving.kv_cache import (SUPPORTED_KINDS, CachePool,
                                          PagePool, StateSpec, bucket_for,
                                          default_prefill_buckets, kind_runs,
                                          make_paged_decode_step,
                                          make_paged_prefill_step,
                                          make_paged_round_step,
                                          make_pool_decode_step,
                                          make_pool_prefill_step,
                                          make_pool_round_step,
                                          new_block_cache,
                                          new_cache_pool_tree,
                                          new_paged_pool_tree,
                                          new_state_pool_tree, pages_for,
                                          state_spec_for, state_specs)
from repro_torch.serving.sampling import (SamplingSpec, make_round_tail,
                                          make_sampler)
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           ServedRequest)

__all__ = [
    "BlockServer", "CachePool", "ContinuousBatchingScheduler",
    "DeviceGroup", "EngineSession", "FailureDetector", "FaultEvent", "FaultPlan",
    "GeoServingSystem", "NoCapacityError", "PagePool", "SUPPORTED_KINDS",
    "SamplingSpec", "ServedRequest", "StateSpec", "bucket_for",
    "default_prefill_buckets", "generate", "kind_runs",
    "make_paged_decode_step", "make_paged_prefill_step",
    "make_paged_round_step", "make_pool_decode_step",
    "make_pool_prefill_step", "make_pool_round_step", "make_round_tail",
    "make_sampler", "new_block_cache", "new_cache_pool_tree",
    "new_paged_pool_tree", "new_state_pool_tree", "pages_for",
    "recovery_replay_cost", "state_spec_for", "state_specs",
]
