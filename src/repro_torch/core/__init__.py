"""The paper's primary contribution: joint Block Placement and Request
Routing (BPRR) for geographically-distributed pipeline-parallel LLM
inference — performance models, CG-BPRR, the online two-time-scale
controller, MILP reference solvers, and performance bounds.

A copy of the reference's numpy-only ``repro.core``, so both engines place
and route with the same arithmetic and their virtual clocks agree bit for
bit; the reference's JAX batched router becomes ``torch_shortest_paths``."""
from repro_torch.core.bounds import (approximation_ratio, cg_upper_bound,
                               lower_bound)
from repro_torch.core.online import OnlineBPRR, Session
from repro_torch.core.perf_model import (BLOOM_PETALS, GB, MB, LLMSpec, Placement,
                                   Problem, Route, ServerSpec, Workload,
                                   route_avg_per_token_time,
                                   route_per_token_time, route_prefill_time,
                                   route_total_time, server_memory_use,
                                   with_server_taus)
from repro_torch.core.placement import (auto_R, capacity, cg_bp, cg_feasible_R,
                                  conservative_m, max_feasible_R,
                                  optimized_number_bp, optimized_order_bp,
                                  petals_bp, petals_m)
from repro_torch.core.routing import (RouteCostCache, ServerState,
                                ServerStateArrays, edge_waiting_times,
                                petals_route, shortest_path_route,
                                torch_shortest_paths, ws_rr)
from repro_torch.core.topology import (RoutingGraph, edge_feasible, route_blocks,
                                 route_feasible)

__all__ = [
    "BLOOM_PETALS", "GB", "MB", "LLMSpec", "OnlineBPRR", "Placement",
    "Problem", "Route", "RouteCostCache", "RoutingGraph", "ServerSpec",
    "ServerState", "ServerStateArrays",
    "Session", "Workload", "approximation_ratio", "auto_R", "capacity",
    "cg_bp", "cg_feasible_R", "cg_upper_bound", "conservative_m",
    "edge_feasible", "edge_waiting_times",
    "lower_bound", "max_feasible_R", "optimized_number_bp",
    "optimized_order_bp", "petals_bp", "petals_m", "petals_route",
    "route_avg_per_token_time", "route_blocks", "route_feasible",
    "route_per_token_time", "route_prefill_time", "route_total_time",
    "server_memory_use", "shortest_path_route", "torch_shortest_paths",
    "with_server_taus", "ws_rr",
]
