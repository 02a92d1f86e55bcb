"""The paper's light-weight CPU-only simulator: a numpy copy of the
reference's ``repro.sim`` (workloads, topologies, scenarios, the
reference and fast event loops, churn and fault studies)."""
from repro_torch.sim.cluster import (A100, MIG, clustered_scenario,
                                     scattered_scenario)
from repro_torch.sim.simulator import (ALGORITHMS, SIM_MODES, ChurnResult,
                                       FaultSimResult, SimConfig, SimResult,
                                       run_comparison, simulate,
                                       simulate_churn, simulate_faults,
                                       subchain_route)
from repro_torch.sim.topologies import (TOPOLOGY_SPECS, Topology,
                                        make_topology, place_servers)
from repro_torch.sim.workload import (ChurnEvent, Request, RequestBatch,
                                      burst_requests, bursty_requests,
                                      churn_schedule, diurnal_rate,
                                      diurnal_requests, fault_schedule,
                                      poisson_requests, prompts_for)

__all__ = [
    "A100", "ALGORITHMS", "MIG", "ChurnEvent", "ChurnResult",
    "FaultSimResult", "Request", "RequestBatch", "SIM_MODES", "SimConfig",
    "SimResult", "TOPOLOGY_SPECS", "Topology", "burst_requests",
    "bursty_requests", "churn_schedule", "clustered_scenario",
    "diurnal_rate", "diurnal_requests", "fault_schedule", "make_topology",
    "place_servers", "poisson_requests", "prompts_for", "run_comparison",
    "scattered_scenario", "simulate", "simulate_churn", "simulate_faults",
    "subchain_route",
]
