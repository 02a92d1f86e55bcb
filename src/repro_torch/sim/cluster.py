"""Evaluation scenarios (paper §4.1) — a copy of the reference's
``repro/sim/cluster.py``.

* ``clustered_scenario`` — Table 2: Cluster0 (clients only), Cluster1
  (2 A100-class servers), Cluster2 (7 MIG-class servers); intra-cluster
  5 ms RTT / 1 Gbit/s, inter-cluster 100 ms / 100 Mbit/s.
* server profiles calibrated to the paper's PETALS/BLOOM-176B numbers
  (NF4 blocks s_m ≈ 1.4 GB; PETALS places 53 blocks on an A100 and 4 on a
  MIG; our CG-BP places ~41 / 3 — §4.2 Remark).  τ values are fit to the
  Table 8 per-token times; they are *configurable*, the algorithms never
  depend on the constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.perf_model import (GB, LLMSpec, BLOOM_PETALS,
                                         Problem, ServerSpec, Workload)

# profiled per-block times (s) — calibration targets in benchmarks/README
A100 = dict(tau=0.011, tau_p0=0.030, tau_p1=0.001, mem=78 * GB)
MIG = dict(tau=0.030, tau_p0=0.080, tau_p1=0.003, mem=8 * GB)

EMBED_BYTES = 2 * 14336  # one bf16 embedding per token (BLOOM)


@dataclass
class NetParams:
    rtt_s: float  # propagation round trip
    bandwidth_bps: float

    def token_rtt(self) -> float:
        return self.rtt_s + 2 * 8 * EMBED_BYTES / self.bandwidth_bps

    def prefill_rtt(self, l_in: int) -> float:
        return self.rtt_s + 2 * 8 * EMBED_BYTES * l_in / self.bandwidth_bps


INTRA = NetParams(0.005, 1e9)
INTER = NetParams(0.100, 100e6)


def make_server(sid: int, profile: dict) -> ServerSpec:
    return ServerSpec(sid=sid, mem_bytes=profile["mem"], tau=profile["tau"],
                      tau_prefill_base=profile["tau_p0"],
                      tau_prefill_per_token=profile["tau_p1"])


def clustered_scenario(client_cluster: int = 0,
                       workload: Workload = Workload(20, 128),
                       llm: LLMSpec = BLOOM_PETALS
                       ) -> Tuple[Problem, List[int]]:
    """Table 2 deployment.  Servers: ids 0–1 = A100s (cluster1),
    2–8 = MIGs (cluster2).  One client in ``client_cluster``.

    Returns (problem, server_cluster_of) for inspection.
    """
    servers = [make_server(0, A100), make_server(1, A100)]
    servers += [make_server(2 + i, MIG) for i in range(7)]
    cluster_of = [1, 1] + [2] * 7
    n = len(servers)
    rtt_tok = np.zeros((1, n))
    rtt_pre = np.zeros((1, n))
    for j in range(n):
        net = INTRA if cluster_of[j] == client_cluster else INTER
        rtt_tok[0, j] = net.token_rtt()
        rtt_pre[0, j] = net.prefill_rtt(workload.l_in)
    return (Problem(llm, servers, 1, rtt_tok, rtt_pre, workload),
            cluster_of)


def scattered_scenario(rtt_matrix_s: np.ndarray, server_nodes: List[int],
                       client_node: int, high_perf: List[bool],
                       workload: Workload = Workload(20, 128),
                       llm: LLMSpec = BLOOM_PETALS,
                       bandwidth_bps: float = 1e9) -> Problem:
    """Build a Problem from a topology RTT matrix (see sim.topologies)."""
    servers = []
    n = len(server_nodes)
    rtt_tok = np.zeros((1, n))
    rtt_pre = np.zeros((1, n))
    for j, node in enumerate(server_nodes):
        servers.append(make_server(j, A100 if high_perf[j] else MIG))
        ser_tok = 2 * 8 * EMBED_BYTES / bandwidth_bps
        ser_pre = ser_tok * workload.l_in
        rtt_tok[0, j] = rtt_matrix_s[client_node, node] + ser_tok
        rtt_pre[0, j] = rtt_matrix_s[client_node, node] + ser_pre
    return Problem(llm, servers, 1, rtt_tok, rtt_pre, workload)
