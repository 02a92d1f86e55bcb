"""Internet-Topology-Zoo-style topologies (paper Table 3) — a copy of the
reference's ``repro/sim/topologies.py``.

The Zoo's GraphML files are not redistributable here, so we *synthesise*
seeded random geometric graphs matching each topology's published node
count, link count, and link-delay range (AboveNet 23/62/[0.1,13.8] ms,
BellCanada 48/130/[0.078,6.16] ms, GTS-CE 149/386/[0.005,1.081] ms) with
1 Gbit/s links, and compute node-pair RTTs along delay-shortest paths as in
§4.1.  The generator is deterministic per (name, seed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

TOPOLOGY_SPECS = {
    "abovenet": dict(n=23, links=62, delay_ms=(0.100, 13.800)),
    "bellcanada": dict(n=48, links=130, delay_ms=(0.078, 6.160)),
    "gts_ce": dict(n=149, links=386, delay_ms=(0.005, 1.081)),
}


@dataclass
class Topology:
    name: str
    n: int
    edges: List[Tuple[int, int, float]]  # (u, v, one-way delay seconds)
    rtt: np.ndarray  # (n, n) round-trip seconds via shortest delay paths


def _geometric_graph(n: int, links: int, delay_range, seed: int):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2))
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    # spanning tree first (connectivity), then shortest remaining pairs
    edges = set()
    in_tree = {0}
    out = set(range(1, n))
    while out:
        best = None
        for u in in_tree:
            for v in out:
                if best is None or d[u, v] < d[best[0], best[1]]:
                    best = (u, v)
        edges.add(tuple(sorted(best)))
        in_tree.add(best[1])
        out.remove(best[1])
    pairs = [(d[u, v], u, v) for u in range(n) for v in range(u + 1, n)
             if (u, v) not in edges]
    pairs.sort()
    for _, u, v in pairs:
        if len(edges) >= links:
            break
        edges.add((u, v))
    lo, hi = delay_range
    dmax = max(d[u, v] for u, v in edges)
    out_edges = []
    for u, v in sorted(edges):
        delay_ms = lo + (hi - lo) * (d[u, v] / dmax)
        out_edges.append((u, v, delay_ms / 1e3))
    return out_edges


def _all_pairs_rtt(n: int, edges) -> np.ndarray:
    INF = np.inf
    dist = np.full((n, n), INF)
    np.fill_diagonal(dist, 0.0)
    for u, v, w in edges:
        dist[u, v] = min(dist[u, v], w)
        dist[v, u] = min(dist[v, u], w)
    for k in range(n):  # Floyd–Warshall (n <= 149)
        dist = np.minimum(dist, dist[:, k: k + 1] + dist[k: k + 1, :])
    return 2.0 * dist  # RTT


def make_topology(name: str, seed: int = 0) -> Topology:
    spec = TOPOLOGY_SPECS[name]
    edges = _geometric_graph(spec["n"], spec["links"], spec["delay_ms"],
                             seed=hash((name, seed)) % (1 << 31))
    rtt = _all_pairs_rtt(spec["n"], edges)
    return Topology(name, spec["n"], edges, rtt)


def place_servers(topo: Topology, n_servers: int, eta: float, seed: int = 0
                  ) -> Tuple[List[int], List[bool], int]:
    """Random server nodes, high-perf fraction η, plus a non-server client
    node (the proxy of §4.1)."""
    rng = np.random.default_rng(seed)
    nodes = rng.permutation(topo.n)
    server_nodes = nodes[:n_servers].tolist()
    client_node = int(nodes[n_servers % topo.n])
    n_high = int(round(eta * n_servers))
    flags = [True] * n_high + [False] * (n_servers - n_high)
    rng.shuffle(flags)
    return server_nodes, flags, client_node
