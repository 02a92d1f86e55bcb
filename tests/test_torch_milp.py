"""The port's MILP solvers (``repro_torch.core.milp``, a copy) against the
reference's ``repro.core.milp`` on seeded toy problems, on the CPU.

Both build the same constraint matrices and hand them to the same scipy
HiGHS, so objectives, placements and routes must be EQUAL; the joint MILP
must also reach the brute-force optimum (within 1e-6, the reference test's
tolerance, tests/test_core_bprr.py)."""
import numpy as np
import pytest

import repro.core as RC
import repro.core.milp as RM
import repro_torch.core as TC
import repro_torch.core.milp as TM


def _toy(C, seed=3, n=3, L=3):
    """tests/test_core_bprr.py:106-120's toy: 2 clients, tight memory."""
    rng = np.random.default_rng(seed)
    llm = C.LLMSpec("t", L, block_bytes=4.0, cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=float(14 + 4 * rng.random()),
                            tau=float(0.1 + 0.2 * rng.random()))
               for j in range(n)]
    rtt = 0.05 + 0.2 * rng.random((2, n))
    return C.Problem(llm, servers, 2, rtt, rtt * 5, workload=C.Workload(2, 1))


def _routing_problem(C, seed, L=4, n=4, clients=2):
    rng = np.random.default_rng(seed)
    llm = C.LLMSpec("t", L, block_bytes=4.0, cache_bytes_per_token=0.25)
    servers = [C.ServerSpec(j, mem_bytes=float(4 * rng.integers(2, 6)),
                            tau=float(0.05 + 0.3 * rng.random()))
               for j in range(n)]
    rtt = 0.02 + 0.3 * rng.random((clients, n))
    return C.Problem(llm, servers, clients, rtt, 4 * rtt,
                     workload=C.Workload(2, 4))


def _routes(routes):
    return [(r.servers, tuple(int(b) for b in r.blocks)) for r in routes]


@pytest.mark.parametrize("seed", [3, 5])
def test_bprr_milp_equals_reference_and_brute_force(seed):
    out = {}
    for name, C, M in (("ref", RC, RM), ("port", TC, TM)):
        prob = _toy(C, seed)
        res = M.solve_bprr_milp(prob, [0, 1])
        bf, bf_pl = M.brute_force_bprr(prob, [0, 1])
        out[name] = (res.status, res.objective, res.placement.a.tolist(),
                     res.placement.m.tolist(), _routes(res.routes), bf,
                     bf_pl.a.tolist(), bf_pl.m.tolist())
        assert res.status == 0
        assert abs(res.objective - bf) < 1e-6
        for route in res.routes:
            assert C.route_feasible(res.placement, prob.L, route.servers)
    assert out["ref"] == out["port"]


@pytest.mark.parametrize("seed,routable", [(0, True), (5, True), (6, True),
                                           (12, False), (16, True)])
def test_routing_ilp_equals_reference(seed, routable):
    """Four requests from two clients; at seed 12 the slots cannot hold
    them all and both solvers return (inf, [])."""
    out = {}
    for name, C, M in (("ref", RC, RM), ("port", TC, TM)):
        prob = _routing_problem(C, seed)
        pl, info = C.cg_bp(prob, 2)
        assert info.feasible
        obj, routes = M.solve_routing_ilp(prob, pl, [0, 1, 1, 0])
        out[name] = (obj, _routes(routes))
    assert out["ref"] == out["port"]
    assert np.isfinite(out["port"][0]) == routable


@pytest.mark.parametrize("seed", [0, 2, 9])
def test_online_routing_equals_reference(seed):
    """The per-request online MILP (21) with waiting times: some edges
    wait, one edge is unusable (inf)."""
    out = {}
    for name, C, M in (("ref", RC, RM), ("port", TC, TM)):
        prob = _routing_problem(C, seed)
        pl, info = C.cg_bp(prob, 2)
        assert info.feasible
        rng = np.random.default_rng(seed + 100)
        n = prob.n_servers
        waiting = np.where(rng.random((n + 1, n)) < 0.3,
                           0.1 * rng.random((n + 1, n)), 0.0)
        waiting[n, int(rng.integers(n))] = np.inf
        route, obj = M.solve_online_routing(prob, pl, 1, waiting)
        out[name] = (obj, None if route is None else _routes([route]))
    assert out["ref"] == out["port"]
