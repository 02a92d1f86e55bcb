"""The port's simulator (``repro_torch.sim``, a numpy copy) against the
reference's ``repro.sim``, on the CPU.

Both packages build the same problems and traces from the same seeds; every
``SimResult`` field must be EQUAL (no tolerance: the copies run the same
arithmetic in the same order), except ``decision_time_s``, which is the
wall clock of the run.  Covered: the workload generators, the topologies
and server placement, the clustered and scattered scenarios, every
algorithm on poisson / bursty / multi-client / diurnal traces in both
``sim_mode``s, the contended cross-validation topology, ``run_comparison``,
``simulate_churn`` and ``simulate_faults``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as RC
import repro.sim as RS
import repro_torch.core as TC
import repro_torch.sim as TS
from repro.serving.faults import FaultPlan as RFaultPlan
from repro_torch.serving.faults import FaultPlan as TFaultPlan


def _requests(trace):
    return [(r.rid, r.client, r.arrival) for r in trace]


def _problem_fields(p):
    return (dataclasses.astuple(p.llm), [dataclasses.astuple(s)
                                         for s in p.servers],
            p.n_clients, p.rtt_token.tolist(), p.rtt_prefill.tolist(),
            dataclasses.astuple(p.workload))


def assert_same_result(ref, got):
    """Every field of two result dataclasses equal (the placement by its
    arrays), the run's wall clock excepted."""
    assert type(ref).__name__ == type(got).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "decision_time_s":
            continue
        if f.name == "placement":
            assert (a is None) == (b is None)
            if a is not None:
                assert a.a.tolist() == b.a.tolist()
                assert a.m.tolist() == b.m.tolist()
            continue
        assert a == b, f.name


# ---------------------------------------------------------------------------
# workloads, topologies, scenarios
# ---------------------------------------------------------------------------

GENERATORS = {
    "poisson": lambda S: S.poisson_requests(30, 0.7, seed=3),
    "poisson_clients": lambda S: S.poisson_requests(30, 0.7, seed=4,
                                                    n_clients=3),
    "burst": lambda S: S.burst_requests(6, at=1.5, client=1),
    "bursty": lambda S: S.bursty_requests(4, 3, 2.0),
    "bursty_jitter": lambda S: S.bursty_requests(4, 3, 2.0, jitter=0.1,
                                                 seed=5),
    "diurnal": lambda S: S.diurnal_requests(200, 0.1, 1.5, period=60.0,
                                            seed=3, n_clients=2),
}


@pytest.mark.parametrize("kind", list(GENERATORS))
def test_request_generators_equal(kind):
    ref, got = GENERATORS[kind](RS), GENERATORS[kind](TS)
    assert _requests(ref) == _requests(got)
    if kind == "diurnal":
        assert isinstance(got, TS.RequestBatch)
        assert _requests(TS.RequestBatch.from_requests(got.to_requests())) \
            == _requests(ref)


def test_schedules_rates_and_prompts_equal():
    t = np.linspace(0.0, 120.0, 37)
    assert RS.diurnal_rate(t, 0.2, 2.0, 60.0).tolist() == \
        TS.diurnal_rate(t, 0.2, 2.0, 60.0).tolist()
    ref = RS.churn_schedule(9, 4, 2, seed=3, protect=(0,))
    got = TS.churn_schedule(9, 4, 2, seed=3, protect=(0,))
    assert [dataclasses.astuple(e) for e in ref] == \
        [dataclasses.astuple(e) for e in got]
    ref = RS.fault_schedule(6, 7, n_crashes=2, n_transients=1,
                            n_stragglers=1, n_dispatch_errors=1, protect=(0,))
    got = TS.fault_schedule(6, 7, n_crashes=2, n_transients=1,
                            n_stragglers=1, n_dispatch_errors=1, protect=(0,))
    assert isinstance(got, TFaultPlan)
    assert [dataclasses.astuple(e) for e in ref.events] == \
        [dataclasses.astuple(e) for e in got.events]
    reqs = RS.poisson_requests(5, 1.0, seed=2)
    for a, b in zip(RS.prompts_for(reqs, 7, 500, seed=1),
                    TS.prompts_for(TS.poisson_requests(5, 1.0, seed=2), 7,
                                   500, seed=1)):
        assert a.tolist() == b.tolist()


@pytest.mark.parametrize("name", sorted(TS.TOPOLOGY_SPECS))
def test_topologies_and_placement_equal(name):
    ref, got = RS.make_topology(name, seed=1), TS.make_topology(name, seed=1)
    assert (ref.n, ref.edges) == (got.n, got.edges)
    assert ref.rtt.tolist() == got.rtt.tolist()
    assert RS.place_servers(ref, 9, 0.3, seed=2) == \
        TS.place_servers(got, 9, 0.3, seed=2)


def test_scenarios_equal():
    (rp, rc), (tp, tc) = RS.clustered_scenario(), TS.clustered_scenario()
    assert rc == tc and _problem_fields(rp) == _problem_fields(tp)
    topo_r = RS.make_topology("abovenet", seed=0)
    topo_t = TS.make_topology("abovenet", seed=0)
    nodes, flags, client = RS.place_servers(topo_r, 9, 0.3, seed=0)
    assert _problem_fields(RS.scattered_scenario(topo_r.rtt, nodes, client,
                                                 flags)) == \
        _problem_fields(TS.scattered_scenario(topo_t.rtt, nodes, client,
                                              flags))


# ---------------------------------------------------------------------------
# simulate: every algorithm x trace x sim_mode
# ---------------------------------------------------------------------------


def _clustered(S, n_clients=1):
    """tests/test_simulator.py's Table-2 deployment, widened to several
    clients at scaled RTTs."""
    C = RC if S is RS else TC
    prob, _ = S.clustered_scenario()
    if n_clients == 1:
        return prob
    rtt_t = np.concatenate([prob.rtt_token * (1.0 + 0.2 * c)
                            for c in range(n_clients)])
    rtt_p = np.concatenate([prob.rtt_prefill * (1.0 + 0.2 * c)
                            for c in range(n_clients)])
    return C.Problem(prob.llm, prob.servers, n_clients, rtt_t, rtt_p,
                     prob.workload)


def _trace(S, kind):
    if kind == "poisson":
        return _clustered(S), S.poisson_requests(40, 0.5, seed=1)
    if kind == "bursty":
        return _clustered(S), S.bursty_requests(n_bursts=10, burst_size=4,
                                                spacing=10.0)
    if kind == "multi_client":
        return (_clustered(S, n_clients=3),
                S.poisson_requests(40, 0.5, seed=2, n_clients=3))
    return _clustered(S), S.diurnal_requests(60, 0.1, 1.5, period=60.0,
                                             seed=3)


def _xval_problem(C, n_clients=1):
    """The cross-validation topology (2 fast + 3 slow servers)."""
    llm = C.LLMSpec("simx", 8, block_bytes=50.0, cache_bytes_per_token=0.5)
    fast = dict(tau_prefill_base=0.002, tau_prefill_per_token=0.0005)
    slow = dict(tau_prefill_base=0.004, tau_prefill_per_token=0.001)
    servers = [C.ServerSpec(j, 500.0, 0.004, **fast) for j in (0, 1)] + \
        [C.ServerSpec(j, 260.0, 0.020, **slow) for j in (2, 3, 4)]
    base = np.array([0.01, 0.01, 0.03, 0.03, 0.03])
    rtt = np.stack([base * (1.0 + 0.2 * c) for c in range(n_clients)])
    return C.Problem(llm, servers, n_clients, rtt, 3 * rtt,
                     workload=C.Workload(8, 12))


@pytest.mark.parametrize("mode", TS.SIM_MODES)
@pytest.mark.parametrize("kind", ["poisson", "bursty", "multi_client",
                                  "diurnal"])
@pytest.mark.parametrize("alg", TS.ALGORITHMS)
def test_simulate_equals_reference(alg, kind, mode):
    assert TS.ALGORITHMS == RS.ALGORITHMS and TS.SIM_MODES == RS.SIM_MODES
    res = []
    for S in (RS, TS):
        prob, requests = _trace(S, kind)
        res.append(S.simulate(prob, S.SimConfig(
            algorithm=alg, n_requests=len(requests), rate=1.0, seed=0,
            sim_mode=mode), requests=requests))
    assert res[0].drop_rate < 1.0
    assert_same_result(*res)


@pytest.mark.parametrize("mode", TS.SIM_MODES)
@pytest.mark.parametrize("alg", ["proposed", "optimized_number", "petals"])
def test_simulate_contended_equals_reference(alg, mode):
    """The cross-validation topology under load (waits > 0), with the
    simulator drawing its own Poisson trace from the config."""
    res = [S.simulate(_xval_problem(C), S.SimConfig(
        algorithm=alg, n_requests=40, rate=2.0, seed=1, R=8, sim_mode=mode))
        for S, C in ((RS, RC), (TS, TC))]
    assert_same_result(*res)


def test_run_comparison_equals_reference():
    rows = [S.run_comparison(_clustered(S, n_clients=3),
                             algorithms=("petals", "proposed"),
                             n_requests=20, rate=0.5, seeds=(0, 1, 2),
                             n_clients=3)
            for S in (RS, TS)]
    assert set(rows[0]) == set(rows[1])
    for alg in rows[0]:
        keys = {k for k in rows[0][alg] if "decision_time" not in k}
        assert keys == {k for k in rows[1][alg]
                        if "decision_time" not in k}
        assert {k: rows[0][alg][k] for k in keys} == \
            {k: rows[1][alg][k] for k in keys}


def test_simulate_churn_equals_reference():
    res = []
    for S, C in ((RS, RC), (TS, TC)):
        prob = _xval_problem(C, n_clients=2)
        reqs = S.poisson_requests(60, rate=2.0, seed=5, n_clients=2)
        sched = S.churn_schedule(prob.n_servers, n_storms=2, storm_size=1,
                                 first=8.0, spacing=8.0, seed=0,
                                 protect=(0, 1))
        res.append(S.simulate_churn(prob, reqs, sched, R=8))
    assert res[0].n_replacements >= 1
    assert_same_result(*res)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_simulate_faults_equals_reference(seed):
    """tests/test_chaos.py's fault-aware admission loop, the same plan
    drawn in both packages (and the fault-free twin)."""
    res = {"faults": [], "fault-free": []}
    for S, C, plan_cls in ((RS, RC, RFaultPlan), (TS, TC, TFaultPlan)):
        llm = C.LLMSpec("toy", 4, block_bytes=50.0,
                        cache_bytes_per_token=1.0)
        servers = [C.ServerSpec(j, 900.0, 0.01 * (j + 1), 0.002, 0.0005)
                   for j in range(6)]
        rtt = np.full((1, 6), 0.02)
        prob = C.Problem(llm, servers, 1, rtt, rtt * 3,
                         workload=C.Workload(4, 16))
        reqs = S.poisson_requests(25, rate=2.0, seed=seed)
        plan = S.fault_schedule(6, seed, horizon=8.0, n_crashes=1,
                                n_transients=1, n_stragglers=1,
                                n_dispatch_errors=1, protect=(0,))
        res["faults"].append(S.simulate_faults(prob, reqs, plan, R=4))
        res["fault-free"].append(S.simulate_faults(prob, reqs, plan_cls(),
                                                   R=4))
    for pair in res.values():
        assert_same_result(*pair)
    assert res["faults"][0].recovery_time == res["faults"][1].recovery_time


def test_subchain_route_equals_reference():
    got = []
    for S, C in ((RS, RC), (TS, TC)):
        prob = _xval_problem(C)
        pl, _ = C.cg_bp(prob, 4)
        route = S.subchain_route(prob, pl, frozenset({0}), 2, 8, 0)
        got.append(None if route is None else
                   (route.servers, tuple(route.blocks)))
    assert got[0] == got[1]
