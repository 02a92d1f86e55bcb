"""The serving engine's spans and work counts (``serving/trace.py``) on the
CPU: a reduced Llama served through the scheduler with fused decode and
batched prefill gives the same tokens, virtual clocks and ``round_stats``
with the tracer on and off; the spans nest, every decode round holds one
``readback`` and one ``step`` per hop dispatch; the counts of the pooled
steps' work equal a hand count."""
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch.core as C
from repro_torch.configs import get_reduced_config
from repro_torch.models import init_params
from repro_torch.serving import ContinuousBatchingScheduler, GeoServingSystem
from repro_torch.serving.trace import NULL, Tracer

torch.set_num_threads(1)

CFG = get_reduced_config("llama3_2_1b").replace(n_layers=4)
RESULT_FIELDS = ("rid", "arrival", "start", "first_token", "per_token",
                 "total", "wait", "per_token_rest", "dropped",
                 "n_deferrals", "n_preemptions")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _system(params, **kw):
    """Five servers; CG-BP places a = (0, 1, 2, 2, 0), m = (1, 1, 2, 2, 2):
    server 4 hosts layers [0, 2), server 1 [1, 2), server 2 [2, 4), four
    pool rows each."""
    mem = (130.0, 130.0, 220.0, 220.0, 220.0)
    taus = (0.004, 0.004, 0.020, 0.020, 0.020)
    llm = C.LLMSpec("llama-reduced", CFG.n_layers, block_bytes=50.0,
                    cache_bytes_per_token=0.5)
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
    prob = C.Problem(llm, [C.ServerSpec(j, m, t) for j, (m, t) in
                           enumerate(zip(mem, taus))], 1, rtt, 3 * rtt,
                     workload=C.Workload(8, 16))
    system = GeoServingSystem(CFG, params, prob, R=4, max_new_tokens=8,
                              max_sessions=4, device="cpu", **kw)
    assert system.placement.a.tolist() == [0, 1, 2, 2, 0]
    assert system.placement.m.tolist() == [1, 1, 2, 2, 2]
    return system


def _serve(system):
    """Ten requests, prompts 5-32 (buckets 8 / 16 / 32), four at a time;
    records round_stats["hop_dispatches"] across each decode round."""
    real = system.decode_round
    hops = []

    def decode_round(*a, **kw):
        before = system.round_stats["hop_dispatches"]
        out = real(*a, **kw)
        hops.append(system.round_stats["hop_dispatches"] - before)
        return out

    system.decode_round = decode_round
    sched = ContinuousBatchingScheduler(system, R=4)
    rng = np.random.RandomState(0)
    for i in range(10):
        sched.submit(i, rng.randint(2, CFG.vocab_size, 5 + 3 * i),
                     0.05 * i, n_new=3 + i % 4)
    return sched.run(), hops


def _children(spans):
    kids = {id(s): [] for s in spans}
    for s in spans:
        if s.parent is not None:
            kids[id(s.parent)].append(s)
    return kids


@pytest.mark.parametrize("cache_layout", ["slab", "paged"])
def test_tracing_changes_nothing_and_spans_nest(params, cache_layout):
    off = _system(params, cache_layout=cache_layout)
    assert off.tracer is NULL
    want, _ = _serve(off)
    on = _system(params, cache_layout=cache_layout)
    tr = on.tracer = Tracer()
    got, hops = _serve(on)
    for a, b in zip(want, got):
        assert list(a.tokens) == list(b.tokens), a.rid
        for f in RESULT_FIELDS:  # virtual clocks: bit-identical floats
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
    assert len(want) == len(got) == 10
    assert on.round_stats == off.round_stats

    spans = tr.spans
    assert not tr._stack and all(s.end is not None for s in spans)
    for s in spans:
        p = s.parent
        if p is not None:
            assert p.start <= s.start <= s.end <= p.end
            assert s.depth == p.depth + 1
    assert {s.name for s in spans if s.parent is None} == \
        {"admit", "prefill_round", "decode_round"}
    kids = _children(spans)
    rounds = [s for s in spans if s.name == "decode_round"]
    assert len(rounds) == len(hops) > 0
    for r, n_hops in zip(rounds, hops):
        below = Counter()
        todo = list(kids[id(r)])
        while todo:
            s = todo.pop()
            below[s.name] += 1
            todo += kids[id(s)]
        assert below["readback"] == 1
        assert below["step"] == below["hop"] == n_hops
        assert [k.name for k in kids[id(r)]][:1] == ["prep"]
        assert [k.name for k in kids[id(r)]][-3:] == \
            ["tail", "readback", "emit"]
    for s in spans:
        if s.name == "hop":  # a step per call: one, or one a member
            names = [k.name for k in kids[id(s)]]
            assert names[:1] == ["stage"] and names[1:] and \
                set(names[1:]) == {"step"}
            assert 0 < s.attrs["work_live"] <= s.attrs["work_run"]
        if s.name == "finalize":
            assert [k.name for k in kids[id(s)]] == ["readback"]
    # every session's first token is one finalize, each with its readback
    assert sum(s.name == "finalize" for s in spans) == 10
    # the counts sit on the hop spans alone
    assert all(not s.attrs for s in spans if s.name != "hop")


def test_work_counts_equal_a_hand_count(params):
    """Route 4 -> 1 -> 2 over blocks (1, 1, 2): server 4 hosts layers
    [0, 2) and runs layer 0 alone (layer 1 masked).  Two prompts of 5 and
    7 tokens, one group padded to the 8-token bucket, then one decode
    round of both."""
    system = _system(params)
    tr = system.tracer = Tracer()
    route = C.Route(servers=(4, 1, 2), blocks=(1, 1, 2))
    rng = np.random.RandomState(1)
    sids = [system.create_session(rng.randint(2, CFG.vocab_size, n), 0,
                                  route, 3) for n in (5, 7)]
    assert system.try_admit_sessions(sids) == sids
    assert sorted(system.prefill_round()) == sids
    assert sorted(system.decode_round()) == sids
    hops = [s.attrs for s in tr.spans if s.name == "hop"]
    rows = 4
    # the hops in route order, servers 4, 1, 2
    assert hops == [{"work_run": run, "work_live": live} for run, live in [
        # prefill: hosted layers x the two members' one-row calls x 8
        # padded positions; live: the route's layers x 5 + 7 prompt tokens
        (2 * 2 * 8, 1 * 12), (1 * 2 * 8, 1 * 12),
        (2 * 2 * 8, 2 * 12),
        # decode: one position a row
        (2 * rows, 1 * 2), (1 * rows, 1 * 2), (2 * rows, 2 * 2)]]
    kids = _children(tr.spans)
    assert [sum(k.name == "step" for k in kids[id(s)]) for s in tr.spans
            if s.name == "hop"] == [2, 2, 2, 1, 1, 1]
    assert sum(s.name == "group" for s in tr.spans) == 1
    assert sum(s.name == "finalize" for s in tr.spans) == 2
    assert sum(s.name == "readback" for s in tr.spans) == 3


def test_the_null_tracer_records_nothing():
    assert not NULL.on
    a, b = NULL.span("decode_round"), NULL.span("step")
    assert a is b
    with a as s:
        assert s is None
    clock = iter([1.0, 2.0, 3.0, 4.0])
    tr = Tracer(clock=lambda: next(clock))
    with tr.span("outer"):
        tr.count("work_run", 2)
        with tr.span("inner"):
            tr.count("work_run", 3)
            tr.count("work_run", 1)
    outer, inner = tr.spans
    assert (outer.start, inner.start, inner.end, outer.end) == \
        (1.0, 2.0, 3.0, 4.0)
    assert inner.parent is outer and outer.parent is None
    assert (outer.depth, inner.depth) == (0, 1)
    assert outer.attrs == {"work_run": 2}
    assert inner.attrs == {"work_run": 4}
