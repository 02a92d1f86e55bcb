"""The harness on the CPU: the trace generator, the window logic and the
metric arithmetic, and whole runs of every cell at reduced widths.  A CPU
run reports no device metric; the traced run is the card's and skips
here."""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from bench_support import (BENCH, REDUCED_ROWS, reduced_cell,
                           reduced_config, reduced_traffic)
import costs
import harness
import readers
import run
import traffic as traffic_mod

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
DEVICE_METRICS = {m["name"] for m in SPEC["per_layer"]
                  if m["source"] == "device_trace"}
MIXES = sorted({w["traffic"] for w in SPEC["workloads"]})


def _shape(reqs):
    return [(len(r.prompt), r.n_new, r.arrival) for r in reqs]


@pytest.mark.parametrize("name", MIXES)
def test_one_seed_one_trace_and_seeds_differ_in_token_ids_only(name):
    t = traffic_mod.load(name)
    a = traffic_mod.generate(t, 2**31 + 17, 1000, 16)
    b = traffic_mod.generate(t, 5, 1000, 16)
    again = traffic_mod.generate(t, 5, 1000, 16)
    assert len(a) == t["requests"]
    assert [r.prompt.tolist() for r in b] == \
        [r.prompt.tolist() for r in again]
    assert _shape(b) == _shape(again)
    # every seed serves the same lengths and arrivals, other token ids
    assert _shape(a) == _shape(b)
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in b]
    lo, hi = t["prompt_tokens"]["min"], t["prompt_tokens"]["max"]
    assert all(lo <= len(r.prompt) <= hi and r.prompt.min() >= 2
               and r.prompt.max() < 1000 for r in a)
    assert all(len(r.prompt) + r.n_new <= t["max_seq_len"] for r in a)


def test_backlog_fills_with_residual_outputs_then_draws_the_mix():
    t = traffic_mod.load("chat_backlog")
    rows = 64
    reqs = traffic_mod.generate(t, 3, 1000, rows)
    lo, hi = t["new_tokens"]["min"], t["new_tokens"]["max"]
    later = [r.n_new for r in reqs[rows:]]
    assert min(later) == lo and max(later) == hi
    assert abs(np.mean(later) - (lo + hi) / 2) < 0.5
    first = [r.n_new for r in reqs[:rows]]
    assert min(first) >= 1 and max(first) <= hi and min(first) < lo
    # the residual of U{96..160}: mean (E[L^2] + E[L]) / (2 E[L]) ~ 66.4
    assert abs(np.mean(first) - 66.4) < 3
    assert all(r.arrival == 0.0 for r in reqs)


def test_bursts_run_from_one_to_rows_and_are_spaced_by_the_gap():
    t = traffic_mod.load("long_prompt_bursts")
    rows = 6
    reqs = traffic_mod.generate(t, 3, 1000, rows)
    arr = np.array([r.arrival for r in reqs])
    times, sizes = np.unique(arr, return_counts=True)
    assert sizes[:-1].min() == 1 and sizes.max() == rows
    assert set(sizes[:-1]) == set(range(1, rows + 1))
    assert np.allclose(np.diff(times), t["arrivals"]["gap_s"])
    lens = [len(r.prompt) for r in reqs]
    assert abs(np.median(lens) - 1020) < 30
    assert 12 <= np.median([r.n_new for r in reqs]) <= 13


class Clock:
    t = 100.0

    def __call__(self):
        return self.t


class FakeSystem:
    """The engine calls the harness wraps, on a fake clock: a prefill round
    takes 0.25 s and advances every pending group by one chunk of at most
    ``CHUNK`` tokens (padded to it), a decode round 0.125 s and gives every
    active session a token."""

    CHUNK = 4

    def __init__(self, clock):
        self.clock = clock
        self.sessions = {}
        self._prefill_groups = []
        self.active = []

    def _prefill_plan(self, n):
        return [(off, min(n - off, self.CHUNK), self.CHUNK)
                for off in range(0, n, self.CHUNK)]

    def create_session(self, tokens, client, route, n_new, **kw):
        sid = len(self.sessions)
        self.sessions[sid] = SimpleNamespace(
            sid=sid, tokens=list(tokens), prompt_len=len(tokens),
            state="admitted")
        return sid

    def try_admit_sessions(self, sids, now=0.0):
        members = [self.sessions[s] for s in sids]
        for s in members:
            s.state = "prefilling"
        self._prefill_groups.append(SimpleNamespace(members=members,
                                                    offset=0))
        return sids

    def prefill_round(self):
        self.clock.t += 0.25
        done = []
        for g in self._prefill_groups:
            g.offset += self.CHUNK
            for s in g.members:
                if s.state == "prefilling" and s.prompt_len <= g.offset:
                    s.state = "active"
                    s.tokens.append(7)
                    done.append(s.sid)
        self._prefill_groups = [g for g in self._prefill_groups if any(
            s.state == "prefilling" for s in g.members)]
        self.active += done
        return done

    def decode_round(self):
        self.clock.t += 0.125
        return {sid: 9 for sid in self.active}


def test_the_window_counts_decode_tokens_and_live_prefill_tokens():
    clock = Clock()
    sysm = FakeSystem(clock)
    dims = harness.dims(reduced_config("bloom176b-l11"))
    w = harness.Window(dims=dims, rows=4, open_after=2, seconds=1.0)
    opened = []
    harness.Stamps(sysm, w, "cpu", on_open=lambda: opened.append(clock.t),
                   clock=clock)
    a = sysm.create_session([2, 3, 4], 0, None, 50)  # taken up at 100
    sysm.try_admit_sessions([a])
    sysm.prefill_round()  # 100.25: a's first token (3 live of 4)
    sysm.decode_round()  # 100.375: two rounds before the window
    clock.t = 100.5
    b = sysm.create_session(list(range(2, 12)), 0, None, 50)  # 10 tokens
    sysm.try_admit_sessions([b])
    with pytest.raises(harness.WindowClosed):
        sysm.prefill_round()  # opens at 100.5; b's chunk 1: 4 live
        sysm.decode_round()  # 100.875
        sysm.prefill_round()  # 101.125: b's chunk 2: 4 live
        sysm.prefill_round()  # 101.375: b's chunk 3: 2 live, first token
        for _ in range(10):
            sysm.decode_round()  # 101.5: closes
    assert opened == [100.5] and w.t_open == 100.5
    assert w.t_close == 101.5 and w.wall == 1.0
    # decode rounds inside: 100.875 (a), 101.5 (a, b); first tokens are not
    # decode tokens
    assert readers.decode_tokens(w) == 3
    # every chunk's live tokens, padding and whole prompts aside: 4 + 4 + 2
    # over the wall to the end of the last prefill round
    assert readers.prefill_rate(w) == pytest.approx(10 / 0.875)
    assert [sum(sp for _, _, sp, _ in ch) for _, ch in w.chunks] == \
        [3, 4, 4, 2]
    # b: taken up at 100.5, first token at 101.375
    assert readers.ttfts(w) == [pytest.approx(0.875)]
    assert readers.round_ms(w, "decode_round") == 125.0
    assert readers.round_ms(w, "prefill_round") == 250.0
    assert readers.rows_busy(w) == pytest.approx(100 * 3 / 8)
    assert readers.engine_share(w) == 1.0
    gaps = readers.token_gaps(w)
    # a: 100.375 -> 100.875 -> 101.5; b: 101.375 -> 101.5
    assert sorted(gaps) == pytest.approx([0.125, 0.5, 0.625])
    want = (costs.chunk_flops(dims, 0, 4, False)
            + costs.chunk_flops(dims, 4, 4, False)
            + costs.chunk_flops(dims, 8, 2, True)
            + sum(costs.token_flops(dims, p) + costs.head_flops(dims)
                  for p in (4, 5, 10)))
    assert readers.useful_flops(w) == want
    assert readers.mfu(w) == pytest.approx(
        100 * want / costs.PEAK_FLOPS_BF16)
    assert readers.idle_share(w) is None and \
        readers.roofline(w, [(1.0, 1.0)], readers.K1_KERNELS) is None


def _cell_parts(cell):
    wl = run.cell_spec(cell, SPEC)
    return (reduced_config(wl["config"]), reduced_traffic(wl["traffic"]),
            reduced_cell(cell))


def test_the_backlog_keeps_every_row_decoding_in_a_cpu_serve():
    """The closed loop refills each retired row at the next admission: the
    decode rounds run (nearly) every row.  A round can find one row whose
    session has all its tokens but whose end on the virtual clock comes
    after another session's: the scheduler retires in virtual-time order."""
    c, t, cf = _cell_parts("bloom176b.decode")
    n = harness.dims(c)
    rows = REDUCED_ROWS
    weights = harness.make_weights(c, 11, "cpu")
    system = harness.build_system(c, t, rows, weights, "cpu")
    reqs = traffic_mod.generate(t, 11, n["vocab"], rows)
    w = harness.Window(dims=n, rows=rows, open_after=4, seconds=1e9)
    real = system.decode_round

    def stop_after_60(*a, **kw):
        out = real(*a, **kw)
        if len([s for s in w.spans if s[0] == "decode_round"]) >= 59:
            raise harness.WindowClosed()
        return out

    system.decode_round = stop_after_60
    harness.drive(system, t, reqs, w, "cpu")
    w.t_close = w.spans[-1][2] + 1e-9
    dec = [s for s in w.spans if s[0] == "decode_round"]
    assert len(dec) == 59
    assert sum(s[3] == rows for s in dec) >= 0.9 * len(dec)
    assert min(s[3] for s in dec) >= rows - 1
    assert readers.rows_busy(w) >= 95.0
    finished = sum(1 for s in w.sessions.values() if s.complete)
    assert finished > 10
    # each request the scheduler took up was admitted at once: the queue
    # waits at the client, never in the scheduler
    assert len(w.admitted) == len(w.sessions) >= finished


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_of_each_cell(cell):
    c, t, cf = _cell_parts(cell)
    cf = dict(cf, limits={"widest_gap": 1e9})
    res = run.run_cell(cell, 2**31 + 3, 2.0, False, device="cpu", spec=SPEC,
                       config=c, traffic=t, cell_file=cf)
    want = {m["name"] for m in run.metrics_of(cell, SPEC, False)}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"] and "breakdown" not in res
    assert not set(res["metrics"]) & DEVICE_METRICS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-2:] == ["checks", "_detail"]
    assert res["checks"]["finished_checked"]["value"] >= 1


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in SPEC["workloads"]:
        assert (BENCH / "cells" / f"{w['name']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for c in SPEC["configs"]:
        assert (BENCH.parent / c["file"]).exists()


@pytest.fixture
def gpu():
    """Skips a card test where there is no CUDA card (decided here, inside
    the test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels' CUDA builds)")


@pytest.mark.gpu
def test_traced_run_on_the_card(gpu):
    cell = CELLS[0]
    c, t, cf = _cell_parts(cell)
    cf = dict(cf, limits={"widest_gap": 1e9})
    res = run.run_cell(cell, 11, 1.0, True, device="cuda", spec=SPEC,
                       config=c, traffic=t, cell_file=cf)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert set(res["metrics"]) == {
        m["name"] for m in run.metrics_of(cell, SPEC, True)}
