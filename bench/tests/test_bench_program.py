"""The readers of the program's spans and counts (``bench/program.py``):
the idle attribution on synthetic spans and device intervals, and a CPU
serve through ``harness.drive`` with the program's tracer installed at the
window's open.  The card's traced run of the decode cell is marked
``gpu``."""
import json

import pytest

from bench_support import (BENCH, REDUCED_ROWS, reduced_cell,
                           reduced_config, reduced_traffic)
import devtrace
import harness
import program
import readers
import run
import traffic as traffic_mod
from repro_torch.serving.trace import NULL, Tracer

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def build(tr, clock, node):
    """Open (name, start, end, attrs, children) on ``tr`` at its times."""
    name, t0, t1, attrs, kids = node
    clock.t = t0
    with tr.span(name):
        for k, v in attrs.items():
            tr.count(k, v)
        for kid in kids:
            build(tr, clock, kid)
        clock.t = t1


# window [0, 10]; a decode round, an admission, a prefill round, and a
# decode round that ends after the window closes
TIMELINE = [
    ("decode_round", 1.0, 5.0, {}, [
        ("prep", 1.0, 1.5, {}, []),
        ("hop", 1.5, 4.0, {"work_run": 8, "work_live": 2}, [
            ("stage", 1.5, 2.5, {}, []), ("step", 2.5, 3.5, {}, [])]),
        ("tail", 4.0, 4.2, {}, []), ("readback", 4.2, 4.8, {}, []),
        ("emit", 4.8, 5.0, {}, [])]),
    ("admit", 6.0, 6.5, {}, []),
    ("prefill_round", 7.0, 9.5, {}, [
        ("group", 7.0, 9.5, {}, [
            ("hop", 7.2, 9.0, {"work_run": 64, "work_live": 12}, [
                ("stage", 7.2, 7.5, {}, []), ("step", 7.5, 9.0, {}, [])])])]),
    ("decode_round", 9.6, 10.4, {}, [
        ("hop", 9.6, 10.4, {"work_run": 100, "work_live": 100}, [])]),
]
# device intervals: idle [1.2, 3.0], [4.4, 4.5], [4.6, 7.6], [8.0, 9.8]
EVENTS = [("gemm", 0.0, 1.2), ("gemm", 3.0, 4.4), ("sample", 4.5, 4.6),
          ("Memcpy HtoD", 7.6, 8.0), ("gemm", 9.8, 10.5)]


def synthetic_window():
    clock = Clock()
    tr = Tracer(clock=clock)
    for node in TIMELINE:
        build(tr, clock, node)
    dev = devtrace.DeviceTrace()
    dev.window = (0.0, 10.0)
    dev.events = list(EVENTS)
    w = harness.Window(dims={}, rows=1, open_after=0, seconds=10.0,
                       t_open=0.0, t_close=10.0)
    w.device, w.program = dev, tr
    return w


def test_idle_is_split_at_span_edges_and_credited_innermost():
    w = synthetic_window()
    by = {}
    for span, sec in program.idle_by_span(w.device, w.program.spans):
        by[(span.name, span.start)] = sec
    assert by == pytest.approx({
        ("prep", 1.0): 0.3,
        # the gap [1.2, 3.0] crosses the stage -> step edge at 2.5
        ("stage", 1.5): 1.0, ("step", 2.5): 0.5,
        ("readback", 4.2): 0.1 + 0.2, ("emit", 4.8): 0.2,
        ("admit", 6.0): 0.5, ("group", 7.0): 0.2 + 0.5,
        ("stage", 7.2): 0.3, ("step", 7.5): 0.1 + 1.0,
        ("hop", 9.6): 0.2})
    # idle outside every span ([5, 6], [6.5, 7], [9.5, 9.6]) is no span's
    idle = sum(e - s for s, e in program.idle_intervals(w.device))
    assert idle == pytest.approx(6.7)
    assert idle - sum(by.values()) == pytest.approx(1.6)
    line = program.idle_summary(w)
    assert line.startswith("step 1.6000, stage 1.3000, group 0.7000")
    assert line.endswith("outside program spans 1.6000")


def test_step_and_glue_shares_lie_within_the_idle_share():
    w = synthetic_window()
    step = program.idle_share_in(w, "step")
    glue = program.idle_share_in(w, "glue")
    assert step == pytest.approx(16.0)
    # prep, stage, readback, emit, admit, group, stage, and the last
    # round's hop
    assert glue == pytest.approx(10 * (0.3 + 1.0 + 0.3 + 0.2 + 0.5 + 0.7
                                       + 0.3 + 0.2))
    assert step + glue <= readers.idle_share(w) == pytest.approx(67.0)


def test_kernels_and_work_count_only_rounds_inside_the_window():
    w = synthetic_window()
    # the decode round [1, 5] saw two operations start; the prefill
    # round's copy and the round ending at 10.4 do not count
    assert program.kernels_per_round(w) == 2.0
    assert program.live_work(w) == pytest.approx(100 * (2 + 12) / (8 + 64))


def test_without_the_program_tracer_every_reading_is_none():
    w = synthetic_window()
    w.program = None
    assert program.idle_share_in(w, "step") is None
    assert program.live_work(w) is None
    assert program.kernels_per_round(w) is None
    assert program.idle_summary(w) is None


def test_program_rounds_lie_inside_the_harness_stamps():
    """A CPU serve of the reduced decode cell, the tracer installed where
    the traced run installs it: each program ``decode_round`` /
    ``prefill_round`` / ``admit`` span lies inside the harness's stamp of
    the same call."""
    wl = run.cell_spec("bloom176b.decode", SPEC)
    c, t = reduced_config(wl["config"]), reduced_traffic(wl["traffic"])
    n = harness.dims(c)
    rows = REDUCED_ROWS
    system = harness.build_system(c, t, rows,
                                  harness.make_weights(c, 5, "cpu"), "cpu")
    assert reduced_cell("bloom176b.decode")["rows"] == rows
    w = harness.Window(dims=n, rows=rows, open_after=4, seconds=1e9)
    real = system.decode_round

    def stop_after_30(*a, **kw):
        out = real(*a, **kw)
        if sum(s[0] == "decode_round" for s in w.spans) >= 29:
            raise harness.WindowClosed()
        return out

    system.decode_round = stop_after_30

    def on_open():
        w.program = program.install(system)

    harness.drive(system, t, traffic_mod.generate(t, 5, n["vocab"], rows),
                  w, "cpu", on_open=on_open)
    program.remove(system)
    assert system.tracer is NULL
    names = {"decode_round": "decode_round",
             "prefill_round": "prefill_round",
             "try_admit_sessions": "admit"}
    for stamp_name, span_name in names.items():
        stamps = [s for s in w.spans
                  if s[0] == stamp_name and s[1] >= w.t_open]
        spans = [s for s in w.program.spans
                 if s.parent is None and s.name == span_name]
        assert stamps and len(spans) >= len(stamps)
        for (_, t0, t1, _), s in zip(stamps, spans):
            assert t0 <= s.start <= s.end <= t1


@pytest.fixture
def gpu():
    """Skips a card test where there is no CUDA card (decided here, inside
    the test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels' CUDA builds)")


@pytest.mark.gpu
def test_traced_decode_run_on_the_card(gpu, monkeypatch):
    """The reduced decode cell traced on the card, the program's tracer
    put on at the window's open (``harness.drive`` wrapped here, as a
    traced run would): every reader gives a number, the step and glue
    shares lie within the idle share, and the program's spans hold no more
    idle time than the benchmark's stamps around the same calls."""
    seen = {}
    real = harness.drive

    def drive(system, t, requests, w, device, on_open=lambda: None):
        def open_with_tracer():
            on_open()
            w.program = program.install(system)

        seen["w"] = w
        try:
            return real(system, t, requests, w, device,
                        on_open=open_with_tracer)
        finally:
            program.remove(system)

    monkeypatch.setattr(harness, "drive", drive)
    cell = "bloom176b.decode"
    wl = run.cell_spec(cell, SPEC)
    res = run.run_cell(cell, 13, 1.0, True, device="cuda", spec=SPEC,
                       config=reduced_config(wl["config"]),
                       traffic=reduced_traffic(wl["traffic"]),
                       cell_file=dict(reduced_cell(cell),
                                      limits={"widest_gap": 1e9}))
    w = seen["w"]
    assert res["correct"] and w.program is not None
    step = program.idle_share_in(w, "step")
    glue = program.idle_share_in(w, "glue")
    idle = res["metrics"]["idle_share.decode"]["value"]
    assert 0 <= step and 0 <= glue and step + glue <= idle + 1e-9
    host_in_calls = sum(v for k, v in res["breakdown"]["idle_gaps"]
                        if "between engine calls" not in k)
    # the breakdown places each gap whole at its middle; the spans split
    # it, and the harness's stamps enclose the program's spans
    assert step + glue <= 100 * host_in_calls / res["device"]["window_s"] \
        + 5.0
    assert 0 < program.live_work(w) <= 100
    assert program.kernels_per_round(w) > 0
    assert "outside program spans" in program.idle_summary(w)
