"""The control comes out not correct through the harness's own comparison:
the plain reference put in the program's place with every matrix rounded
through fp8 (one step below the configurations' bf16) reads a widest gap
above each cell's limit, where the program reads one below it.  On the
CPU at reduced widths (d 256, 4 layers), with outputs of 80-120 tokens so
that a run compares some hundreds of served tokens, as the cells do on the
chip (``bench/control.py`` reads the same numbers there at the cells' own
sizes)."""
import json

import pytest

from bench_support import BENCH, reduced_cell, reduced_config, reduced_traffic
import control
import run

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
WIDER = {"bloom176b-l11": dict(hidden_size=256, n_head=8, vocab_size=1024),
         "chameleon34b": dict(hidden_size=256, num_attention_heads=8,
                              num_key_value_heads=4, intermediate_size=384,
                              vocab_size=1024)}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit(cell):
    wl = run.cell_spec(cell, SPEC)
    t = reduced_traffic(wl["traffic"])
    t.update(new_tokens=dict(min=80, max=120, dist="uniform"),
             check_requests=10,
             max_seq_len=t["prompt_tokens"]["max"] + 120)
    c = reduced_config(wl["config"])
    c.update(WIDER[wl["config"]])
    cf = reduced_cell(cell)
    limit = cf["limits"]["widest_gap"]
    rows = control.readings(cell, [1, 2, 3], 12.0, device="cpu", config=c,
                            traffic=t, cell_file=cf)
    for r in rows:
        assert r["served"] >= 300, r
        assert r["program"] <= limit < r["control"], (limit, r)
        assert r["limit"] == limit and not r["correct"], r
