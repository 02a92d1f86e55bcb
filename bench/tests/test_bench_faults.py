"""A run with the timed path broken underneath comes out not correct under
the cell's own limit, and a sound run comes out correct.  The runs skip the
harness's look for a card and drive the rest of a run on the CPU at reduced
widths.  Faults a serving cell can have: a step that leaves its state
unchanged (the decode step writes no K/V), half of the batch left out of
each pooled step (one half of the pool rows, the other half the next step,
pass the hop's layers untouched, in prefill and in decode), and a token
altered where it is produced (the round's sampler).  The cells run on one
card: no exchange between chips to leave out."""
import json

import pytest

from bench_support import BENCH, reduced_cell, reduced_config, reduced_traffic
import run

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _run(cell, seed=2**31 + 5):
    wl = run.cell_spec(cell, SPEC)
    c, t = reduced_config(wl["config"]), reduced_traffic(wl["traffic"])
    return run.run_cell(cell, seed, 1.0, False, device="cpu", spec=SPEC,
                        config=c, traffic=t, cell_file=reduced_cell(cell))


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "write_token",
                        lambda cache, new, pos, active=None, shard=None:
                        None)


def _half_batch(monkeypatch):
    from repro_torch.serving.engine import BlockServer

    calls = [0]

    def half(active):
        """Every other step leaves out the upper half of the pool rows, the
        other steps the lower half: each session loses some of its steps."""
        active = active.clone()
        n = active.shape[1] // 2
        if calls[0] % 2:
            active[:, n:] = False
        else:
            active[:, :n] = False
        calls[0] += 1
        return active

    real_round, real_prefill = BlockServer.round_rows, BlockServer.prefill_rows

    def round_rows(self, h_round, pos_round, slot_of_row, row_of_slot,
                   layer_active, *a, **kw):
        return real_round(self, h_round, pos_round, slot_of_row,
                          row_of_slot, half(layer_active), *a, **kw)

    def prefill_rows(self, h_rows, layer_active, *a, **kw):
        return real_prefill(self, h_rows, half(layer_active), *a, **kw)

    monkeypatch.setattr(BlockServer, "round_rows", round_rows)
    monkeypatch.setattr(BlockServer, "prefill_rows", prefill_rows)


def _token_altered(monkeypatch):
    from repro_torch.serving import engine, sampling

    real = sampling.sample_rows

    def altered(logits, *a, **kw):
        return (real(logits, *a, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(sampling, "sample_rows", altered)
    monkeypatch.setattr(engine, "sample_rows", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["widest_gap"]["value"] > \
        res["checks"]["widest_gap"]["limit"]
