"""What the benchmark's CPU tests share (``python -m pytest -q bench/tests``
from the repository root; the repository's own ``testpaths`` do not collect
them): importing it puts ``bench/`` and ``src/`` on the path, and it gives
the reduced configurations, mixes and cell files."""
import copy
import json
import sys
from pathlib import Path


BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

# reduced widths of each configuration: the cells' shapes, cut for the CPU,
# at a head size the CUDA kernels are built for (16), so that the card's
# test serves them too
REDUCED = {
    "bloom176b-l11": dict(hidden_size=96, n_head=6, n_layer=4,
                          vocab_size=256),
    "chameleon34b": dict(hidden_size=64, num_attention_heads=4,
                         num_key_value_heads=2, num_hidden_layers=4,
                         intermediate_size=96, vocab_size=256),
}
REDUCED_TRAFFIC = {
    "chat_backlog": dict(requests=200, open_after_rounds=4,
                         check_requests=6,
                         prompt_tokens=dict(min=8, max=24, dist="loguniform"),
                         new_tokens=dict(min=6, max=12, dist="uniform"),
                         max_seq_len=40),
    "long_prompt_bursts": dict(requests=200, open_after_rounds=0,
                               check_requests=6,
                               prompt_tokens=dict(min=16, max=56,
                                                  dist="loguniform"),
                               new_tokens=dict(min=4, max=8,
                                               dist="uniform"),
                               max_seq_len=64),
}
REDUCED_ROWS = 4


def reduced_config(name: str) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c.update(REDUCED[name])
    c["deployment"] = dict(c["deployment"], blocks=[2, 2, 1, 1, 1])
    return c


def reduced_traffic(name: str) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update(copy.deepcopy(REDUCED_TRAFFIC[name]))
    return t


def reduced_cell(cell: str, rows: int = REDUCED_ROWS) -> dict:
    """The cell's file with the reduced serve's pool rows."""
    cf = json.loads((BENCH / "cells" / f"{cell}.json").read_text())
    return dict(cf, rows=rows)
