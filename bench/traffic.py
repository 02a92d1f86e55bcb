"""The one traffic generator: a seeded trace on the engine's virtual clock
from a traffic file's parameters (``bench/traffic/<mix>.json``).

Requests arrive in bursts: a burst's size is drawn from ``arrivals.burst``
and bursts are ``arrivals.gap_s`` virtual seconds apart; a mix without
``burst`` is a backlog, every request due at time 0.  Prompt lengths, output lengths
and burst sizes are quantiles of the file's distributions on a fixed grid,
in one order drawn from ``ORDER_SEED``; ``--seed`` draws the token ids (and
the weights).  So every seed serves the same schedule of the same work: the
scheduler's rounds and the routes WS-RR picks follow from the lengths and
arrivals alone, never from token ids.

``residual_fill`` (backlog mixes): the first ``rows`` requests, the ones
that fill the pools at time 0, take their outputs from the equilibrium
residual of ``new_tokens`` (the tokens a session still owes on a server
that has been running), so retirements, and the admissions that refill
their rows, run at their steady rate from the first rounds instead of in
one wave.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
ORDER_SEED = 0  # the one order of the lengths and bursts


@dataclass
class Request:
    rid: int
    arrival: float  # virtual seconds
    prompt: np.ndarray  # int64 token ids in [2, vocab)
    n_new: int


def load(name: str) -> Dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """n values on the grid u = (i + 1/2) / n of the spec's distribution:
    ``uniform`` (over the integers min..max) or ``loguniform`` over
    [min, max], as ints."""
    u = grid(n)
    lo, hi = float(spec["min"]), float(spec["max"])
    if spec.get("dist", "uniform") == "loguniform":
        x = np.rint(lo * (hi / lo) ** u)
    else:
        x = np.floor(lo + (hi - lo + 1) * u)
    return np.clip(x, lo, hi).astype(np.int64)


def residual_quantiles(spec: Dict, n: int) -> np.ndarray:
    """n values on the grid of the equilibrium residual of a uniform
    integer length L on [min, max]: P(R = r) is proportional to
    P(L >= r), r = 1 .. max."""
    lo, hi = int(spec["min"]), int(spec["max"])
    assert spec.get("dist", "uniform") == "uniform", spec
    r = np.arange(1, hi + 1)
    surv = np.clip((hi - r + 1) / (hi - lo + 1), 0.0, 1.0)
    cdf = np.cumsum(surv) / surv.sum()
    return r[np.searchsorted(cdf, grid(n))].astype(np.int64)


def bursts(t: Dict, n: int, rows: int) -> List[int]:
    """Burst sizes covering n requests: quantiles of ``arrivals.burst``
    (a bound given as ``"rows"`` is the cell's pool rows) in the fixed
    order, repeated as needed, the last one cut to what is left; one
    burst of all n without ``burst``."""
    if "burst" not in t["arrivals"]:
        return [n]
    spec = {k: rows if v == "rows" else v
            for k, v in t["arrivals"]["burst"].items()}
    k = max(1, -(-2 * n // (int(spec["min"]) + int(spec["max"]))))
    sizes = np.random.default_rng(ORDER_SEED + 1).permutation(
        quantiles(spec, k))
    out, left = [], n
    while left > 0:
        for s in sizes:
            if left <= 0:
                break
            out.append(int(min(s, left)))
            left -= out[-1]
    return out


def generate(t: Dict, seed: int, vocab: int, rows: int) -> List[Request]:
    """The trace: the same lengths and arrivals for every seed, token ids
    in [2, vocab) from ``seed``."""
    n = int(t["requests"])
    order = np.random.default_rng(ORDER_SEED)
    prompts = order.permutation(quantiles(t["prompt_tokens"], n))
    news = order.permutation(quantiles(t["new_tokens"], n))
    if t.get("residual_fill"):
        news[:rows] = order.permutation(
            residual_quantiles(t["new_tokens"], rows))
    sizes = bursts(t, n, rows)
    arrivals = np.repeat(np.arange(len(sizes)) * float(
        t["arrivals"].get("gap_s", 0.0)), sizes)
    rng = np.random.default_rng(int(seed))
    return [Request(i, float(arrivals[i]),
                    rng.integers(2, vocab, int(prompts[i]), dtype=np.int64),
                    int(news[i])) for i in range(n)]


def buckets_used(t: Dict, buckets) -> List[int]:
    """The prefill buckets the trace's prompt lengths fall into."""
    lens = quantiles(t["prompt_tokens"], int(t["requests"]))
    out = set()
    for n in lens:
        b = next((b for b in sorted(buckets) if b >= n), None)
        if b is None:
            raise ValueError(f"prompt {n} is past every bucket {buckets}")
        out.add(int(b))
    return sorted(out)
