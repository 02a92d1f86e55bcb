"""Arithmetic the metric readers share.  Each metric is a file of its own
under ``bench/metrics/`` whose ``read(w)`` takes the run's ``harness.Window``
and returns a number, or None where the run holds nothing to read (the
harness then leaves the metric out of the result).  Every reading is over
the whole window: the rounds that ended inside it."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import costs

K1_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
K2_KERNELS = ("flash_tc_kernel", "flash_attention_kernel")


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics), or None
    without samples."""
    return float(np.percentile(np.asarray(values, float), q)) \
        if values else None


def decode_tokens(w) -> int:
    """Tokens the decode rounds that ended inside the window produced."""
    return sum(n for _, _, _, n in w.round_spans("decode_round"))


def token_gaps(w) -> List[float]:
    """Wall gaps between consecutive tokens of one session, for the gaps
    that end inside the window."""
    return [b - a for s in w.sessions.values()
            for a, b in zip(s.times, s.times[1:]) if w.inside(b)]


def ttfts(w) -> List[float]:
    """For each session whose first token came inside the window: from the
    moment the scheduler took up its arrival to that token."""
    return [s.times[0] - s.taken_up for s in w.sessions.values()
            if s.times and w.inside(s.times[0])]


def prefill_rate(w) -> Optional[float]:
    """Live prompt tokens (padding excluded) of every prefill chunk whose
    round ended inside the window, over the wall from the window's start
    to the end of the last such round."""
    rs = w.round_spans("prefill_round")
    if not rs:
        return None
    return sum(n for _, _, _, n in rs) / (rs[-1][2] - w.t_open)


def rows_busy(w) -> Optional[float]:
    """Sessions decoded in each decode round of the window over the round's
    rows, averaged over the rounds, in %."""
    rs = w.round_spans("decode_round")
    return 100.0 * sum(n for _, _, _, n in rs) / (len(rs) * w.rows) \
        if rs else None


def engine_share(w) -> float:
    """The share of the window's wall inside the engine calls stamped
    (``try_admit_sessions``, ``prefill_round``, ``decode_round``)."""
    t = 0.0
    for _, t0, t1, _ in w.spans:
        t += max(0.0, min(t1, w.t_close) - max(t0, w.t_open))
    return t / w.wall


def round_ms(w, kind: str) -> Optional[float]:
    """Wall of the ``kind`` rounds that ended inside the window, over their
    count, in ms."""
    rs = w.round_spans(kind)
    return 1e3 * sum(t1 - t0 for _, t0, t1, _ in rs) / len(rs) \
        if rs else None


def useful_flops(w) -> float:
    """The model work of the window's rounds, counted from the
    configuration's shapes: each live prompt token of a prefill chunk and
    each decoded token once through every layer of the (cut) model, with
    attention over its causal prefix, and the LM head once for each token
    generated.  Padded rows and positions, idle rows and masked hosted
    layers are not useful work."""
    d = w.dims
    total = 0
    for t1, chunks in w.chunks:
        if w.inside(t1):
            total += sum(costs.chunk_flops(d, off, span, done)
                         for _, off, span, done in chunks)
    for s in w.sessions.values():
        p = len(s.prompt)
        for k, ts in enumerate(s.times[1:], start=1):
            if w.inside(ts):
                total += costs.token_flops(d, p + k - 1) + costs.head_flops(d)
    return float(total)


def mfu(w) -> Optional[float]:
    """Useful flops over the window's wall at the bf16 peak, in %."""
    f = useful_flops(w)
    return 100.0 * f / (w.wall * costs.PEAK_FLOPS_BF16) if f else None


def roofline(w, calls, kernels) -> Optional[float]:
    """Sum of each call's bound over the device time of its kernels, in %."""
    if w.device is None or not calls:
        return None
    t = w.device.kernel_s(kernels)
    if t <= 0:
        return None
    return 100.0 * sum(costs.bound_s(f, b) for f, b in calls) / t


def idle_share(w) -> Optional[float]:
    if w.device is None:
        return None
    return 100.0 * (1.0 - w.device.busy_s() / w.device.window_s())
