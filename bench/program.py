"""The program's own spans and work counts (``repro_torch.serving.trace``)
read against the device trace, for the traced run's readers.

The program stamps its spans with ``time.perf_counter``, the clock
``devtrace.DeviceTrace`` maps the device's intervals onto, so the two lie on
one timeline.  Each idle instant of the window (the window less the union
of the device intervals) is credited to the innermost program span open at
that instant: a gap is split exactly at span edges, and idle time outside
every span is credited to none.

The readers take the tracer from ``w.program``: a traced run puts one on
the system at the window's open with ``install`` and takes it off after the
window with ``remove``.  ``run.py`` does not do so yet, and no entry of
``BENCHMARK.json`` names these readers (PERF.md §7 lists the lines that
would).  Where a window has no ``program``, every reading here is None.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.trace import NULL, Tracer

ROUND_SPANS = ("decode_round", "prefill_round", "admit")


def install(system) -> Tracer:
    """Put a fresh ``Tracer`` on ``system`` and return it."""
    system.tracer = Tracer()
    return system.tracer


def remove(system) -> None:
    """Put the program's no-op tracer back (after the window)."""
    system.tracer = NULL


def idle_intervals(device) -> List[Tuple[float, float]]:
    """The window less the union of the device intervals, in time order."""
    lo, hi = device.window
    out, t = [], lo
    for s, e in device.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans) -> List[tuple]:
    """The timeline cut at every edge of the (closed, nested) spans:
    [(start, end, innermost span open there)] in time order; stretches
    outside every span are left out."""
    segs = []
    stack: list = []
    t = None
    for s in sorted((s for s in spans if s.end is not None),
                    key=lambda s: (s.start, s.depth)):
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            segs.append((t, top.end, top))
            t = top.end
        if stack:
            segs.append((t, s.start, stack[-1]))
        stack.append(s)
        t = s.start
    while stack:
        top = stack.pop()
        segs.append((t, top.end, top))
        t = top.end
    return [x for x in segs if x[1] > x[0]]


def idle_by_span(device, spans) -> List[tuple]:
    """[(span, idle seconds)]: each idle instant of the window credited to
    the innermost span open at it; spans that hold no idle time are left
    out."""
    idle, segs = idle_intervals(device), innermost(spans)
    by: Dict[int, list] = {}
    i = j = 0
    while i < len(idle) and j < len(segs):
        a, b = max(idle[i][0], segs[j][0]), min(idle[i][1], segs[j][1])
        if b > a:
            by.setdefault(id(segs[j][2]), [segs[j][2], 0.0])[1] += b - a
        if idle[i][1] < segs[j][1]:
            i += 1
        else:
            j += 1
    return [tuple(x) for x in by.values()]


def _chain(span) -> List[str]:
    """The names from ``span`` up to its root."""
    names = []
    while span is not None:
        names.append(span.name)
        span = span.parent
    return names


def _tracer(w):
    return getattr(w, "program", None)


def _ready(w) -> bool:
    return w.device is not None and _tracer(w) is not None


def idle_share_in(w, where: str) -> Optional[float]:
    """Device-idle seconds of the window over its length, in %: inside a
    ``step`` span (``where="step"``), or inside a round or admission span
    but outside every ``step`` (``where="glue"``)."""
    if not _ready(w):
        return None
    t = 0.0
    for span, sec in idle_by_span(w.device, _tracer(w).spans):
        names = _chain(span)
        in_step = "step" in names
        if (where == "step" and in_step) or (
                where == "glue" and not in_step
                and names[-1] in ROUND_SPANS):
            t += sec
    return 100.0 * t / w.device.window_s()


def _rounds(w, names) -> list:
    """The program's root spans named in ``names`` that ended inside the
    window."""
    return [s for s in _tracer(w).spans if s.parent is None
            and s.name in names and s.end is not None and w.inside(s.end)]


def live_work(w) -> Optional[float]:
    """Sum of ``work_live`` over sum of ``work_run`` of the ``hop`` spans of
    the rounds that ended inside the window, in %."""
    if _tracer(w) is None:
        return None
    rounds = {id(s) for s in _rounds(w, ("decode_round", "prefill_round"))}
    live = run = 0
    for s in _tracer(w).spans:
        if s.name != "hop":
            continue
        root = s
        while root.parent is not None:
            root = root.parent
        if id(root) in rounds:
            live += s.attrs.get("work_live", 0)
            run += s.attrs.get("work_run", 0)
    return 100.0 * live / run if run else None


def kernels_per_round(w) -> Optional[float]:
    """Device operations (kernels, copies, sets) whose start lies inside a
    program ``decode_round`` span that ended inside the window, over those
    rounds."""
    if not _ready(w):
        return None
    rounds = _rounds(w, ("decode_round",))
    if not rounds:
        return None
    starts = sorted(s for _, s, _ in w.device.events)
    n = sum(bisect.bisect_left(starts, r.end)
            - bisect.bisect_left(starts, r.start) for r in rounds)
    return n / len(rounds)


def idle_summary(w) -> Optional[str]:
    """One line for the log: the window's idle seconds by innermost span
    name, and outside every program span."""
    if not _ready(w):
        return None
    by: Dict[str, float] = {}
    for span, sec in idle_by_span(w.device, _tracer(w).spans):
        by[span.name] = by.get(span.name, 0.0) + sec
    total = sum(e - s for s, e in idle_intervals(w.device))
    parts = [f"{k} {v:.4f}" for k, v in
             sorted(by.items(), key=lambda x: -x[1])]
    parts.append(f"outside program spans {total - sum(by.values()):.4f}")
    return ", ".join(parts)
