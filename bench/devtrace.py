"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over the
window, reduced to kernel intervals on the host clock.

A marker kernel (``torch.cuda._sleep``, CUDA's ``spin_kernel``) is launched
right after a synchronize at the window's open, so its device start ties
the device's clock to the host's; every kernel, copy and set of the window
is then an interval on the host clock.  Busy time is the union of those
intervals; the rest of the window is idle.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")() * 1000)


class DeviceTrace:
    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.prof = None
        self.t_mark: Optional[float] = None
        self.events: List[Tuple[str, float, float]] = []  # host seconds
        self.window: Tuple[float, float] = (0.0, 0.0)
        self._busy: Optional[List[Tuple[float, float]]] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = self.clock()
        torch.cuda._sleep(100)

    def stop(self, t_open: float, t_close: float) -> None:
        """End the trace and keep the device events of [t_open, t_close]."""
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        raw = []
        mark = None
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = ev.name()
            start = _ns(ev, "start")
            raw.append((name, start, start + _ns(ev, "duration")))
            if MARKER in name and (mark is None or start < mark):
                mark = start
        self.prof = None
        if mark is None:
            raise RuntimeError("the device trace holds no marker kernel: "
                               "the profiler recorded no device activity")
        off = self.t_mark - mark * 1e-9
        self.window = (t_open, t_close)
        self.events = sorted(
            (n, s * 1e-9 + off, e * 1e-9 + off) for n, s, e in raw
            if MARKER not in n and e * 1e-9 + off > t_open
            and s * 1e-9 + off < t_close)

    # -- reductions -------------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        if self._busy is not None:
            return self._busy
        lo, hi = self.window
        out: List[List[float]] = []
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        self._busy = [(s, e) for s, e in out]
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_s(self, names: Tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names``."""
        return sum(e - s for n, s, e in self.events
                   if any(k in n for k in names))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.events:
            key = name if len(name) <= 96 else name[:96]
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])
                ][:n]

    def idle_gaps(self, spans, n: int = 10) -> List[list]:
        """Idle device time in the window, summed by what the host was doing
        at each gap's middle: the engine call it fell in, or the scheduler
        between calls."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        spans = sorted(spans, key=lambda x: x[1])
        starts = [x[1] for x in spans]
        by: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            label = f"host in {spans[i][0]}" if i >= 0 and \
                mid < spans[i][2] else \
                "host in the scheduler, between engine calls"
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])
                ][:n]
