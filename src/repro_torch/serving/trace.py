"""Spans and work counts of the serving engine, kept in memory.

``GeoServingSystem.tracer`` is :data:`NULL` unless a caller installs a
:class:`Tracer`.  The engine opens a span at each part of its rounds (see
``GeoServingSystem.decode_round`` and ``prefill_round``) and counts the
work its pooled steps run and the part of it that is live.  The tracer
reads only its clock: it syncs nothing and reads nothing back from the
device, on or off.  Off, a site costs an attribute lookup and a call that
returns one shared object: no clock read and no allocation.

The default clock is ``time.perf_counter``, the host clock that a device
trace can be tied to (a marker kernel launched after a synchronize), so
program spans and device intervals lie on one timeline.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class Span:
    """One timed part of the program: ``name``, ``start`` / ``end`` on the
    tracer's clock, the enclosing span (``parent``, None at the root), its
    nesting ``depth`` and ``attrs`` (the counts made while it was the
    innermost open span).  Entering it opens it on its tracer."""

    __slots__ = ("name", "start", "end", "parent", "depth", "attrs",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name
        self.start = self.end = None
        self.parent: Optional[Span] = None
        self.depth = 0
        self.attrs: Dict[str, object] = {}

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr._stack:
            self.parent = tr._stack[-1]
            self.depth = self.parent.depth + 1
        tr._stack.append(self)
        tr.spans.append(self)
        self.start = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        self.end = tr.clock()
        tr._stack.pop()
        return False


class Tracer:
    """Records spans, in the order they open, and counts on them."""

    on = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.spans: List[Span] = []
        self._stack: List[Span] = []

    def span(self, name: str) -> Span:
        """A span to open with ``with``."""
        return Span(self, name)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the innermost open span's count ``name``."""
        attrs = self._stack[-1].attrs
        attrs[name] = attrs.get(name, 0) + n


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The tracer that records nothing: every ``span`` is one shared no-op
    context manager.  It has no ``count``: sites count under
    ``if tracer.on``, so a count's arithmetic runs only when tracing."""

    on = False

    def span(self, name: str) -> _NullSpan:
        return _NULL_SPAN


NULL = NullTracer()
