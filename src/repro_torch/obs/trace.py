"""Lightweight span tracing for the delivery path.

A :class:`Tracer` produces trees of timed :class:`Span`\\ s through one
entry point::

    with tracer.span("pull", lineage="app", tag="v3") as sp:
        with tracer.span("plan_pull"):      # nests under "pull"
            ...
        sp.annotate(chunks=42)

Parentage is implicit per thread (a thread-local stack), with an explicit
``parent=`` escape hatch for work fanned out to a pool: the submitting
thread captures its current span and each worker opens children under it —
the resulting tree crosses threads but stays one pull.

Completed **root** spans land in a bounded ring buffer (old pulls fall off,
memory stays flat); :meth:`Tracer.take` drains them for inspection or for
``tools/trace_dump.py``.  Spans serialize to plain dicts
(:meth:`Span.to_dict`) so a recorded trace survives a JSON round-trip.

Cost model: tracers are **disabled by default**.  A disabled tracer's
``span()`` returns one shared no-op context manager — no allocation, no
clock read, no lock — which is what keeps "tracing off" indistinguishable
from "tracing not wired in" (``tests/test_obs.py`` measures it).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_TRACER"]


class Span:
    """One timed operation; children are spans it (transitively) caused."""

    __slots__ = ("name", "attrs", "t0", "t1", "children")

    def __init__(self, name: str, attrs: Optional[Dict] = None):
        self.name = name
        self.attrs: Dict = attrs or {}
        self.t0 = 0.0
        self.t1 = 0.0
        self.children: List["Span"] = []

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def annotate(self, **attrs) -> None:
        """Attach attributes mid-span (chunk counts, byte totals, ...)."""
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {"name": self.name, "attrs": dict(self.attrs),
                "duration": self.duration,
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def from_dict(cls, obj: dict) -> "Span":
        sp = cls(obj["name"], dict(obj.get("attrs", {})))
        sp.t0, sp.t1 = 0.0, float(obj.get("duration", 0.0))
        sp.children = [cls.from_dict(c) for c in obj.get("children", ())]
        return sp

    def walk(self):
        """Yield ``(depth, span)`` depth-first."""
        stack = [(0, self)]
        while stack:
            depth, sp = stack.pop()
            yield depth, sp
            stack.extend((depth + 1, c) for c in reversed(sp.children))


class _NullSpanContext:
    """Shared do-nothing span + context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpanContext":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpanContext()


class _SpanContext:
    """Context manager for one live span: clocks it, maintains the thread's
    span stack, attaches to the parent (or the ring buffer for roots)."""

    __slots__ = ("_tracer", "_span", "_parent")

    def __init__(self, tracer: "Tracer", span: Span, parent: Optional[Span]):
        self._tracer = tracer
        self._span = span
        self._parent = parent

    def __enter__(self) -> Span:
        tracer = self._tracer
        stack = tracer._stack()
        if self._parent is None and stack:
            self._parent = stack[-1]
        stack.append(self._span)
        self._span.t0 = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self._span
        span.t1 = time.perf_counter()
        if exc_type is not None:
            span.attrs.setdefault("error", exc_type.__name__)
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] is span:
            stack.pop()
        if self._parent is not None:
            with tracer._lock:      # parents may collect from many threads
                self._parent.children.append(span)
        else:
            with tracer._lock:
                tracer._roots.append(span)
        return False


class Tracer:
    """Span factory + bounded recorder.  Disabled (free) until asked."""

    def __init__(self, enabled: bool = False, capacity: int = 256):
        self.enabled = enabled  # guarded-by: external(benign bool flip; readers only ever see on/off)
        self._lock = threading.Lock()
        self._roots: deque = deque(maxlen=max(1, capacity))  # guarded-by: _lock
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ------------------------------------------------------------- control

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._roots.clear()

    # -------------------------------------------------------------- spans

    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        """Open a span; use as ``with tracer.span("op") as sp``.

        ``parent=`` overrides the thread-local nesting — pass the submitting
        thread's span when the work runs on a pool thread.
        """
        if not self.enabled:
            return _NULL_SPAN
        return _SpanContext(self, Span(name, attrs), parent)

    def current(self) -> Optional[Span]:
        """This thread's innermost open span (None outside any span or when
        disabled) — capture it before handing work to another thread."""
        if not self.enabled:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    # ----------------------------------------------------------- recorder

    def roots(self) -> List[Span]:
        """Completed root spans currently held (oldest first), kept."""
        with self._lock:
            return list(self._roots)

    def take(self) -> List[Span]:
        """Drain and return the recorded root spans."""
        with self._lock:
            out = list(self._roots)
            self._roots.clear()
        return out


NULL_TRACER = Tracer(enabled=False)
