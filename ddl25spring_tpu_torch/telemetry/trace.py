"""Trace spans over the event stream: the port's copy of the JAX package's
``telemetry/trace.py``, trimmed to ``SpanContext``/``Span``/``Tracer``.

Contexts are passed explicitly (never thread-locals). Each CLOSED span is
one ``span`` event with monotonic-ns start and duration from the tracer's
clock. Span ids are per-tracer counters behind a process-wide tracer
number, so equal runs produce equal streams.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .events import EventLog


class SpanContext:
    """The identity one span hands to its children."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id


class Span:
    """One open span; ``end()`` emits it (a second call is a no-op)."""

    __slots__ = ("_tracer", "ctx", "name", "start_ns", "attrs", "_ended")

    def __init__(self, tracer: "Tracer", ctx: SpanContext, name: str,
                 start_ns: int, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.ctx = ctx
        self.name = name
        self.start_ns = start_ns
        self.attrs = attrs
        self._ended = False

    def end(self, **attrs: Any) -> None:
        if self._ended:
            return
        self._ended = True
        self.attrs.update(attrs)
        self._tracer._finish(self)


class Tracer:
    """Span factory over an EventLog (``events=None`` emits nothing).
    ``clock_ns`` is a monotonic-nanosecond clock; the serving scheduler
    passes its own fast-forwarded clock."""

    _instances = 0
    _instances_lock = threading.Lock()

    def __init__(self, events: Optional[EventLog] = None, *,
                 clock_ns=time.monotonic_ns):
        self.events = events
        self.clock_ns = clock_ns
        self._lock = threading.Lock()
        self._n = 0
        with Tracer._instances_lock:
            Tracer._instances += 1
            self._id = Tracer._instances

    def _next_id(self) -> str:
        with self._lock:
            self._n += 1
            return f"s{self._id}.{self._n}"

    def start(self, name: str, *, parent: Optional[SpanContext] = None,
              trace: Optional[str] = None, **attrs: Any) -> Span:
        """Open a span. A root span names its ``trace``; a child inherits
        its parent's."""
        if parent is not None:
            ctx = SpanContext(parent.trace_id, self._next_id(),
                              parent.span_id)
        else:
            ctx = SpanContext(trace if trace is not None else "main",
                              self._next_id())
        return Span(self, ctx, name, int(self.clock_ns()), dict(attrs))

    def _finish(self, span: Span) -> None:
        dur_ns = max(0, int(self.clock_ns()) - span.start_ns)
        if self.events is not None:
            self.events.span(name=span.name, trace_id=span.ctx.trace_id,
                             span_id=span.ctx.span_id,
                             parent_span_id=span.ctx.parent_span_id,
                             start_ns=span.start_ns, dur_ns=dur_ns,
                             **span.attrs)
