"""Distributed tracing over the JSONL event stream: the port's copy of the
JAX package's ``telemetry/trace.py``.

- ``SpanContext``: (trace_id, span_id, parent_span_id), passed explicitly
  as arguments, never stashed in thread-locals.
- ``Tracer``: opens spans against an ``EventLog``; each CLOSED span is one
  ``span`` event (monotonic-ns start and duration from the tracer's
  clock). ``events=None`` emits nothing while still accumulating phase
  totals (``phases=Spans()``), so a run without telemetry keeps its phase
  accounting through the same code path.
- ``Spans`` (named wall-clock accumulators) and ``StepTimer`` (per-step
  timing that waits for the step's outputs on their CUDA device).
- ``device_trace``: a ``torch.profiler.profile`` of CPU and CUDA
  activity. While one is live, every ``Tracer`` span also enters a
  ``torch.profiler.record_function``, so host spans land on the CUDA
  timeline beside the kernels they launched; outside one the hook is a
  single flag check.
- ``trace_trees`` / ``tree_check``: reassembly of a recorded stream into
  per-trace span trees, with the orphan and imbalance checks.

Span ids are per-tracer counters behind a process-wide tracer number, so
equal runs produce equal streams.

>>> tracer = Tracer(telemetry.events)
>>> with tracer.span("request", trace="req-0007", prompt_len=16) as root:
...     with tracer.span("queue", parent=root.ctx):
...         wait_for_slot()
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence

from .events import EventLog


class SpanContext:
    """The identity one span hands to its children — what crosses function
    boundaries (explicitly; never a thread-local)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def as_dict(self) -> Dict[str, Optional[str]]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpanContext":
        return cls(d["trace_id"], d["span_id"], d.get("parent_span_id"))

    def __repr__(self) -> str:
        return (f"SpanContext({self.trace_id!r}, {self.span_id!r}, "
                f"parent={self.parent_span_id!r})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, SpanContext)
                and self.as_dict() == other.as_dict())


class Span:
    """One open span. ``end()`` emits the event (idempotent: the second
    call is a no-op, so a manual-lifecycle caller crossing error paths
    can't double-emit). Usable manually (serving holds request spans open
    across many scheduler ticks) or via ``Tracer.span``'s context
    manager."""

    __slots__ = ("_tracer", "ctx", "name", "start_ns", "attrs", "_phase",
                 "_annotation", "_ended")

    def __init__(self, tracer: "Tracer", ctx: SpanContext, name: str,
                 start_ns: int, attrs: Dict[str, Any], phase: Optional[str],
                 annotation):
        self._tracer = tracer
        self.ctx = ctx
        self.name = name
        self.start_ns = start_ns
        self.attrs = attrs
        self._phase = phase
        self._annotation = annotation
        self._ended = False

    def end(self, **attrs: Any) -> None:
        if self._ended:
            return
        self._ended = True
        if self._annotation is not None:
            with contextlib.suppress(Exception):
                self._annotation.__exit__(None, None, None)
        self.attrs.update(attrs)
        self._tracer._finish(self)


class Tracer:
    """Span factory over an EventLog (or over nothing — ``events=None``
    keeps the phase accounting and skips emission).

    - ``clock_ns``: monotonic-nanosecond clock. Defaults to
      ``time.monotonic_ns``; the serving scheduler passes its own
      (fast-forwarded) clock so spans line up with queue-wait/TTFT
      semantics, and tests pass a fake for deterministic streams.
    - ``phases``: an optional ``Spans`` accumulator every completed span
      feeds (under ``phase`` when given, else the span name) — the
      adapter that keeps ``registry.absorb_spans`` working.
    - Span ids are ``s<tracer>.<n>`` from a per-tracer counter behind a
      process-wide tracer discriminator: deterministic streams (equal runs
      construct tracers in equal order), and unique within a (run_id,
      trace) even when SEVERAL tracers emit on one trace — the training
      loop and the elastic controller both write the "train" trace, and a
      collision would make ``trace_trees`` silently overwrite spans.
    """

    _instances = 0
    _instances_lock = threading.Lock()

    def __init__(self, events: Optional[EventLog] = None, *,
                 clock_ns=time.monotonic_ns,
                 phases: Optional["Spans"] = None, prefix: str = ""):
        self.events = events
        self.clock_ns = clock_ns
        self.phases = phases
        # Prepended to every span id: writers of one stream in several
        # processes (the elastic trainer's successive rank 0s) keep their
        # ids apart with a prefix of their own.
        self.prefix = prefix
        self._lock = threading.Lock()
        self._n = 0
        with Tracer._instances_lock:
            Tracer._instances += 1
            self._id = Tracer._instances

    def _next_id(self) -> str:
        with self._lock:
            self._n += 1
            return f"{self.prefix}s{self._id}.{self._n}"

    def start(self, name: str, *, parent: Optional[SpanContext] = None,
              trace: Optional[str] = None, phase=None,
              **attrs: Any) -> Span:
        """Open a span. A root span names its ``trace`` (e.g. the request
        id); a child inherits the parent's. ``phase`` overrides the name
        the ``phases`` accumulator files the duration under; ``False``
        skips accumulation (an umbrella span whose children already cover
        its wall time must not double-count the phase totals)."""
        if parent is not None:
            ctx = SpanContext(parent.trace_id, self._next_id(),
                              parent.span_id)
        else:
            ctx = SpanContext(trace if trace is not None else "main",
                              self._next_id())
        annotation = None
        if _profiling():
            # Host span → the profiler's timeline, only while a device
            # trace is live: outside one this is a single flag check.
            with contextlib.suppress(Exception):
                import torch
                annotation = torch.profiler.record_function(name)
                annotation.__enter__()
        return Span(self, ctx, name, int(self.clock_ns()), dict(attrs),
                    phase, annotation)

    @contextlib.contextmanager
    def span(self, name: str, *, parent: Optional[SpanContext] = None,
             trace: Optional[str] = None, phase=None,
             **attrs: Any) -> Iterator[Span]:
        s = self.start(name, parent=parent, trace=trace, phase=phase,
                       **attrs)
        try:
            yield s
        except BaseException:
            s.end(error=True)
            raise
        s.end()

    def _finish(self, span: Span) -> None:
        dur_ns = max(0, int(self.clock_ns()) - span.start_ns)
        if self.phases is not None and span._phase is not False:
            self.phases.add(span._phase or span.name, dur_ns / 1e9)
        if self.events is not None:
            self.events.span(name=span.name, trace_id=span.ctx.trace_id,
                             span_id=span.ctx.span_id,
                             parent_span_id=span.ctx.parent_span_id,
                             start_ns=span.start_ns, dur_ns=dur_ns,
                             **span.attrs)


# --------------------------------------------------------- wall-clock phases

class Spans:
    """Named wall-clock accumulators — the phase-accounting half of the
    tracing path (absorbed by ``MetricsRegistry.absorb_spans``; fed by
    ``Tracer(phases=...)`` or used standalone).

    Thread-safe: a watchdog/monitoring thread and the training thread may
    accumulate into one instance concurrently (the lock covers the
    read-modify-write of the accumulators, not the timed block itself).

    >>> spans = Spans()
    >>> with spans("update"):
    ...     do_work()
    >>> spans.total("update")
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] += seconds
            self._count[name] += 1

    def total(self, name: str) -> float:
        with self._lock:
            return self._acc[name]

    def count(self, name: str) -> int:
        with self._lock:
            return self._count[name]

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._acc)

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._count.clear()


def _wait_for(outputs) -> None:
    """Wait until every CUDA device holding a tensor of ``outputs`` (any
    nesting of dicts, lists and tuples) has finished its queued work."""
    import torch

    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(outputs)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Per-step timing that is honest under asynchronous launches: ``tick``
    waits for the step's outputs on their CUDA device before reading the
    clock.

    ``tick()`` before ``start()`` raises instead of silently recording a
    0.0 step (the old behavior poisoned means with zeros — percentile
    consumers in telemetry.MetricsRegistry would inherit the lie).
    Thread-safe for the same reason as Spans."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            self._t0 = time.perf_counter()

    def tick(self, *outputs) -> float:
        if outputs:
            _wait_for(outputs)
        now = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                raise RuntimeError(
                    "StepTimer.tick() before start(): the interval has no "
                    "beginning — call start() once before the timed loop")
            dt = now - self._t0
            self.times.append(dt)
            self._t0 = now
        return dt

    @property
    def mean(self) -> float:
        with self._lock:
            return sum(self.times) / max(len(self.times), 1)


# ------------------------------------------------------------- device traces

# Set while a device trace is live (device_trace below): Tracer.start checks
# it before paying for a record_function, so tracing stays free otherwise.
_DEVICE_TRACE_DEPTH = 0


def _profiling() -> bool:
    return _DEVICE_TRACE_DEPTH > 0


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[Any]:
    """A ``torch.profiler.profile`` of CPU and (when present) CUDA activity,
    written as a Chrome/Perfetto trace to ``<log_dir>/trace.json`` at exit;
    yields the profile (``key_averages()`` for a table). While it is live,
    every ``Tracer`` span also enters a ``torch.profiler.record_function``,
    so the host spans (chunk staging, checkpoint writes, queue waits)
    appear on the device timeline."""
    global _DEVICE_TRACE_DEPTH
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _DEVICE_TRACE_DEPTH += 1
        try:
            yield prof
        finally:
            _DEVICE_TRACE_DEPTH -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ------------------------------------------------------------ tree reassembly

def trace_trees(events: Sequence[Dict[str, Any]]
                ) -> Dict[str, Dict[str, Any]]:
    """Reassemble span events into per-trace trees.

    Returns ``{trace_id: {"spans": {span_id: event}, "roots": [event],
    "children": {span_id: [event]}, "orphans": [event]}}`` — an orphan is
    a span whose ``parent_span_id`` names a span the stream never closed
    (a crashed writer, or a propagation bug). Non-span events are ignored,
    so callers can feed a whole stream. Span ids are only unique within a
    (run_id, trace) — relaunches sharing one file re-use both the trace
    name ("train") and the id sequence — so trees are partitioned per
    run_id first, and when several runs used one trace name the extra
    runs' trees are keyed ``"run_id/trace_id"`` rather than silently
    overwriting the first run's spans."""
    by_run: Dict[tuple, Dict[str, Any]] = {}
    for e in events:
        if e.get("type") != "span":
            continue
        key = (e.get("run_id", "?"), e.get("trace_id", "?"))
        t = by_run.setdefault(key, {"spans": {}, "roots": [],
                                    "children": {}, "orphans": []})
        t["spans"][e.get("span_id")] = e
    out: Dict[str, Dict[str, Any]] = {}
    for (run, trace), t in by_run.items():
        out[trace if trace not in out else f"{run}/{trace}"] = t
    for t in out.values():
        for e in t["spans"].values():
            parent = e.get("parent_span_id")
            if parent is None:
                t["roots"].append(e)
            elif parent in t["spans"]:
                t["children"].setdefault(parent, []).append(e)
            else:
                t["orphans"].append(e)
        for kids in t["children"].values():
            kids.sort(key=lambda e: e.get("start_ns", 0))
        t["roots"].sort(key=lambda e: e.get("start_ns", 0))
    return out


def tree_check(tree: Dict[str, Any]) -> Dict[str, int]:
    """Self-check one ``trace_trees`` entry: ``roots`` (a complete request/
    round tree has exactly one), ``orphans`` (must be zero), ``imbalanced``
    (spans whose children's summed duration exceeds their own by >1% —
    an accounting bug: children are wall-clock subintervals of the
    parent)."""
    imbalanced = 0
    for pid, kids in tree["children"].items():
        parent = tree["spans"][pid]
        if (sum(k.get("dur_ns", 0) for k in kids)
                > parent.get("dur_ns", 0) * 1.01 + 1000):
            imbalanced += 1
    return {"roots": len(tree["roots"]), "orphans": len(tree["orphans"]),
            "imbalanced": imbalanced}
