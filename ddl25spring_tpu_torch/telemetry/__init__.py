"""Telemetry: the port's counterpart of the JAX package's ``telemetry/``.

- ``events``: the schema-versioned append-only JSONL event stream (the
  reference's format and ``SCHEMA_VERSION``).
- ``registry``: ``MetricsRegistry`` (counters, gauges, histograms).
- ``trace``: spans over the stream, ``Spans``, ``StepTimer``,
  ``device_trace`` (``torch.profiler``), ``trace_trees`` / ``tree_check``.
- ``heartbeat``: the atomic liveness file.
- ``introspect``: tree paths, numerics summaries, ``CompileWatch`` (call
  signatures in eager mode), roofline peaks, the flight recorder.
- ``comm``: bytes of the data-parallel collectives as they run.
- ``costs``: the analytic FLOPs (no compiled program to cost).
- ``memory``: measured peaks, ``MemoryMeter``, ``preflight``.

``Telemetry`` bundles the per-run pieces (event log, heartbeat, registry,
flight recorder) behind the one handle the trainers, the FL servers and
the serving layer take. Read a recorded run with the JAX package's
``python -m experiments.obs_report <dir>``: the stream is the reference's.
"""

from __future__ import annotations

import os
from typing import Optional

from .comm import CommProfile, measure_comm, tree_bytes
from .costs import flops_crosscheck, hlo_cost
from .events import (EventLog, SCHEMA_VERSION, default_run_id, read_events,
                     validate_event)
from .heartbeat import Heartbeat, read_heartbeat
from .introspect import (CompileWatch, FlightRecorder, NumericsSummary,
                         bind_events, make_summarizer, platform_peaks,
                         watch)
from .memory import (MemoryMeter, allocator_census, compiled_memory,
                     host_rss_bytes, preflight, program_memory)
from .registry import MetricsRegistry
from .trace import (Span, SpanContext, Spans, Tracer, device_trace,
                    trace_trees, tree_check)

__all__ = [
    "CommProfile", "CompileWatch", "EventLog", "FlightRecorder",
    "Heartbeat", "MemoryMeter", "MetricsRegistry", "NumericsSummary",
    "SCHEMA_VERSION",
    "Span", "SpanContext", "Spans", "Telemetry", "Tracer",
    "allocator_census", "bind_events", "compiled_memory",
    "default_run_id", "device_trace", "flops_crosscheck", "hlo_cost",
    "host_rss_bytes", "make_summarizer", "measure_comm", "platform_peaks",
    "preflight", "program_memory", "read_events",
    "read_heartbeat", "trace_trees", "tree_bytes", "tree_check",
    "validate_event", "watch",
]

EVENTS_NAME = "events.jsonl"
HEARTBEAT_NAME = "heartbeat.json"


class Telemetry:
    """Per-run telemetry bundle: event log + heartbeat + metrics registry.

    >>> tel = Telemetry("/tmp/run")          # events.jsonl, heartbeat.json
    >>> train_llm_dp(..., telemetry=tel, device="cpu")
    >>> # python -m experiments.obs_report /tmp/run

    ``step_every`` is the step-event cadence (each step event reads the
    loss on the host); the heartbeat beats every iteration. ``flight=True``
    arms the flight recorder: a postmortem bundle under
    ``<out_dir>/postmortem/`` whenever a ``fault``, ``remesh`` or
    ``slo_violation`` event crosses the stream.

    A bundle pickles as its settings and its event counter, so a trainer
    that starts rank processes (``TrainConfig.data > 1``) hands it to rank
    0, which reopens the same files and goes on numbering the events; the
    registry and the flight recorder a rank fills are that rank's own."""

    def __init__(self, out_dir: str, *, run_id: Optional[str] = None,
                 step_every: int = 10, flight: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.run_id = run_id or default_run_id()
        # Floor at 1: the trainers take ``it % step_every``.
        self.step_every = max(1, int(step_every))
        self._flight_on = flight
        self.events = EventLog(os.path.join(out_dir, EVENTS_NAME),
                               run_id=self.run_id)
        self.heartbeat = Heartbeat(os.path.join(out_dir, HEARTBEAT_NAME))
        self.registry = MetricsRegistry()
        self.flight = None
        if flight:
            self.flight = FlightRecorder(os.path.join(out_dir, "postmortem"))
            self.events.observers.append(self.flight.observe)

    @property
    def events_path(self) -> str:
        return self.events.path

    @property
    def heartbeat_path(self) -> str:
        return self.heartbeat.path

    def __getstate__(self) -> dict:
        return {"out_dir": self.out_dir, "run_id": self.run_id,
                "step_every": self.step_every, "flight": self._flight_on,
                "seq": self.events._seq}

    def __setstate__(self, st: dict) -> None:
        self.__init__(st["out_dir"], run_id=st["run_id"],
                      step_every=st["step_every"], flight=st["flight"])
        self.events._seq = st["seq"]

    def close(self) -> None:
        self.events.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
