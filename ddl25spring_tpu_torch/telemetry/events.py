"""Append-only JSONL event stream: the port's copy of the JAX package's
``telemetry/events.py``, trimmed to what the serving layer emits
(``request_*`` lifecycle events, closed trace ``span``s, and the fleet's
``route``, ``deploy`` and ``speculate`` events).

The stream format is the reference's, at the same schema version, so the
JAX package's readers and validators read the port's streams unchanged:
one compact JSON object per line, written with ONE ``write()`` on an
``O_APPEND`` descriptor; every event carries ``schema``, ``run_id``,
``seq`` (per-writer monotonic), ``t`` (epoch seconds) and ``type``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Optional

SCHEMA_VERSION = 9


def default_run_id() -> str:
    return f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"


class EventLog:
    """Append-only JSONL event writer (thread-safe).

    >>> log = EventLog("/tmp/run/events.jsonl")
    >>> log.request_enqueue(req="req-0001", prompt_len=16)
    """

    def __init__(self, path: str, run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id or default_run_id()
        self._seq = 0
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self.write_errors = 0

    def emit(self, type: str, **fields: Any) -> Dict[str, Any]:
        """Append one event and return it. Never raises on an IO or
        serialization failure: telemetry must not sink the server, so a
        failed write is counted in ``write_errors`` instead."""
        with self._lock:
            self._seq += 1
            record = {"schema": SCHEMA_VERSION, "run_id": self.run_id,
                      "seq": self._seq, "t": time.time(), "type": type}
            record.update(fields)
            try:
                record = _sanitize(record)
                data = (json.dumps(record, separators=(",", ":"),
                                   allow_nan=False) + "\n").encode()
                if self._fd is None:
                    raise OSError("EventLog is closed")
                view = memoryview(data)
                while view:                 # os.write may write short
                    view = view[os.write(self._fd, view):]
            except (OSError, TypeError, ValueError, RecursionError):
                self.write_errors += 1
        return record

    # Serving request lifecycle (schema v2).
    def request_enqueue(self, *, req: str, **fields) -> Dict[str, Any]:
        return self.emit("request_enqueue", req=req, **fields)

    def request_prefill(self, *, req: str, slot: int,
                        **fields) -> Dict[str, Any]:
        return self.emit("request_prefill", req=req, slot=slot, **fields)

    def request_token(self, *, req: str, i: int, **fields) -> Dict[str, Any]:
        return self.emit("request_token", req=req, i=i, **fields)

    def request_done(self, *, req: str, tokens: int,
                     **fields) -> Dict[str, Any]:
        return self.emit("request_done", req=req, tokens=tokens, **fields)

    # One closed trace span (schema v4; telemetry/trace.py's Tracer emits).
    def span(self, *, name: str, trace_id: str, span_id: str,
             start_ns: int, dur_ns: int, parent_span_id: Optional[str] = None,
             **fields) -> Dict[str, Any]:
        if parent_span_id is not None:
            fields["parent_span_id"] = parent_span_id
        return self.emit("span", name=name, trace_id=trace_id,
                         span_id=span_id, start_ns=start_ns, dur_ns=dur_ns,
                         **fields)

    # Serving fleet (schema v6): one ``route`` per dispatch decision, one
    # ``deploy`` per engine weight swap.
    def route(self, *, req: str, engine: int, **fields) -> Dict[str, Any]:
        return self.emit("route", req=req, engine=engine, **fields)

    def deploy(self, *, version, **fields) -> Dict[str, Any]:
        return self.emit("deploy", version=version, **fields)

    # Speculative decoding (schema v7): one per verify dispatch.
    def speculate(self, *, proposed: int, accepted: int,
                  **fields) -> Dict[str, Any]:
        return self.emit("speculate", proposed=proposed, accepted=accepted,
                         **fields)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _sanitize(obj):
    """Strict-JSON form: numpy/torch scalars → Python, non-finite floats →
    their ``str()`` ("nan", "inf")."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    item = getattr(obj, "item", None)
    if callable(item):
        return _sanitize(item())
    return str(obj)
