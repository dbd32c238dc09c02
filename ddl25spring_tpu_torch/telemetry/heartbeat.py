"""Heartbeat file: the port's copy of the JAX package's
``telemetry/heartbeat.py``, a direct liveness signal for a watchdog.

A training loop overwrites ONE small JSON file every step with a monotonic
sequence number; a watcher treats "seq advanced" as proof of life.

Contract:
- Atomic replace (temp file + ``os.replace`` in the same directory), so a
  reader never sees a partial file.
- Fields: ``schema``, ``pid``, ``step`` (the trainer's stream position),
  ``seq`` (per-writer monotonic counter: the liveness signal), ``time``
  (epoch), ``monotonic`` (the writer's ``time.monotonic``).
- ``beat()`` never raises: a full disk must not kill a healthy run.
  Failures are counted on the writer (``write_errors``).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

HEARTBEAT_SCHEMA = 1


class Heartbeat:
    """Atomic heartbeat writer. One instance per training process."""

    def __init__(self, path: str):
        self.path = path
        self._seq = 0
        self._lock = threading.Lock()
        self.write_errors = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def beat(self, step: int = 0, **extra) -> bool:
        """Write one heartbeat; returns False (and counts) on IO failure."""
        with self._lock:
            self._seq += 1
            payload = {"schema": HEARTBEAT_SCHEMA, "pid": os.getpid(),
                       "step": int(step), "seq": self._seq,
                       "time": time.time(), "monotonic": time.monotonic()}
            payload.update(extra)
            try:
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(self.path) or ".", suffix=".hb.tmp")
                try:
                    with os.fdopen(fd, "w") as f:
                        json.dump(payload, f)
                    os.replace(tmp, self.path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise
            except Exception:
                self.write_errors += 1
                return False
            return True

    @property
    def seq(self) -> int:
        return self._seq


def read_heartbeat(path: str) -> Optional[dict]:
    """Parse a heartbeat file; None when missing/unreadable/not-yet-atomic.

    Readers poll this from a different process (the watchdog), so every
    failure mode — missing file, torn write from a non-atomic writer,
    wrong schema — degrades to 'no signal', never an exception.
    """
    try:
        with open(path) as f:
            payload = json.load(f)
    except Exception:
        return None
    if not isinstance(payload, dict) or "seq" not in payload:
        return None
    return payload
