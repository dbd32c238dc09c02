"""Cooperative preemption handling: the port's copy of the JAX package's
``resilience/preemption.py`` (SIGTERM → force-save → clean exit).

``PreemptionHandler`` turns the signal into a flag the training loop polls
at step boundaries; the loop then force-saves a resumable checkpoint and
returns instead of dying mid-write. The handler chains to the previously
installed handler on exit, and is a passive flag off the main thread
(Python delivers signals to the main thread only, and installing a handler
elsewhere raises): a rank process of ``parallel.distributed.run_ranks``
runs its trainer on its own main thread, so each rank installs its own.

Usage (what ``train/llm.py``'s ``_run_loop`` does)::

    with PreemptionHandler() as pre:
        for it in ...:
            if pre.requested:
                ckpt.save(it, state, overwrite=True)
                break
            state, loss = step(state, batch)
"""

from __future__ import annotations

import signal
import threading
from typing import List


class PreemptionHandler:
    """Installs handlers for ``signals`` (default: SIGTERM) that set a flag.

    Re-entrant as a context manager (install/restore is exact), readable via
    ``.requested``. A second signal while the flag is already set falls
    through to the previous handler — so a stuck force-save can still be
    killed by a second TERM.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev: List = []
        self._event = threading.Event()
        self._depth = 0

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _handle(self, signum, frame):
        if self._event.is_set():
            prev = dict(zip(self._signals, self._prev)).get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self._event.set()

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            return self  # signals never arrive here; stay a passive flag
        self._depth += 1
        if self._depth == 1:  # nested re-entry keeps the outer install
            self._prev = [signal.signal(s, self._handle)
                          for s in self._signals]
        return self

    def __exit__(self, *exc) -> None:
        if threading.current_thread() is not threading.main_thread():
            return  # the matching __enter__ installed nothing
        if self._depth > 0:
            self._depth -= 1
            if self._depth == 0:
                for s, prev in zip(self._signals, self._prev):
                    signal.signal(s, prev)
