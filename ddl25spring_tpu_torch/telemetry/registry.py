"""MetricsRegistry: the port's copy of the JAX package's
``telemetry/registry.py`` — counters, gauges and histograms with one
snapshot shape.

``telemetry.trace.Spans`` phase accumulators, ``telemetry.trace.StepTimer``
step times and ``metrics.ResilienceStats`` fault counters land here through
adapters (``absorb_*``), so one ``snapshot()`` carries everything a run
report needs; a trainer's ``run_end`` event is that snapshot. For the same
observations the snapshot equals the JAX registry's.

Thread-safe. Histograms keep raw observations (exact percentiles).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

DEFAULT_PERCENTILES = (50.0, 95.0, 99.0)


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy 'linear' method) without
    requiring numpy on the read path."""
    if not values:
        raise ValueError("percentile of empty sequence")
    return _percentile_sorted(sorted(values), q)


def _percentile_sorted(v: Sequence[float], q: float) -> float:
    """``percentile`` on ALREADY-SORTED values — callers computing several
    quantiles of one histogram sort once instead of once per quantile."""
    if len(v) == 1:
        return float(v[0])
    pos = (q / 100.0) * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    frac = pos - lo
    return float(v[lo] * (1.0 - frac) + v[hi] * frac)


class MetricsRegistry:
    """Counters (monotonic), gauges (last-write-wins), histograms
    (p50/p95/p99 + count/mean/max)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = defaultdict(list)

    # ------------------------------------------------------------ primitives
    def counter_inc(self, name: str, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r}: negative increment {value}")
        with self._lock:
            self._counters[name] += value

    def counter_set(self, name: str, value: float) -> None:
        """Set a counter to an externally tracked total (adapter use: the
        source — e.g. ResilienceStats — owns the accumulation)."""
        with self._lock:
            self._counters[name] = float(value)

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists[name].append(float(value))

    # ------------------------------------------------------------- accessors
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def percentiles(self, name: str,
                    qs: Sequence[float] = DEFAULT_PERCENTILES
                    ) -> Dict[str, float]:
        with self._lock:
            values = list(self._hists.get(name, ()))
        if not values:
            return {}
        values.sort()
        return {f"p{q:g}": _percentile_sorted(values, q) for q in qs}

    def snapshot(self) -> dict:
        """One JSON-able view of everything — the run_end event's payload.

        The lock covers only the copy-out; sorting/aggregating thousands of
        observations happens outside it so the training/watchdog threads'
        ``observe`` calls don't stall behind a snapshot."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            raw = {name: list(v) for name, v in self._hists.items() if v}
        hists = {}
        for name, v in raw.items():
            v.sort()
            hists[name] = {"count": len(v), "mean": sum(v) / len(v),
                           "max": v[-1],
                           **{f"p{q:g}": _percentile_sorted(v, q)
                              for q in DEFAULT_PERCENTILES}}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    # -------------------------------------------------------------- adapters
    def absorb_spans(self, spans, prefix: str = "phase/") -> None:
        """telemetry.trace.Spans → ``phase/<name>_s`` gauges (total seconds)
        and ``phase/<name>_count`` counters."""
        for name, total in spans.as_dict().items():
            self.gauge_set(f"{prefix}{name}_s", total)
            self.counter_set(f"{prefix}{name}_count", spans.count(name))

    def absorb_step_timer(self, timer, name: str = "step_time_s") -> None:
        """telemetry.trace.StepTimer → one histogram of its recorded steps."""
        for t in list(timer.times):
            self.observe(name, t)

    def absorb_resilience(self, stats, prefix: str = "faults/") -> None:
        """metrics.ResilienceStats → ``faults/<counter>`` counters. Iterates
        the stats object's own fields, so a newly added counter shows up
        here without a registry change (the merge-completeness contract
        tests/test_telemetry.py pins)."""
        for k, v in stats.as_dict().items():
            self.counter_set(f"{prefix}{k}", v)
