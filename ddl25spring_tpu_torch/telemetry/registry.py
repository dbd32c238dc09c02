"""Percentiles: the port's copy of the JAX package's
``telemetry/registry.py``, trimmed to ``percentile``."""

from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's 'linear' method)."""
    if not values:
        raise ValueError("percentile of empty sequence")
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    pos = (q / 100.0) * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    frac = pos - lo
    return float(v[lo] * (1.0 - frac) + v[hi] * frac)
