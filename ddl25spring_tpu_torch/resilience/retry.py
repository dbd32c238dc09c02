"""Retry with exponential backoff and deterministic jitter: the port's own
copy of the JAX package's ``resilience/retry.py``, applied where IO meets
a world that can kill it (``checkpoint.py``).

Delays follow ``base * 2**attempt``, capped at ``max_delay``, each scaled
by a jitter factor drawn uniformly from ``[1 - jitter, 1 + jitter]`` by a
numpy generator seeded ``seed``, so the same schedule comes back every
time (the same floats as the JAX package's for one seed). Sleeping is
injectable (``sleep=``) so tests check the schedule without waiting.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional, Tuple, Type

import numpy as np


def backoff_schedule(attempts: int, *, base: float = 0.1,
                     max_delay: float = 30.0, jitter: float = 0.25,
                     seed: int = 0) -> List[float]:
    """The delays ``retry_call`` sleeps between tries:
    ``min(base·2^i, max_delay) · U[1-jitter, 1+jitter]``, seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(attempts):
        delay = min(base * (2.0 ** i), max_delay)
        out.append(delay * float(rng.uniform(1.0 - jitter, 1.0 + jitter)))
    return out


def retry_call(fn: Callable, *args,
               attempts: int = 3,
               base: float = 0.1,
               max_delay: float = 30.0,
               jitter: float = 0.25,
               seed: int = 0,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying up to ``attempts`` tries in
    all on ``retry_on`` exceptions with the backoff above.
    ``on_retry(attempt_idx, exc)`` fires before each sleep (callers count
    retries into ``ResilienceStats`` there). The last failure re-raises
    unchanged; KeyboardInterrupt and SystemExit are never caught."""
    attempts = max(1, attempts)
    delays = backoff_schedule(attempts - 1, base=base, max_delay=max_delay,
                              jitter=jitter, seed=seed)
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if i == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(i, e)
            sleep(delays[i])
    raise AssertionError("unreachable")


def with_retry(attempts: int = 3, *, base: float = 0.1,
               max_delay: float = 30.0, jitter: float = 0.25, seed: int = 0,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep) -> Callable:
    """Decorator form of ``retry_call`` with the same semantics."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, attempts=attempts, base=base,
                              max_delay=max_delay, jitter=jitter, seed=seed,
                              retry_on=retry_on, on_retry=on_retry,
                              sleep=sleep, **kwargs)
        return wrapped
    return deco
