"""Serving: continuous batching over a paged KV cache.

- ``kvcache``   — the device block pool and the host block allocator;
- ``engine``    — ``prefill_chunk`` / ``decode_step`` over a fixed slot
                  axis, with chunked prefill interleaved with decode;
- ``scheduler`` — iteration-level admission and retirement
                  (reservation-based, FCFS or SJF, EOS retirement) with
                  ``request_*`` events and per-request traces;
- ``frontend``  — the seeded Poisson workload generator, ``run_serving``
                  and the latency aggregation.
"""

from .engine import Engine, TokenEvent  # noqa: F401
from .frontend import (ServingReport, aggregate_latency,  # noqa: F401
                       reference_stream, run_serving, synthetic_workload)
from .kvcache import (TRASH_BLOCK, BlockAllocator,  # noqa: F401
                      PagedKVConfig, blocks_for, init_pool,
                      kv_bytes_per_token, naive_cache_bytes, pool_bytes)
from .scheduler import Request, RequestRecord, Scheduler  # noqa: F401
