"""Serving: continuous batching over a paged KV cache.

- ``kvcache``   — the device block pool and the host block allocator
                  (reference counts for copy-on-write sharing, the
                  free-list fragmentation census);
- ``engine``    — ``prefill_chunk`` / ``decode_step`` over a fixed slot
                  axis, with chunked prefill interleaved with decode, a
                  token-boundary weight hot-swap, copy-on-write prefix
                  sharing (``prefix_share``) and bucketed gather narrowing
                  (``gather_buckets``);
- ``speculate`` — draft-propose / one-dispatch-verify speculative decoding
                  (``SpecConfig``, ``DraftEngine``, ``make_verify_step``,
                  ``rejection_accept``);
- ``scheduler`` — iteration-level admission and retirement
                  (reservation-based, FCFS or SJF, priorities, EOS
                  retirement) with ``request_*``, ``speculate`` and
                  ``deploy`` events and per-request traces, per-engine
                  tagged;
- ``frontend``  — the seeded Poisson workload generator, its multi-tenant
                  form (``TrafficClass``), ``run_serving`` and the latency
                  aggregation;
- ``fleet``     — N engines behind an SLO-aware ``Router`` with a
                  staggered weight rollout (``ServingFleet``,
                  ``run_serving_fleet``);
- ``deploy``    — the train→deploy conveyor over checkpoints
                  (``CheckpointPublisher``, ``WeightPublisher``).
"""

from .deploy import CheckpointPublisher, WeightPublisher  # noqa: F401
from .engine import Engine, TokenEvent, check_swappable  # noqa: F401
from .fleet import (FleetReport, Router, ServingFleet,  # noqa: F401
                    run_serving_fleet)
from .frontend import (ServingReport, TrafficClass,  # noqa: F401
                       aggregate_latency, class_slos, multi_tenant_workload,
                       reference_stream, run_serving, synthetic_workload)
from .kvcache import (TRASH_BLOCK, BlockAllocator,  # noqa: F401
                      PagedKVConfig, blocks_for, init_pool,
                      kv_bytes_per_token, naive_cache_bytes, pool_bytes)
from .scheduler import Request, RequestRecord, Scheduler  # noqa: F401
from .speculate import (DraftEngine, SpecConfig,  # noqa: F401
                        make_verify_step, rejection_accept)
