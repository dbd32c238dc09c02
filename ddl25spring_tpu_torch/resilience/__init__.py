"""Resilience: the port's counterpart of the JAX package's ``resilience/``.

- ``faults``     — ``FaultPlan``: NaN/Inf/spike gradients at chosen steps,
                   FL client drop/straggle per round, checkpoint
                   corruption, simulated SIGTERM preemption, replica
                   loss/return signals.
- ``guard``      — ``StepGuard``: all-finite and EMA-anomaly checked steps
                   with skip-and-count and rollback to the last good
                   checkpoint, restoring the live tensors in place.
- ``retry``      — exponential backoff with seeded jitter (checkpoint IO).
- ``preemption`` — SIGTERM → force-saved resumable checkpoint → clean exit.
- ``elastic``    — ``ElasticController``: the elastic re-mesh of data
                   parallelism (drain, re-form the process world, reshard,
                   re-split the stream, resume; shrink and grow), with
                   ``RemeshRecord`` and ``Resume``.
- ``autoscale``  — the SLO autoscaler's policy (``AutoscalePolicy``,
                   ``Autoscaler``, ``router_ttft_p95``); its decisions
                   drive ``ServingFleet.set_active`` and, through
                   ``train_llm_dp(scale_hook=)``, ``ElasticController.
                   resize``.

Counters land in ``metrics.ResilienceStats``, knobs in
``config.ResilienceConfig``.
"""

from .autoscale import (Autoscaler, AutoscalePolicy,  # noqa: F401
                        ScaleDecision, router_ttft_p95)
from .elastic import ElasticController, RemeshRecord, Resume  # noqa: F401
from .faults import (FaultEvent, FaultPlan, ReplicaLossError,  # noqa: F401
                     ReplicaReturnSignal, corrupt_latest_checkpoint,
                     parse_spec)
from .guard import StepGuard, measure_overhead  # noqa: F401
from .preemption import PreemptionHandler  # noqa: F401
from .retry import backoff_schedule, retry_call, with_retry  # noqa: F401
