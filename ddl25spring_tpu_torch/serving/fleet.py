"""Serving fleet: N engines behind an SLO-aware router, with live weight
hot-swap. Counterpart of the JAX package's ``serving/fleet.py``.

- ``Router`` dispatches each request under a policy:
  ``least_loaded`` (fewest outstanding requests, ties to the lowest engine
  id) or ``predicted_ttft`` (median TTFT over the engine's rolling window
  of completions, ``Scheduler.recent_done``, times ``1 + outstanding /
  num_slots``; an empty window borrows the fleet's, and with no sample
  anywhere the choice is least-loaded). Routing is a latency decision
  only: which engine serves a request never changes its tokens.
- ``ServingFleet.publish`` rolls a new weight tree out ONE ENGINE PER
  TICK: each engine swaps at its own token boundary
  (``Scheduler.swap_weights``) without dropping queued or in-flight
  streams, so the fleet never pauses as a whole. The tree is checked
  against the engines' once, at ``publish``, so a bad publish fails with
  the fleet untouched. Where publications come from is
  ``serving/deploy.py``.
- ``set_active(k)`` sends new requests to engines ``[0, k)`` only, while
  the others drain what they hold (the autoscaler's seam).

All engines live on the one device, each with its own block pool (and
draft pool, with speculation). Telemetry: one ``route`` event per
dispatch, one ``deploy`` event and span per engine swap, and every
``request_*`` event tagged with its ``engine``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..config import LlamaConfig
from ..models import generate, llama
from ..telemetry.events import EventLog
from ..telemetry.registry import percentile
from .engine import Engine, check_swappable
from .frontend import _Clock, aggregate_latency
from .kvcache import PagedKVConfig, pool_bytes
from .scheduler import Request, RequestRecord, Scheduler

POLICIES = ("least_loaded", "predicted_ttft")


class Router:
    """Dispatch over a set of schedulers. Holds one rolling TTFT window per
    engine (a deque of (t, ttft) pruned to ``window_s`` behind the
    scheduler clock), fed by ``harvest`` from each ``recent_done``."""

    def __init__(self, scheds: Sequence[Scheduler], *,
                 policy: str = "least_loaded", window_s: float = 30.0,
                 events: Optional[EventLog] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES} "
                             f"(got {policy!r})")
        self.scheds = list(scheds)
        self.policy = policy
        self.window_s = window_s
        self.events = events
        self._ttft: List[deque] = [deque() for _ in self.scheds]

    def harvest(self, now: float) -> None:
        """Pull new completions into the per-engine windows; prune."""
        horizon = now - self.window_s
        for dq, sched in zip(self._ttft, self.scheds):
            for t, ttft in sched.recent_done:
                if ttft is not None:
                    dq.append((t, ttft))
            sched.recent_done.clear()
            while dq and dq[0][0] < horizon:
                dq.popleft()

    def predicted_ttft(self, eid: int) -> Optional[float]:
        """Queue-depth-scaled TTFT estimate for a request sent to ``eid``
        now; None while no window anywhere has a sample."""
        vals = [v for _, v in self._ttft[eid]]
        if not vals:
            vals = [v for dq in self._ttft for _, v in dq]
        if not vals:
            return None
        sched = self.scheds[eid]
        return percentile(vals, 50) * (
            1.0 + sched.outstanding / max(1, sched.engine.num_slots))

    def pick(self, req: Request, now: float,
             eligible: Optional[Sequence[int]] = None) -> int:
        """The engine for ``req`` (among ``eligible``, default all), with
        its ``route`` event."""
        self.harvest(now)
        ids = (list(eligible) if eligible is not None
               else list(range(len(self.scheds))))
        if not ids:
            raise ValueError("Router.pick: no eligible engines")
        loads = [s.outstanding for s in self.scheds]
        if self.policy == "least_loaded":
            eid = min(ids, key=lambda i: (loads[i], i))
            predicted = None
        else:
            predictions = {i: self.predicted_ttft(i) for i in ids}
            eid = min(ids, key=lambda i: (predictions[i]
                                          if predictions[i] is not None
                                          else 0.0, loads[i], i))
            predicted = predictions[eid]
        if self.events is not None:
            self.events.route(req=req.rid, engine=eid, policy=self.policy,
                              tenant=req.tenant, outstanding=loads,
                              predicted_ttft_s=predicted)
        return eid


class ServingFleet:
    """N engines behind one router, with a staggered weight rollout.

    >>> fleet = ServingFleet(params, cfg, paged, num_engines=2,
    ...                      num_slots=8)
    >>> fleet.submit(req)                        # the router picks
    >>> while fleet.outstanding:
    ...     fleet.tick()
    >>> fleet.publish(new_params, version=1200)  # one engine per tick

    ``admission``, ``speculate`` and ``prefix_share`` apply to every engine
    (prefix caches are per engine: blocks are indices into one pool).
    ``device`` defaults to CUDA."""

    def __init__(self, params, cfg: LlamaConfig, paged: PagedKVConfig, *,
                 num_engines: int, num_slots: int, prefill_chunk: int = 16,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 events: Optional[EventLog] = None,
                 token_events: bool = True,
                 policy: str = "least_loaded", window_s: float = 30.0,
                 admission: str = "fcfs", speculate=None,
                 prefix_share: bool = False, memory_every: int = 0,
                 clock: Callable[[], float] = time.monotonic, device=None):
        if num_engines < 1:
            raise ValueError(f"num_engines={num_engines}")
        self.cfg = cfg
        self.paged = paged
        self.clock = clock
        self.engines = [Engine(params, cfg, paged, num_slots,
                               prefill_chunk=prefill_chunk, top_k=top_k,
                               top_p=top_p, engine_id=i, speculate=speculate,
                               prefix_share=prefix_share, device=device)
                        for i in range(num_engines)]
        self.scheds = [Scheduler(eng, events=events,
                                 token_events=token_events, clock=clock,
                                 engine_id=i, admission=admission,
                                 memory_every=memory_every)
                       for i, eng in enumerate(self.engines)]
        self.router = Router(self.scheds, policy=policy, window_s=window_s,
                             events=events)
        self.engine_of: Dict[str, int] = {}     # rid -> routed engine
        self._swap = None       # pending publish: one engine per tick
        self._active = num_engines
        self.deploys: List[dict] = []

    # ------------------------------------------------------------- capacity
    @property
    def active_engines(self) -> int:
        """How many engines take NEW requests."""
        return self._active

    def set_active(self, k: int) -> None:
        """New requests go to engines ``[0, k)`` only. A deactivated engine
        keeps ticking until its queued and in-flight streams finish (slot
        state cannot migrate); weights still roll out to every engine."""
        k = int(k)
        if not 1 <= k <= len(self.engines):
            raise ValueError(f"set_active({k}): fleet has "
                             f"{len(self.engines)} engines; need 1 <= k <= "
                             f"{len(self.engines)}")
        self._active = k

    # ------------------------------------------------------------- dispatch
    def submit(self, req: Request, now: Optional[float] = None) -> int:
        now = self.clock() if now is None else now
        eid = self.router.pick(req, now, eligible=range(self._active))
        self.scheds[eid].submit(req, now=now)
        self.engine_of[req.rid] = eid
        return eid

    @property
    def outstanding(self) -> int:
        return sum(s.outstanding for s in self.scheds)

    @property
    def swap_pending(self) -> bool:
        return self._swap is not None

    def next_swap(self) -> Optional[int]:
        """The engine the next ``tick()`` swaps, or None."""
        return self._swap["remaining"][0] if self._swap is not None else None

    def tick(self) -> List[tuple]:
        """One fleet boundary: swap at most one engine of a pending rollout
        (it leaves the rollout only once its swap succeeded), then tick
        every engine with work. Returns the merged (rid, token) pairs."""
        if self._swap is not None:
            eid = self._swap["remaining"][0]
            self.scheds[eid].swap_weights(self._swap["params"],
                                          self._swap["version"],
                                          fused=self._swap["fused"])
            self._swap["remaining"].popleft()
            self.deploys.append({"version": self._swap["version"],
                                 "engine": eid, "t": self.clock()})
            if not self._swap["remaining"]:
                self._swap = None
        emitted: List[tuple] = []
        for sched in self.scheds:
            if sched.outstanding:
                emitted.extend(sched.tick())
        return emitted

    # -------------------------------------------------------------- publish
    def publish(self, params, *, version) -> None:
        """Queue a fleet-wide weight swap: engine i swaps at the i-th
        following ``tick()``. Checks the tree against the engines' here, so
        a bad publish raises with nothing swapped and nothing pending, and
        fuses the block stack once for every engine."""
        if self._swap is not None:
            raise RuntimeError(
                f"publish({version!r}): previous publish "
                f"{self._swap['version']!r} is still rolling out "
                f"({len(self._swap['remaining'])} engines to go)")
        params = llama.as_tree(params)
        check_swappable(self.engines[0].params, params)
        self._swap = {"version": version, "params": params,
                      "fused": generate._fuse_blocks(params["blocks"]),
                      "remaining": deque(range(len(self.engines)))}

    # ----------------------------------------------------------- accounting
    @property
    def records(self) -> Dict[str, RequestRecord]:
        merged: Dict[str, RequestRecord] = {}
        for sched in self.scheds:
            merged.update(sched.records)
        return merged

    @property
    def completed(self) -> int:
        return sum(s.completed for s in self.scheds)

    def compiles(self) -> List[int]:
        """Per engine: the call signatures its programs saw (the JAX
        engine's compiles)."""
        return [sum(len(w.compiles) for w in e.watches())
                for e in self.engines]

    def retraces(self) -> List[int]:
        """Per engine: signatures past its program budget (0 expected)."""
        return [sum(w.retraces for w in e.watches()) for e in self.engines]

    def pool_headroom(self, k: Optional[int] = None) -> float:
        """The smallest free-block fraction over the first ``k`` engines
        (default: the active ones)."""
        k = self._active if k is None else max(1, min(int(k),
                                                      len(self.engines)))
        return min(e.allocator.free_blocks / max(1, e.allocator.capacity)
                   for e in self.engines[:k])


@dataclass
class FleetReport:
    """One fleet run: merged records, fleet-wide, per-class and per-engine
    aggregates, the rollout log, and per-engine compile and retrace counts
    (``ServingFleet.compiles`` / ``retraces``)."""
    records: Dict[str, RequestRecord]
    aggregates: dict
    per_class: Dict[str, dict]
    per_engine: Dict[int, dict]
    engine_of: Dict[str, int]
    wall_s: float
    num_engines: int
    pool_blocks: int
    pool_bytes_per_engine: int
    peak_blocks_per_engine: List[int] = field(default_factory=list)
    deploys: List[dict] = field(default_factory=list)
    requests: List[Request] = field(default_factory=list)
    compiles: List[int] = field(default_factory=list)
    retraces: List[int] = field(default_factory=list)


def run_serving_fleet(params, cfg: LlamaConfig, paged: PagedKVConfig,
                      workload: Sequence[Request], *, num_engines: int,
                      num_slots: int, prefill_chunk: int = 16,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None,
                      events: Optional[EventLog] = None,
                      token_events: bool = True,
                      policy: str = "least_loaded", window_s: float = 30.0,
                      admission: str = "fcfs", speculate=None,
                      prefix_share: bool = False, memory_every: int = 0,
                      publish_after: Optional[int] = None,
                      publish_params=None, publish_version=None,
                      device=None) -> FleetReport:
    """``frontend.run_serving`` over N engines on ``device`` (default
    CUDA): replay the workload through a fresh fleet in fast-forwarded
    real time. With ``publish_after``, one publish of ``publish_params``
    fires at the first boundary where that many requests have completed.
    Returns once every request is retired and the rollout has drained."""
    clock = _Clock()
    fleet = ServingFleet(params, cfg, paged, num_engines=num_engines,
                         num_slots=num_slots, prefill_chunk=prefill_chunk,
                         top_k=top_k, top_p=top_p, events=events,
                         token_events=token_events, policy=policy,
                         window_s=window_s, admission=admission,
                         speculate=speculate, prefix_share=prefix_share,
                         memory_every=memory_every, clock=clock.now,
                         device=device)
    pending = sorted(workload, key=lambda r: (r.arrival, r.rid))
    published = publish_after is None
    busy_s = 0.0
    i = 0
    while i < len(pending) or fleet.outstanding or fleet.swap_pending:
        now = clock.now()
        while i < len(pending) and pending[i].arrival <= now:
            fleet.submit(pending[i], now=now)
            i += 1
        if not published and fleet.completed >= publish_after:
            fleet.publish(publish_params, version=publish_version)
            published = True
        if (fleet.outstanding == 0 and not fleet.swap_pending
                and i < len(pending)):
            clock.fast_forward(pending[i].arrival)   # idle: jump, not sleep
            continue
        fleet.tick()
        busy_s += clock.now() - now
    records = fleet.records
    classes = sorted({r.tenant for r in records.values()})
    per_class = {c: aggregate_latency({k: r for k, r in records.items()
                                       if r.tenant == c})
                 for c in classes}
    per_engine = {}
    for eid in range(num_engines):
        agg = aggregate_latency({k: r for k, r in records.items()
                                 if r.engine == eid})
        agg["peak_blocks_in_use"] = fleet.engines[eid].allocator.peak_in_use
        per_engine[eid] = agg
    return FleetReport(
        records=records,
        aggregates=aggregate_latency(records, busy_span_s=busy_s),
        per_class=per_class, per_engine=per_engine,
        engine_of=dict(fleet.engine_of), wall_s=clock.now(),
        num_engines=num_engines,
        pool_blocks=fleet.engines[0].allocator.capacity,
        pool_bytes_per_engine=pool_bytes(cfg, paged),
        peak_blocks_per_engine=[e.allocator.peak_in_use
                                for e in fleet.engines],
        deploys=list(fleet.deploys), requests=list(workload),
        compiles=fleet.compiles(), retraces=fleet.retraces())
