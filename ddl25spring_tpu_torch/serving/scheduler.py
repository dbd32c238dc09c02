"""Continuous-batching scheduler: admit/retire at token boundaries.
Counterpart of the JAX package's ``serving/scheduler.py``.

At every token boundary the scheduler admits queued requests into free
slots, advances the engine one step (one prefill chunk, one decode token
for everyone in flight) and retires finished requests, whose blocks return
to the pool at once.

Admission reserves a request's worst-case block count up front, all or
nothing, so an admitted request always runs to completion: pool exhaustion
only delays admissions and nothing deadlocks. ``admission="fcfs"`` keeps
strict arrival order (the head blocks the line); ``"sjf"`` admits, when
the head does not fit but a slot is free, the shortest fitting reservation
of the same priority. Higher ``Request.priority`` admits first. Admission
order changes latency only: every engine op is row-independent and per-slot
state travels with the request, so a request's tokens do not depend on its
slot or company.

Telemetry: each lifecycle edge emits a ``request_*`` event, and each
request is one trace (``request`` root span with ``queue`` → ``prefill``
(per-chunk ``prefill_chunk`` children) → ``decode`` → ``retire``), on the
scheduler's own clock. In a fleet every event and span carries the
``engine`` it ran on; a weight swap emits a ``deploy`` event and span, and
each speculative round a ``speculate`` event. The engine's compile watches
report ``compile`` events into the same stream, and ``memory_every=N``
adds a ``memory`` event every N busy ticks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry.events import EventLog
from ..telemetry.introspect import bind_events
from ..telemetry.memory import MemoryMeter, allocator_census, tree_state_bytes
from ..telemetry.trace import Span, Tracer
from .engine import Engine
from .kvcache import kv_bytes_per_token


@dataclass(frozen=True)
class Request:
    """One generation request. ``seed`` seeds the request's
    ``torch.Generator`` when ``temperature > 0`` (equal seed ⇒ the stream
    ``generate()`` emits for it alone). ``arrival`` is an offset in seconds
    from workload start. Emitting ``eos_id`` retires the request at that
    token boundary. ``priority`` orders admission (higher first);
    ``tenant`` names the traffic class."""
    rid: str
    prompt: Tuple[int, ...]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    arrival: float = 0.0
    eos_id: Optional[int] = None
    tenant: str = "default"
    priority: int = 0


@dataclass
class RequestRecord:
    """Per-request lifecycle times and emitted tokens."""
    rid: str
    prompt_len: int
    max_new: int
    blocks: int = 0
    tenant: str = "default"
    engine: Optional[int] = None   # fleet: the engine that served it
    enqueue_t: Optional[float] = None
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    tokens: List[int] = field(default_factory=list)

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None or self.enqueue_t is None:
            return None
        return self.admit_t - self.enqueue_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None or self.enqueue_t is None:
            return None
        return self.first_token_t - self.enqueue_t

    @property
    def tokens_per_sec(self) -> Optional[float]:
        if self.done_t is None or self.admit_t is None:
            return None
        dt = self.done_t - self.admit_t
        return len(self.tokens) / dt if dt > 0 else None


class Scheduler:
    """Continuous batching over one Engine.

    >>> sched = Scheduler(engine, events=log)
    >>> sched.submit(req, now=0.0)
    >>> while sched.outstanding:
    ...     sched.tick()
    >>> sched.records[req.rid].tokens
    """

    def __init__(self, engine: Engine, *, events: Optional[EventLog] = None,
                 token_events: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 engine_id: Optional[int] = None,
                 admission: str = "fcfs", memory_every: int = 0):
        if admission not in ("fcfs", "sjf"):
            raise ValueError(f"admission must be 'fcfs' or 'sjf' "
                             f"(got {admission!r})")
        self.engine = engine
        self.events = events
        self.token_events = token_events
        self.clock = clock
        self.policy = admission
        # Every event and span is tagged with the engine this scheduler
        # fronts, so a fleet's stream can be grouped per engine.
        self.engine_id = (engine_id if engine_id is not None
                          else getattr(engine, "engine_id", None))
        self._tag = ({"engine": self.engine_id}
                     if self.engine_id is not None else {})
        # (done_t, ttft_s) per completion, drained by the fleet's router.
        self.recent_done: List[Tuple[float, Optional[float]]] = []
        # engine.last_spec per speculative round, with or without events.
        self.spec_rounds: List[dict] = []
        if events is not None:
            # The engine's compile watches report into this stream.
            for w in getattr(engine, "watches", list)():
                bind_events(w, events)
        self.tracer = (Tracer(events,
                              clock_ns=lambda: int(self.clock() * 1e9))
                       if events is not None else None)
        self._spans: Dict[str, Dict[str, Span]] = {}   # rid -> open spans
        self._chunks: Dict[str, int] = {}              # rid -> chunks done
        # Memory census: every ``memory_every``-th busy tick, one ``memory``
        # event with the pool's occupancy and fragmentation, the engine's
        # parameter bytes and the CUDA allocator's counters. Off (0) by
        # default; on, it is host bookkeeping and reads no device value,
        # so the served streams do not change.
        self.memory_every = int(memory_every)
        self.memory_meter = None
        self._bytes_per_block = None
        self._ticks = 0
        if self.memory_every > 0:
            self.memory_meter = MemoryMeter(events, source="serve",
                                            device=engine.device)
            self.memory_meter.note(
                params_bytes=tree_state_bytes(engine.params))
            self._bytes_per_block = (engine.paged.block_len
                                     * kv_bytes_per_token(
                                         engine.cfg, engine.paged.kv_dtype))
        self.queue: List[Request] = []
        self.records: Dict[str, RequestRecord] = {}
        self._by_slot: Dict[int, Request] = {}
        self.completed = 0
        # High-water mark of in-flight requests, recorded at admission.
        self.peak_in_flight = 0

    # -------------------------------------------------------------- lifecycle
    def submit(self, req: Request, now: Optional[float] = None) -> None:
        """Enqueue; raises for a request no pool state could ever serve,
        so the queue never holds an unadmittable head."""
        need = self.engine.required_blocks(len(req.prompt), req.max_new)
        positions = len(req.prompt) + req.max_new - 1
        if (need > self.engine.allocator.capacity
                or positions > self.engine.paged.max_seq_len):
            raise ValueError(
                f"{req.rid}: needs {positions} cache positions / {need} "
                f"blocks but the engine serves at most "
                f"{self.engine.paged.max_seq_len} positions / "
                f"{self.engine.allocator.capacity} blocks — oversized for "
                "this engine at any load")
        now = self.clock() if now is None else now
        self.queue.append(req)
        self.records[req.rid] = RequestRecord(
            rid=req.rid, prompt_len=len(req.prompt), max_new=req.max_new,
            blocks=need, tenant=req.tenant, engine=self.engine_id,
            enqueue_t=now)
        if self.events:
            self.events.request_enqueue(
                req=req.rid, prompt_len=len(req.prompt), max_new=req.max_new,
                temperature=req.temperature, queued=len(self.queue),
                tenant=req.tenant, priority=req.priority, **self._tag)
        if self.tracer:
            root = self.tracer.start("request", trace=req.rid,
                                     prompt_len=len(req.prompt),
                                     max_new=req.max_new, **self._tag)
            self._spans[req.rid] = {
                "root": root,
                "queue": self.tracer.start("queue", parent=root.ctx)}

    @property
    def outstanding(self) -> int:
        """Requests not yet retired (queued + in flight)."""
        return len(self.queue) + len(self._by_slot)

    def tick(self) -> List[Tuple[str, int]]:
        """One token boundary: admit, advance the engine, retire. Returns
        the (rid, token) pairs emitted at this boundary."""
        self._admit()
        if not self.engine.busy:
            return []
        emitted: List[Tuple[str, int]] = []
        chunk_spans: List[Span] = []
        if self.tracer:
            # Requests without a first token advance one prefill chunk in
            # this step: open their chunk spans before it.
            for req in self._by_slot.values():
                if self.records[req.rid].first_token_t is None:
                    i = self._chunks.get(req.rid, 0)
                    self._chunks[req.rid] = i + 1
                    chunk_spans.append(self.tracer.start(
                        "prefill_chunk",
                        parent=self._spans[req.rid]["prefill"].ctx, chunk=i))
        events = self.engine.step()
        now = self.clock()   # post-step: token timestamps include the step
        for span in chunk_spans:
            span.end()
        eos_retired: set = set()
        eos_dropped = 0
        for ev in events:
            if ev.slot in eos_retired:
                # The slot EOS-retired earlier in this tick (a final prefill
                # token and a decode token in one step, or an EOS inside a
                # verify window): drop what follows.
                eos_dropped += 1
                continue
            req = self._by_slot[ev.slot]
            rec = self.records[req.rid]
            rec.tokens.append(ev.token)
            if ev.first:
                rec.first_token_t = now
                if self.tracer:
                    spans = self._spans[req.rid]
                    spans["prefill"].end(chunks=self._chunks.get(req.rid, 0))
                    spans["decode"] = self.tracer.start(
                        "decode", parent=spans["root"].ctx, slot=ev.slot)
            if self.events and self.token_events:
                self.events.request_token(req=req.rid, i=len(rec.tokens) - 1,
                                          tok=ev.token, slot=ev.slot,
                                          **self._tag)
            done = ev.done
            early_eos = False
            if not done and req.eos_id is not None and ev.token == req.eos_id:
                # The request is finished at this boundary: its whole
                # reservation returns to the pool now. A verify window can
                # emit the EOS and reach max_new in one step, and then the
                # engine has already retired the slot.
                if self.engine.slots[ev.slot] is not None:
                    self.engine.retire(ev.slot)
                eos_retired.add(ev.slot)
                done = early_eos = True
            if done:
                self._finish(req, rec, ev.slot, now, early_eos)
            emitted.append((req.rid, ev.token))
        if self.engine.last_spec is not None:
            # One ``speculate`` event per verify dispatch, counting the
            # tokens delivered: a window's tail after an EOS is dropped.
            spec = self.engine.last_spec
            if eos_dropped:
                spec = {**spec, "emitted": spec["emitted"] - eos_dropped}
            self.spec_rounds.append(spec)
            if self.events:
                self.events.speculate(**spec, **self._tag)
        if eos_dropped:
            self.engine.decode_tokens -= eos_dropped
        if self.memory_meter is not None:
            self._ticks += 1
            if self._ticks % self.memory_every == 0:
                self.memory_meter.sample(
                    tick=self._ticks, in_flight=len(self._by_slot),
                    queued=len(self.queue),
                    **allocator_census(
                        self.engine.allocator,
                        bytes_per_block=self._bytes_per_block),
                    **self._tag)
        return emitted

    def _finish(self, req: Request, rec: RequestRecord, slot: int,
                now: float, early_eos: bool) -> None:
        rec.done_t = now
        del self._by_slot[slot]
        self.completed += 1
        self.recent_done.append((now, rec.ttft_s))
        eos = {"eos": True} if early_eos else {}
        if self.tracer:
            spans = self._spans.pop(req.rid)
            self._chunks.pop(req.rid, None)
            spans["decode"].end(tokens=len(rec.tokens))
            self.tracer.start("retire", parent=spans["root"].ctx,
                              blocks_freed=rec.blocks).end()
            spans["root"].end(tokens=len(rec.tokens), **eos)
        if self.events:
            self.events.request_done(
                req=req.rid, tokens=len(rec.tokens),
                queue_wait_s=rec.queue_wait_s, ttft_s=rec.ttft_s,
                tokens_per_sec=rec.tokens_per_sec, blocks_freed=rec.blocks,
                blocks_in_use=self.engine.blocks_in_use(), tenant=req.tenant,
                **self._tag, **eos)

    # ---------------------------------------------------------- weight swap
    def swap_weights(self, params, version, *, fused=None) -> None:
        """Hot-swap the engine's weights at the current token boundary
        (between ``tick()`` calls; with speculation, a verify boundary)
        without touching queued or in-flight requests, and emit a
        ``deploy`` event and span with the publication ``version`` and how
        many streams crossed the swap live."""
        span = (self.tracer.start("deploy", trace=f"deploy-{version}",
                                  version=version,
                                  in_flight=len(self._by_slot),
                                  queued=len(self.queue), **self._tag)
                if self.tracer else None)
        self.engine.swap_params(params, fused=fused)
        if span is not None:
            span.end()
        if self.events:
            self.events.deploy(version=version, in_flight=len(self._by_slot),
                               queued=len(self.queue), **self._tag)

    # -------------------------------------------------------------- admission
    def _pick_admittable(self) -> Optional[int]:
        """Queue index of the next request to admit, or None."""
        top = max(r.priority for r in self.queue)
        group = [i for i, r in enumerate(self.queue) if r.priority == top]
        head = self.queue[group[0]]
        if self.engine.can_admit(len(head.prompt), head.max_new,
                                 prompt=head.prompt):
            return group[0]
        if self.policy == "sjf" and self.engine.free_slot() is not None:
            fitting = [i for i in group
                       if self.engine.can_admit(len(self.queue[i].prompt),
                                                self.queue[i].max_new,
                                                prompt=self.queue[i].prompt)]
            if fitting:
                return min(fitting,
                           key=lambda i: (self.records[self.queue[i].rid]
                                          .blocks, i))
        return None

    def _admit(self) -> None:
        while self.queue:
            pick = self._pick_admittable()
            if pick is None:
                return
            head = self.queue.pop(pick)
            gen = None
            if head.temperature > 0:
                gen = torch.Generator(device=self.engine.device)
                gen.manual_seed(head.seed)
            slot = self.engine.admit(np.asarray(head.prompt, np.int64),
                                     head.max_new,
                                     temperature=head.temperature,
                                     generator=gen)
            self._by_slot[slot] = head
            self.peak_in_flight = max(self.peak_in_flight,
                                      len(self._by_slot))
            rec = self.records[head.rid]
            rec.admit_t = self.clock()
            if self.tracer:
                spans = self._spans[head.rid]
                spans["queue"].end()
                spans["prefill"] = self.tracer.start(
                    "prefill", parent=spans["root"].ctx, slot=slot,
                    blocks=rec.blocks)
            if self.events:
                self.events.request_prefill(
                    req=head.rid, slot=slot, blocks=rec.blocks,
                    queue_wait_s=rec.queue_wait_s,
                    blocks_in_use=self.engine.blocks_in_use(), **self._tag)
