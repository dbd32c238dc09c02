"""Front end: synthetic workloads + the serving run driver. Counterpart of
the JAX package's ``serving/frontend.py``.

``synthetic_workload`` is a seeded Poisson arrival process over discrete
prompt/output length and temperature mixtures (the same draws, in the same
order, as the JAX package's, so one seed gives both packages the same
requests). ``multi_tenant_workload`` merges one such stream per
``TrafficClass`` (its own rate, lengths, admission priority and SLO
targets), arrival-ordered: the fleet's traffic (``serving/fleet.py``).
``run_serving`` replays a workload through a fresh engine and scheduler in
fast-forwarded real time and aggregates per-request latency: sustained
tok/s and p50/p95/p99 queue wait and TTFT.

The clock is wall time with idle fast-forward: while requests are in
flight latencies are real; when engine and queue are both empty the clock
jumps to the next arrival instead of sleeping, so it never shortens a
queue wait or a TTFT.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import LlamaConfig
from ..device import resolve_device
from ..models import generate
from ..telemetry.events import EventLog
from ..telemetry.registry import percentile
from .engine import Engine
from .kvcache import PagedKVConfig, naive_cache_bytes, pool_bytes
from .scheduler import Request, RequestRecord, Scheduler


def synthetic_workload(*, seed: int, n_requests: int, rate_rps: float,
                       vocab_size: int,
                       prompt_lens: Sequence[int] = (8, 16, 48),
                       prompt_weights: Optional[Sequence[float]] = None,
                       max_news: Sequence[int] = (8, 16, 32),
                       max_new_weights: Optional[Sequence[float]] = None,
                       temperatures: Sequence[float] = (0.0, 0.8),
                       temperature_weights: Optional[Sequence[float]] = None,
                       tenant: str = "default", priority: int = 0,
                       rid_prefix: str = "req") -> List[Request]:
    """Seeded Poisson arrivals (exponential inter-arrival at ``rate_rps``)
    over mixed prompt/output lengths and temperatures; one
    ``np.random.default_rng(seed)`` drives every draw."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs: List[Request] = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        tp = int(rng.choice(np.asarray(prompt_lens), p=prompt_weights))
        mx = int(rng.choice(np.asarray(max_news), p=max_new_weights))
        temp = float(rng.choice(np.asarray(temperatures, np.float64),
                                p=temperature_weights))
        prompt = tuple(int(x) for x in rng.integers(0, vocab_size, tp))
        reqs.append(Request(rid=f"{rid_prefix}-{i:04d}", prompt=prompt,
                            max_new=mx, temperature=temp,
                            seed=int(rng.integers(0, 2 ** 31 - 1)),
                            arrival=t, tenant=tenant, priority=priority))
    return reqs


@dataclass(frozen=True)
class TrafficClass:
    """One tenant class of a multi-tenant workload: its Poisson rate,
    length and temperature mixtures, admission ``priority`` (higher admits
    first) and optional per-class SLO targets. Counts belong to the
    ``multi_tenant_workload`` call."""
    name: str
    rate_rps: float
    prompt_lens: Sequence[int] = (8, 16, 48)
    max_news: Sequence[int] = (8, 16, 32)
    temperatures: Sequence[float] = (0.0, 0.8)
    priority: int = 0
    ttft_p99_s: Optional[float] = None
    queue_p99_s: Optional[float] = None


def multi_tenant_workload(*, seed: int, classes: Sequence[TrafficClass],
                          n_per_class, vocab_size: int) -> List[Request]:
    """One seeded Poisson stream per class, merged in arrival order. Class
    ``i`` draws from seed ``seed + 7919·(i+1)`` (the JAX package's
    derivation, so both packages give the same requests), so adding a
    class never changes another's stream; request ids are
    ``<class>-<i>``, and each request carries its class as ``tenant`` and
    the class's ``priority``. ``n_per_class`` is an int or a
    ``{name: count}`` mapping."""
    reqs: List[Request] = []
    for idx, cls in enumerate(classes):
        n = (n_per_class[cls.name] if isinstance(n_per_class, dict)
             else int(n_per_class))
        reqs.extend(synthetic_workload(
            seed=seed + 7919 * (idx + 1), n_requests=n,
            rate_rps=cls.rate_rps, vocab_size=vocab_size,
            prompt_lens=cls.prompt_lens, max_news=cls.max_news,
            temperatures=cls.temperatures, tenant=cls.name,
            priority=cls.priority, rid_prefix=cls.name))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


def class_slos(classes: Sequence[TrafficClass]
               ) -> Dict[str, Dict[str, float]]:
    """The per-class SLO table ``{class: {objective: threshold}}``;
    classes without targets are left out."""
    out: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        limits = {}
        if cls.ttft_p99_s is not None:
            limits["ttft_p99_s"] = cls.ttft_p99_s
        if cls.queue_p99_s is not None:
            limits["queue_p99_s"] = cls.queue_p99_s
        if limits:
            out[cls.name] = limits
    return out


def reference_stream(params, cfg: LlamaConfig, paged: PagedKVConfig,
                     req: Request, *, top_k: Optional[int] = None,
                     top_p: Optional[float] = None, device=None) -> List[int]:
    """The parity reference: the port's ``generate()`` run ALONE on one
    request. ``max_len`` is pinned to ``paged.max_seq_len`` (both sides
    reduce over equally long score rows), ``kv_dtype`` to the pool's, and a
    sampling request's generator is seeded from ``req.seed`` as the
    scheduler seeds it. Runs on ``device`` (default CUDA). A request with
    an ``eos_id`` gets its stream cut after the first EOS, as the
    scheduler retires it there."""
    dev = resolve_device(device)
    kw = dict(max_len=paged.max_seq_len, kv_dtype=paged.kv_dtype,
              top_k=top_k, top_p=top_p, device=dev)
    if req.temperature > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(req.seed)
        kw.update(generator=gen, temperature=req.temperature)
    toks = generate.generate(params, torch.tensor([req.prompt]), cfg,
                             req.max_new, **kw)[0].tolist()
    if req.eos_id is not None and req.eos_id in toks:
        toks = toks[:toks.index(req.eos_id) + 1]
    return toks


class _Clock:
    """Monotonic seconds since start, with idle fast-forward."""

    def __init__(self):
        self._t0 = time.monotonic()
        self._skew = 0.0

    def now(self) -> float:
        return time.monotonic() - self._t0 + self._skew

    def fast_forward(self, to: float) -> None:
        self._skew += max(0.0, to - self.now())


@dataclass
class ServingReport:
    """One serving run: per-request records + the aggregate row."""
    records: Dict[str, RequestRecord]
    aggregates: dict
    wall_s: float
    peak_blocks_in_use: int
    pool_blocks: int
    pool_bytes: int = 0
    naive_bytes_at_peak: int = 0
    peak_concurrency: int = 0
    requests: List[Request] = field(default_factory=list)
    # The engine's compile watches (telemetry.introspect.CompileWatch): the
    # call signatures its programs saw, and those past their budget. The
    # contract is the JAX engine's: compiles equal the program shapes hit
    # (prefill + decode, + one per extra gather width), retraces 0.
    compiles: int = 0
    retraces: int = 0
    # Target decode dispatches (verify dispatches when speculating), the
    # tokens they emitted and their ratio (≈ the average decode batch,
    # times accepted + 1 with speculation), and the draft's dispatches.
    decode_dispatches: int = 0
    decode_tokens: int = 0
    draft_dispatches: int = 0
    tokens_per_dispatch: Optional[float] = None
    spec_proposed: int = 0
    spec_accepted: int = 0
    acceptance_rate: Optional[float] = None
    # KV bytes the decode and verify gathers walked, and the bytes a
    # full-width walk would have added (gather_buckets).
    gather_bytes: int = 0
    gather_bytes_saved: int = 0


def aggregate_latency(records: Dict[str, RequestRecord],
                      busy_span_s: Optional[float] = None) -> dict:
    """p50/p95/p99 queue wait and TTFT, per-request tok/s, and sustained
    throughput over ``busy_span_s`` (the engine's working time; without it,
    first admission → last completion). Always the full record shape:
    an empty window gives ``completed: 0`` and ``None`` figures."""
    pct = lambda vals: {f"p{q:g}": (percentile(vals, q) if vals else None)
                        for q in (50, 95, 99)}
    done = [r for r in records.values() if r.done_t is not None]
    if not done:
        return {"completed": 0, "total_tokens": 0,
                "sustained_tokens_per_sec": None,
                "busy_span_s": busy_span_s,
                "queue_wait_s": pct([]), "ttft_s": pct([]),
                "request_tokens_per_sec": pct([])}
    waits = [r.queue_wait_s for r in done if r.queue_wait_s is not None]
    ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
    rates = [r.tokens_per_sec for r in done if r.tokens_per_sec is not None]
    total_tokens = sum(len(r.tokens) for r in done)
    span = busy_span_s if busy_span_s is not None else (
        max(r.done_t for r in done)
        - min(r.admit_t for r in done if r.admit_t is not None))
    return {
        "completed": len(done),
        "total_tokens": total_tokens,
        "sustained_tokens_per_sec": (total_tokens / span if span > 0
                                     else None),
        "busy_span_s": span,
        "queue_wait_s": pct(waits),
        "ttft_s": pct(ttfts),
        "request_tokens_per_sec": pct(rates),
    }


def run_serving(params, cfg: LlamaConfig, paged: PagedKVConfig,
                workload: Sequence[Request], *, num_slots: int,
                prefill_chunk: int = 16, top_k: Optional[int] = None,
                top_p: Optional[float] = None,
                events: Optional[EventLog] = None,
                token_events: bool = True, speculate=None,
                prefix_share: bool = False, gather_buckets: bool = False,
                device=None) -> ServingReport:
    """Replay ``workload`` (arrival offsets in seconds) through a fresh
    engine + scheduler on ``device`` (default CUDA); returns per-request
    records and the aggregate row. Every request is retired on return:
    reservation-based admission cannot deadlock. ``speculate`` (a
    ``SpecConfig``) turns on draft-propose / one-dispatch-verify decoding,
    ``prefix_share`` maps identical full-block prompt prefixes
    copy-on-write, ``gather_buckets`` narrows the decode gather to
    bucketed live-block counts."""
    engine = Engine(params, cfg, paged, num_slots,
                    prefill_chunk=prefill_chunk, top_k=top_k, top_p=top_p,
                    speculate=speculate, prefix_share=prefix_share,
                    gather_buckets=gather_buckets, device=device)
    clock = _Clock()
    sched = Scheduler(engine, events=events, token_events=token_events,
                      clock=clock.now)
    pending = sorted(workload, key=lambda r: r.arrival)
    busy_s = 0.0       # working time, fast-forwarded idle excluded
    i = 0
    while i < len(pending) or sched.outstanding:
        now = clock.now()
        while i < len(pending) and pending[i].arrival <= now:
            sched.submit(pending[i], now=now)
            i += 1
        if sched.outstanding == 0:
            clock.fast_forward(pending[i].arrival)   # idle: jump, don't sleep
            continue
        sched.tick()
        busy_s += clock.now() - now
    peak_conc = sched.peak_in_flight
    spec_prop = sum(e["proposed"] for e in sched.spec_rounds)
    spec_acc = sum(e["accepted"] for e in sched.spec_rounds)
    return ServingReport(
        records=sched.records,
        aggregates=aggregate_latency(sched.records, busy_span_s=busy_s),
        wall_s=clock.now(),
        peak_blocks_in_use=engine.allocator.peak_in_use,
        pool_blocks=engine.allocator.capacity,
        pool_bytes=pool_bytes(cfg, paged),
        naive_bytes_at_peak=naive_cache_bytes(
            cfg, max(1, peak_conc), paged.max_seq_len, paged.kv_dtype),
        peak_concurrency=peak_conc,
        requests=list(workload),
        decode_dispatches=engine.decode_dispatches,
        decode_tokens=engine.decode_tokens,
        draft_dispatches=engine.draft_dispatches,
        tokens_per_dispatch=(engine.decode_tokens / engine.decode_dispatches
                             if engine.decode_dispatches else None),
        spec_proposed=spec_prop, spec_accepted=spec_acc,
        acceptance_rate=spec_acc / spec_prop if spec_prop else None,
        gather_bytes=engine.gather_bytes,
        gather_bytes_saved=engine.gather_bytes_saved,
        compiles=sum(len(w.compiles) for w in engine.watches()),
        retraces=sum(w.retraces for w in engine.watches()))
