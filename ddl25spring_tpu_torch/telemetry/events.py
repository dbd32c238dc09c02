"""Schema-versioned, append-only JSONL event stream: the port's copy of the
JAX package's ``telemetry/events.py``, at the same ``SCHEMA_VERSION``.

Training loops emit per-step records and fault events, FL servers emit
round summaries, the serving scheduler emits the request lifecycle, and
every run opens with a manifest carrying its configuration and its
communication profile. The stream format, the event types, the required
fields and the readers are the reference's, so the JAX package's
``validate_event`` and its jax-free readers (``experiments/obs_report.py``,
``experiments/trace_export.py``) read the port's streams unchanged. A
port manifest carries ``jax_version`` as null (the field is required by
the schema) beside ``torch_version``.

Write contract:
- One event per line, compact JSON, written as ONE ``write()`` call on an
  ``O_APPEND`` file descriptor (looped only if the kernel writes short,
  after which the next emit seals the fragment with a newline). Within one
  process the lock makes every line atomic; across processes sharing a
  log, a Linux local filesystem appends each write atomically. A reader
  tolerates a torn FINAL line, and a reopening writer truncates one.
- Every event carries ``schema`` (version), ``run_id``, ``seq`` (per-writer
  monotonic), ``t`` (epoch seconds) and ``type``. Extra fields are always
  legal; event TYPES are closed per schema version (``validate_event``).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

# v2: serving request lifecycle (request_enqueue / request_prefill /
# request_token / request_done — serving/scheduler.py). v3: fleet-scale FL
# (fl/fleet.py) — ``fl_cohort`` (one device dispatch of a streamed cohort)
# and ``fl_tier`` (one aggregation tier's per-round summary with exact
# payload-byte accounting). v4: distributed tracing + live SLOs —
# ``span`` (one closed trace span: telemetry/trace.py's Tracer, exported
# to Chrome trace JSON by experiments/trace_export.py) and
# ``slo_violation`` (experiments/slo_monitor.py's rolling-window verdicts).
# v5: run-health introspection (telemetry/introspect.py) — ``numerics``
# (in-jit per-layer-group grad/param/update norms + per-leaf NaN
# attribution, sampled from the training loop at a configurable cadence)
# and ``compile`` (one XLA compilation of a watched jit entry point:
# wall seconds, cache size, retrace flag, HLO flops/bytes for roofline
# attainment). v6: serving fleet (serving/fleet.py, serving/deploy.py) —
# ``route`` (one router dispatch decision: which engine a request was
# handed to, under which policy) and ``deploy`` (one engine's live weight
# hot-swap at a token boundary: the published version, streams in flight
# across the swap); ``request_*`` events additionally carry ``engine``
# (the serving engine id) and ``tenant`` (the traffic class) when emitted
# by a fleet scheduler — extras, so single-engine v2 streams stay valid.
# v7: speculative decoding (serving/speculate.py) — ``speculate`` (one
# draft-propose + verify round: proposed/accepted/rejected draft-token
# counts and tokens emitted by the ONE verify dispatch — the
# acceptance-rate and tokens-per-dispatch accounting obs_report renders
# and slo_monitor's acceptance floor watches).
# v8: autoscaling (resilience/autoscale.py) — ``scale`` (one capacity
# move between the training mesh and the serving fleet: direction plus
# the post-transition allocation, rendered by obs_report's "scale"
# section and marked as a Perfetto instant by trace_export).
# v9: memory observability (telemetry/memory.py) — ``memory`` (one
# MemoryMeter sample at a chunk edge / scheduler tick / smoke phase:
# host RSS, training-state and elastic-mirror bytes, KV pool occupancy
# and fragmentation, per-engine when fleet-scale); ``compile`` events
# additionally carry the program's static device footprint
# (``argument_bytes``/``output_bytes``/``temp_bytes``/
# ``generated_code_bytes`` from compiled.memory_analysis()) and
# ``manifest`` carries the preflight fit estimate — extras, so v5–v8
# streams stay valid.
# Version bumps are additive: a v9 reader accepts v1–v8 streams
# unchanged, and older readers reject v9 (the "future schema" rule in
# validate_event) rather than misread it.
SCHEMA_VERSION = 9

# Event types this schema version defines. The type set is CLOSED per
# schema version: ``validate_event`` checks base fields for all types, the
# per-type required fields for the known ones, and (since v4) flags an
# unknown type carrying a schema at/below the reader's version — an
# unknown type is either a typo (same version) or a future schema's
# addition (whose version bump already flags it, by name).
EVENT_TYPES = ("manifest", "step", "fault", "fl_round", "run_end", "remesh",
               "request_enqueue", "request_prefill", "request_token",
               "request_done", "fl_cohort", "fl_tier", "span",
               "slo_violation", "numerics", "compile", "route", "deploy",
               "speculate", "scale", "memory")

_BASE_FIELDS = ("schema", "run_id", "seq", "t", "type")
_REQUIRED: Dict[str, tuple] = {
    "manifest": ("jax_version", "platform"),
    "step": ("it",),
    "fault": ("counters",),
    "fl_round": ("round",),
    "run_end": ("steps",),
    # Elastic re-mesh recovery (resilience/elastic.py): replica loss →
    # survivor submesh + cross-topology state reshard. Carries old/new
    # world size plus path taken ("mirror"/"checkpoint"), seconds lost,
    # and steps replayed; multi-axis meshes additionally ride ``axis``
    # ("data"/"stage") and ``old_shape``/``new_shape`` ([D, S] lists) as
    # extras — no schema bump, extras are always legal — so a stage
    # re-partition is attributable; rendered by experiments/obs_report.py.
    "remesh": ("old_world", "new_world"),
    # Serving request lifecycle (serving/scheduler.py, schema v2). ``req``
    # is the request id threading all four together. Enqueue carries the
    # request shape (prompt_len/max_new); prefill marks admission into a
    # slot (queue_wait_s, blocks reserved + pool blocks_in_use); token is
    # per-token progress (index ``i``); done closes the request with the
    # latency summary (queue_wait_s, ttft_s, tokens_per_sec) obs_report
    # aggregates into p50/p95/p99.
    "request_enqueue": ("req",),
    "request_prefill": ("req", "slot"),
    "request_token": ("req", "i"),
    "request_done": ("req", "tokens"),
    # Fleet-scale FL (fl/fleet.py, schema v3). ``fl_cohort`` is one
    # compiled cohort dispatch: which tier/edge ran it, how many REAL
    # (non-padded) clients it carried, and their exact upload payload
    # bytes. ``fl_tier`` closes one tier's round: inputs reduced (clients
    # for the edge tier, edge aggregates for the server tier) and the
    # exact wire bytes that crossed into the tier, summed from leaf
    # shapes/dtypes (telemetry.comm.tree_bytes) — the accounting the
    # hierarchical-topology comparisons in PAPERS.md need.
    "fl_cohort": ("round", "tier", "cohort"),
    "fl_tier": ("round", "tier"),
    # Distributed tracing (telemetry/trace.py, schema v4). One event per
    # CLOSED span: ``trace_id`` groups a causal tree (one serving request,
    # one FL round, one training run), ``span_id``/``parent_span_id``
    # carry the tree structure explicitly (no thread-locals — contexts are
    # passed by hand, so nothing leaks into jit), ``start_ns``/``dur_ns``
    # are the tracer clock's monotonic nanoseconds. Extra fields are span
    # attributes. Rendered by obs_report's "traces" section; exported to
    # Perfetto/chrome://tracing by experiments/trace_export.py.
    "span": ("name", "trace_id", "span_id", "start_ns", "dur_ns"),
    # Live SLO monitoring (experiments/slo_monitor.py, schema v4): one
    # event per rolling-window violation — ``slo`` names the objective
    # (e.g. "ttft_p99_s"), ``value``/``threshold`` the measurement vs the
    # target, ``window_s`` the window it was measured over.
    "slo_violation": ("slo",),
    # Run-health numerics (telemetry/introspect.py, schema v5): one
    # in-jit sample per cadence boundary — ``it`` is the stream position,
    # extras carry ``grad_norm`` (global), ``groups`` (per-layer-group
    # grad/param norms + update/param ratio, worst-first), ``worst_group``
    # / ``worst_update_ratio``, and ``nonfinite_grads`` (leaf paths) when
    # a gradient went non-finite. Computed INSIDE the compiled step —
    # bitwise-free instrumentation, no extra dispatch.
    "numerics": ("it",),
    # Serving fleet (serving/fleet.py + serving/deploy.py, schema v6).
    # ``route`` is one dispatch decision: request ``req`` handed to engine
    # ``engine`` under ``policy`` ("least_loaded" / "predicted_ttft");
    # extras carry the decision inputs (per-engine outstanding counts,
    # predicted TTFT). ``deploy`` is one engine's weight hot-swap at a
    # token boundary: ``version`` names the publication (the trainer's
    # checkpoint step for train→deploy publishes), ``engine`` which engine
    # swapped; extras carry ``in_flight``/``queued`` (the streams that
    # crossed the swap without dropping) — obs_report renders both, and
    # the scheduler's ``deploy`` span puts the swap on the Perfetto
    # timeline.
    "route": ("req", "engine"),
    "deploy": ("version",),
    # Speculative decoding (serving/speculate.py + scheduler.py, schema
    # v7): one event per verify dispatch — ``proposed`` draft tokens this
    # round (k × active slots), ``accepted`` of them re-derived by the
    # target; extras carry ``rejected``, ``emitted`` (tokens the dispatch
    # DELIVERED: accepted + one correction/bonus per slot, minus any
    # window tail dropped after a mid-window EOS), ``k``, ``slots``
    # and ``engine``. acceptance = accepted/proposed; tokens-per-dispatch
    # = emitted per event (one verify dispatch each).
    "speculate": ("proposed", "accepted"),
    # Autoscaling (resilience/autoscale.py, schema v8): one event per
    # capacity move between training and serving — ``direction``
    # ("train_to_serve" / "serve_to_train"), ``train_world`` /
    # ``serve_engines`` the POST-transition allocation (the
    # replicas-over-time series obs_report plots); extras carry the
    # triggering ``signal`` (e.g. "ttft_pressure", "traffic_ebb"), the
    # measured value behind it, ``it`` (the training chunk edge the move
    # landed on) and ``seconds`` (the re-mesh cost, when training moved).
    "scale": ("direction", "train_world", "serve_engines"),
    # Memory observability (telemetry/memory.py MemoryMeter, schema v9):
    # one event per sample cadence — ``source`` names the sampling site
    # ("train" for a trainer chunk edge / step cadence, "serve" for a
    # scheduler tick, "fleet" for a fleet census, "host" for a bare RSS
    # trajectory point). Extras carry whatever the site can account:
    # ``rss_bytes`` (host), ``params_bytes``/``opt_state_bytes``/
    # ``mirror_bytes`` (training state via tree_bytes — host-side shape
    # math, never a device sync), ``pool_used_bytes``/
    # ``pool_capacity_bytes``/``blocks_in_use``/``holes``/``largest_run``
    # (KV pool occupancy + fragmentation from BlockAllocator), ``engine``
    # (fleet-scale), ``device_bytes`` (the per-device total the headroom
    # SLO judges against slo_monitor's ``--device-bytes`` budget), and
    # ``it``/``tick`` (stream position). Rendered by obs_report's
    # "memory" section; the flight recorder pins the last sample as the
    # postmortem memory census.
    "memory": ("source",),
    # Compile/retrace accounting (introspect.CompileWatch, schema v5):
    # one event per XLA compilation of a watched jit entry point —
    # ``name`` the factory label, ``seconds`` the compiling call's wall
    # time; extras carry ``cache_size``, ``retrace`` (True = the
    # factory's documented compile budget was exceeded), and
    # ``flops``/``bytes_accessed`` from costs.hlo_cost for attainment.
    "compile": ("name", "seconds"),
}


def default_run_id() -> str:
    return f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"


class EventLog:
    """Append-only JSONL event writer (thread-safe; crash-tolerant reads).

    >>> log = EventLog("/tmp/run/events.jsonl")
    >>> log.manifest(jax_version=None, platform="cuda")
    >>> log.step(it=10, loss=2.31, dt_s=0.4)
    """

    def __init__(self, path: str, run_id: Optional[str] = None, *,
                 heal: bool = True):
        self.path = path
        self.run_id = run_id or default_run_id()
        self._seq = 0
        self._lock = threading.Lock()
        # In-process taps on the emitted stream (the flight recorder's
        # feed — introspect.FlightRecorder.observe). Called AFTER the
        # write, outside the lock (an observer must be able to do IO of
        # its own without serializing emitters), each guarded: a broken
        # observer loses its tap, never the event or the run.
        self.observers: List[Any] = []
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # O_APPEND at the fd level: every write() lands at the current end
        # of file even if another process appended in between.
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self.write_errors = 0
        self._torn_tail = False  # our own partial write left file mid-line
        if not heal:
            # A SIDECAR writer (slo_monitor appending verdicts into a LIVE
            # stream) must be append-only: the heal below interprets a
            # missing final newline as a dead writer's fragment, but on a
            # live stream it is another process's in-flight line, and
            # truncating it would corrupt that writer's event mid-write.
            # If the file DOES end mid-line right now (a crashed
            # predecessor's fragment), seal it with a leading newline on
            # our first emit instead — worst case (the line completes in
            # between) readers skip one blank line.
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        self._torn_tail = f.read(1) != b"\n"
            except OSError:
                pass
            return
        # Heal a torn final line left by a crashed predecessor (a relaunch
        # reusing the same telemetry dir): without healing, this writer's
        # first event would merge into the fragment, turning an expected
        # crash artifact (readers drop a torn FINAL line) into mid-file
        # corruption (strict readers raise). Truncating to the last
        # newline discards exactly the bytes every reader would drop; the
        # write contract (whole lines in one write()) means a file not
        # ending in '\n' is a dead writer's fragment, not an in-flight
        # append. Writers taking OVER a dir heal; sidecars sharing a LIVE
        # stream pass heal=False (above).
        try:
            size = os.fstat(self._fd).st_size
            if size > 0:
                with open(path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        # Scan BACKWARDS in chunks for the last newline:
                        # the fragment is one partial line, but the log a
                        # long-lived dir accumulates can be huge — reading
                        # it all just to rfind would cost O(file) memory.
                        pos, keep, chunk = size, 0, 1 << 16
                        while pos > 0:
                            start = max(0, pos - chunk)
                            f.seek(start)
                            nl = f.read(pos - start).rfind(b"\n")
                            if nl != -1:
                                keep = start + nl + 1
                                break
                            pos = start
                        os.ftruncate(self._fd, keep)
        except OSError:
            pass

    def emit(self, type: str, **fields: Any) -> Dict[str, Any]:
        """Append one event; returns the record (as written, or as dropped).

        Never raises on IO failure: telemetry must not sink a trainer (same
        policy as ``Heartbeat.beat`` — a full disk kills the event, counted
        in ``write_errors``, not the run). Emitting after ``close()`` also
        just counts."""
        with self._lock:
            self._seq += 1
            record = {"schema": SCHEMA_VERSION, "run_id": self.run_id,
                      "seq": self._seq, "t": time.time(), "type": type}
            record.update(fields)
            data = b""
            wrote = 0
            try:
                # Sanitize + dumps inside the try: either can still raise
                # (non-string dict keys, circular structures) and that too
                # must count, not sink the trainer. allow_nan=False is the
                # backstop: json.dumps would otherwise emit NaN/Infinity
                # tokens — which Python's loads tolerates but strict JSON
                # consumers (jq, the CI artifact viewers) reject — for any
                # non-finite float _sanitize missed.
                record = _sanitize(record)
                line = json.dumps(record, separators=(",", ":"),
                                  allow_nan=False) + "\n"
                if self._fd is None:
                    raise OSError("EventLog is closed")
                data = line.encode()
                if self._torn_tail:
                    # A prior partial write left the file mid-line; a
                    # leading newline seals that fragment into ONE
                    # malformed line (skipped by non-strict readers)
                    # instead of letting this event merge into it and
                    # corrupt both.
                    data = b"\n" + data
                # os.write may write short (ENOSPC hit mid-line, or any
                # byte count on POSIX) — loop, tracking progress so a
                # failure mid-line is repairable (above).
                view = memoryview(data)
                while view:
                    n = os.write(self._fd, view)
                    wrote += n
                    view = view[n:]
                self._torn_tail = False
            except (OSError, TypeError, ValueError, RecursionError):
                self.write_errors += 1
                if wrote:   # 0 bytes = file unchanged, keep prior state
                    self._torn_tail = wrote < len(data)
        for obs in self.observers:
            try:
                obs(record)
            except Exception:
                pass       # an observer must never sink the emitter
        return record

    # Typed conveniences — thin, so the schema has one authoritative shape.
    def manifest(self, **fields) -> Dict[str, Any]:
        return self.emit("manifest", **fields)

    def step(self, *, it: int, **fields) -> Dict[str, Any]:
        return self.emit("step", it=it, **fields)

    def fault(self, *, counters: Dict[str, int], **fields) -> Dict[str, Any]:
        return self.emit("fault", counters=counters, **fields)

    def fl_round(self, *, round: int, **fields) -> Dict[str, Any]:
        return self.emit("fl_round", round=round, **fields)

    def run_end(self, *, steps: int, **fields) -> Dict[str, Any]:
        return self.emit("run_end", steps=steps, **fields)

    def remesh(self, *, old_world: int, new_world: int,
               **fields) -> Dict[str, Any]:
        return self.emit("remesh", old_world=old_world, new_world=new_world,
                         **fields)

    # Serving request lifecycle (schema v2; serving/scheduler.py emits).
    def request_enqueue(self, *, req: str, **fields) -> Dict[str, Any]:
        return self.emit("request_enqueue", req=req, **fields)

    def request_prefill(self, *, req: str, slot: int,
                        **fields) -> Dict[str, Any]:
        return self.emit("request_prefill", req=req, slot=slot, **fields)

    def request_token(self, *, req: str, i: int, **fields) -> Dict[str, Any]:
        return self.emit("request_token", req=req, i=i, **fields)

    def request_done(self, *, req: str, tokens: int,
                     **fields) -> Dict[str, Any]:
        return self.emit("request_done", req=req, tokens=tokens, **fields)

    # Fleet-scale FL (schema v3; fl/fleet.py emits).
    def fl_cohort(self, *, round: int, tier: str, cohort: int,
                  **fields) -> Dict[str, Any]:
        return self.emit("fl_cohort", round=round, tier=tier, cohort=cohort,
                         **fields)

    def fl_tier(self, *, round: int, tier: str, **fields) -> Dict[str, Any]:
        return self.emit("fl_tier", round=round, tier=tier, **fields)

    # Distributed tracing (schema v4; telemetry/trace.py's Tracer emits).
    def span(self, *, name: str, trace_id: str, span_id: str,
             start_ns: int, dur_ns: int, parent_span_id: Optional[str] = None,
             **fields) -> Dict[str, Any]:
        if parent_span_id is not None:
            fields["parent_span_id"] = parent_span_id
        return self.emit("span", name=name, trace_id=trace_id,
                         span_id=span_id, start_ns=start_ns, dur_ns=dur_ns,
                         **fields)

    # Live SLO monitoring (schema v4; experiments/slo_monitor.py emits).
    def slo_violation(self, *, slo: str, **fields) -> Dict[str, Any]:
        return self.emit("slo_violation", slo=slo, **fields)

    # Run-health introspection (schema v5; telemetry/introspect.py).
    def numerics(self, *, it: int, **fields) -> Dict[str, Any]:
        return self.emit("numerics", it=it, **fields)

    def compile(self, *, name: str, seconds: float,
                **fields) -> Dict[str, Any]:
        return self.emit("compile", name=name, seconds=seconds, **fields)

    # Memory observability (schema v9; telemetry/memory.py MemoryMeter).
    def memory(self, *, source: str, **fields) -> Dict[str, Any]:
        return self.emit("memory", source=source, **fields)

    # Serving fleet (schema v6; serving/fleet.py routes, serving/
    # scheduler.py swaps).
    def route(self, *, req: str, engine: int, **fields) -> Dict[str, Any]:
        return self.emit("route", req=req, engine=engine, **fields)

    # Autoscaling (schema v8; resilience/autoscale.py emits).
    def scale(self, *, direction: str, train_world: int, serve_engines: int,
              **fields) -> Dict[str, Any]:
        return self.emit("scale", direction=direction,
                         train_world=train_world,
                         serve_engines=serve_engines, **fields)

    def deploy(self, *, version, **fields) -> Dict[str, Any]:
        return self.emit("deploy", version=version, **fields)

    # Speculative decoding (schema v7; serving/scheduler.py emits one per
    # verify dispatch).
    def speculate(self, *, proposed: int, accepted: int,
                  **fields) -> Dict[str, Any]:
        return self.emit("speculate", proposed=proposed, accepted=accepted,
                         **fields)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _json_fallback(obj):
    """Last-resort serializer: numpy/torch scalars → Python, else str."""
    for attr in ("item",):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                pass
    return str(obj)


def _sanitize(obj):
    """Make ``obj`` strictly-JSON-serializable: numpy/torch scalars → Python
    (via ``_json_fallback``) and non-finite floats → their ``str()``
    ("nan"/"inf"/"-inf" stay visible in the stream instead of becoming
    invalid NaN/Infinity tokens). Dict keys are left alone — a non-string
    key is a caller bug that json.dumps reports (and ``emit`` counts)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return _sanitize(_json_fallback(obj))


def validate_event(event: Dict[str, Any]) -> List[str]:
    """Schema check; returns a list of problems (empty = valid).

    Base fields are required for every event; per-type required fields for
    the types this schema version knows. A FUTURE schema version is a
    problem (the reader can't promise to understand it), and the message
    NAMES the event type that carried it — "schema 5 is newer" alone left
    a v5-writer-vs-v4-reader failure opaque about which emitter was ahead.
    An unknown type is rejected only when its declared schema is at/below
    the reader's version (there the type set is closed, so it can only be
    a typo); a newer stream's genuinely-new types are covered — by name —
    by the future-schema problem instead.
    """
    problems = [f"missing field {f!r}" for f in _BASE_FIELDS
                if f not in event]
    schema = event.get("schema")
    etype = event.get("type")
    if isinstance(schema, int) and schema > SCHEMA_VERSION:
        problems.append(
            f"schema {schema} is newer than reader ({SCHEMA_VERSION}): "
            f"cannot validate event type {etype!r} — upgrade the reader "
            "or re-record at the reader's schema")
    elif etype is not None and etype not in EVENT_TYPES:
        problems.append(
            f"unknown event type {etype!r} for schema "
            f"{schema if isinstance(schema, int) else SCHEMA_VERSION} "
            f"(known: {', '.join(EVENT_TYPES)})")
    for f in _REQUIRED.get(etype, ()):
        if f not in event:
            problems.append(f"{etype}: missing field {f!r}")
    return problems


def read_events(path: str, *, strict: bool = False,
                types: Optional[tuple] = None) -> List[Dict[str, Any]]:
    """Parse a JSONL event stream, tolerating a torn final line.

    A crash mid-append can leave a partial LAST line; that one is dropped
    silently. A malformed line anywhere else is corruption and raises under
    ``strict``; otherwise it is skipped. ``types`` filters by event type.
    """
    events: List[Dict[str, Any]] = []
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    complete = raw.endswith(b"\n")
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            event = json.loads(line)
            if not isinstance(event, dict):
                # Valid JSON but not an event object (`null`, a number, a
                # list) — same corruption class as a parse failure; letting
                # it through would crash every consumer's `.get`.
                raise ValueError(f"non-object event: {line[:40]!r}")
        except ValueError:
            if i == len(lines) - 1 and not complete:
                continue                       # torn final line: expected
            if strict:
                raise
            continue
        if strict:
            problems = validate_event(event)
            if problems:
                raise ValueError(f"{path}:{i + 1}: {problems}")
        if types is None or event.get("type") in types:
            events.append(event)
    return events


def iter_runs(events: List[Dict[str, Any]]) -> Iterator[List[Dict[str, Any]]]:
    """Group a (possibly multi-run) event list into per-run_id sublists,
    preserving first-seen order."""
    by_run: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        by_run.setdefault(e.get("run_id", "?"), []).append(e)
    yield from by_run.values()
