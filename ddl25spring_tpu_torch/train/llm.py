"""End-to-end LLM training entry point: counterpart of the JAX package's
``train/llm.py`` (``train_llm_dp``, ``eval_llm``, ``LLMTrainReport``).

``train_llm_dp`` runs the data-parallel trainer: tokenizer → token stream
(each rank its own shard) → ``parallel.dp`` step over
``llama.forward_loss`` (gradient aggregation, per step or K steps per
dispatch; weight aggregation; ZeRO-1) → optimizer apply, with the JAX
loop's loss list, ``loss_sink``, ``log_every``, checkpoints with resume,
and throughput accounting (all ranks' tokens, timed after
``warmup_steps_excluded`` steps, on a host read of the loss). At
``TrainConfig.data > 1`` it runs as ``data`` processes joined by a gloo
group (``parallel.distributed``): a call from a plain process starts them
and returns rank 0's report; a call inside a group uses that group.

The resilience layer wraps the step as the JAX trainer does: the fault
plan innermost (``FaultPlan.wrap_step``), the ``StepGuard`` outermost
(``ResilienceConfig.injit_guard`` is the step's own ``guard_nonfinite``
instead); SIGTERM force-saves a checkpoint and returns
``report.preempted=True``. ``telemetry`` opens the run's stream (manifest
with the communication profile and the preflight, step events, heartbeat,
fault events with the guard's attribution, ``numerics`` events every
``TrainConfig.numerics_every`` steps, memory samples, dispatch spans and
a ``run_end`` metrics snapshot), written by rank 0 alone.
``TrainConfig.remat`` / ``LlamaConfig.remat`` rematerialize each block in
the backward. The compressed and overlapped gradient sync routes as the
JAX trainer's does (``parallel/compress.py``): ``overlap_microbatches >=
1`` takes the ring step (``wire`` fp32, bf16 or int8_ef; ``comm_buckets``;
ZeRO-1; K steps per dispatch), ``dcn > 1`` lays ``dcn·data`` ranks out as
islands and takes the two-level ring (``wire_dcn`` on the DCN tier), and a
compressed ``wire`` without microbatches takes the legacy per-step steps.
``ResilienceConfig.elastic`` runs the loop in elastic mode (``_run_loop``
with ``resilience/elastic.py``'s controller): a lost rank leaves the
process world, the survivors re-form it and reshard, returned capacity
grows it back, and ``scale_hook`` lets the autoscaler resize it. ``TrainConfig.seq`` raises
``NotImplementedError`` naming its ROADMAP.md entry; ``TrainConfig.model``
and ``psa`` are the tensor-parallel trainer's, which the JAX DP and PP
trainers do not read either. ``on_checkpoint`` is
the checkpoint publication hook of the train→deploy conveyor
(``serving/deploy.py``).

``train_llm_pp`` runs the pipeline(-and-data)-parallel trainer on the same
loop: ``data·stage`` stage processes (``parallel.pp``), each holding its
stage's leaves and reading its data row's stream, under the GPipe, 1F1B
or interleaved schedule; ``overlap_microbatches >= 1`` takes the DP×PP
ring drivers (``wire``, ``comm_buckets``, gradient or ZeRO-1), and elastic
mode re-meshes the (data, stage) grid: a data-row drop, else a stage
re-partition.

``train_llm_tp`` runs the tensor(-and-data)-parallel trainer on the same
loop: ``data·model`` ranks (``parallel.tp``), each holding its model
shard's slices and reading its data row's stream, with the PSA modes, the
K-step drivers and the DP×TP ring drivers; elastic mode re-meshes its
data rows.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..bench_utils import make_optimizer
from ..config import LlamaConfig, ResilienceConfig, TrainConfig
from ..data.tokens import TokenStream, shard_batches
from ..metrics import ResilienceStats
from ..models import llama
from ..ops.adam import fused_adam
from ..parallel import distributed as dist
from ..parallel import compress, dp, pp, tp
from ..resilience.faults import ReplicaLossError, ReplicaReturnSignal
from ..resilience.preemption import PreemptionHandler
from ..telemetry import introspect
from ..telemetry.trace import Spans, Tracer
from ..tokenizers import load_tokenizer
from ..tree import tree_copy, tree_leaves


@dataclass
class LLMTrainReport:
    losses: List[float] = field(default_factory=list)
    tokens_per_sec: float = 0.0
    steps: int = 0
    wall_time: float = 0.0
    # True if the loop left early on a SIGTERM force-save (calling again
    # resumes). ``start_step`` is the stream position losses[0] belongs to
    # (> 0 after a resume).
    preempted: bool = False
    start_step: int = 0
    resilience: ResilienceStats = field(default_factory=ResilienceStats)
    # Elastic mode (resilience/elastic.py): one dict per re-mesh
    # (``RemeshRecord.as_dict``), and the throughput of the final world
    # (0.0 when no re-mesh happened or too little ran after the last one).
    remeshes: List[dict] = field(default_factory=list)
    post_remesh_tokens_per_sec: float = 0.0


# TrainConfig fields the port's trainers do not run at a non-default value,
# with the ROADMAP.md entry that says where each runs instead.
_QUEUED = {
    # The JAX trainer builds a data-only mesh and ignores ``seq``; the port
    # refuses it rather than train without sequence parallelism.
    "seq": "no trainer runs sequence parallelism: its entry point is "
           "parallel.sp.make_sp_train_step (ROADMAP.md section C)",
}


def unsupported_train_fields(train_cfg: TrainConfig) -> List[str]:
    """Names of the fields of ``train_cfg`` this trainer does not run,
    each with its ROADMAP.md entry."""
    default = TrainConfig()
    return [f"{f.name}={getattr(train_cfg, f.name)!r} ({_QUEUED[f.name]})"
            for f in fields(TrainConfig) if f.name in _QUEUED
            and getattr(train_cfg, f.name) != getattr(default, f.name)]


def eval_llm(params, model_cfg: LlamaConfig, *, n_batches: int = 16,
             batch_size: int = 8, skip: int = 0, tokenizer=None,
             seed: int = 1, stream=None) -> dict:
    """Held-out evaluation on the parameters' device: mean next-token loss
    and perplexity over ``n_batches`` through the fused head. On the
    synthetic corpus a different ``seed`` is a disjoint corpus; for a
    file corpus pass ``skip`` past the training window. Returns
    ``{"loss", "perplexity", "n_tokens"}``."""
    tok = tokenizer or load_tokenizer()
    model_cfg = model_cfg.replace(vocab_size=tok.vocab_size)
    device = tree_leaves(llama.as_tree(params))[0].device
    if stream is None:
        stream = TokenStream(tok, batch_size, model_cfg.ctx_size, skip=skip,
                             seed=seed)
    stream = iter(stream)
    total = 0.0
    n_tokens = 0
    with torch.no_grad():
        for _ in range(n_batches):
            batch = torch.as_tensor(next(stream), dtype=torch.long,
                                    device=device)
            total += float(llama.forward_loss(params, batch, model_cfg))
            n_tokens += batch.shape[0] * (batch.shape[1] - 1)
    mean = total / n_batches
    return {"loss": mean, "perplexity": math.exp(min(mean, 30.0)),
            "n_tokens": n_tokens}


def _make_trainer_optimizer(train_cfg: TrainConfig):
    """TrainConfig.optimizer → optimizer: "adam" (the reference's optax
    Adam) is the same recurrence as "fused"; the rest go through
    ``bench_utils.make_optimizer`` ("fused", "pallas", "master")."""
    if train_cfg.optimizer == "adam":
        return fused_adam(train_cfg.lr)
    return make_optimizer(train_cfg.optimizer, train_cfg.lr)


def _setup_checkpoint(checkpoint_dir: Optional[str], state, iters: int,
                      log_fn: Callable[[str], None], *,
                      resilience: Optional[ResilienceConfig] = None,
                      stats: Optional[ResilienceStats] = None):
    """The resume preamble: open the checkpoint directory (with the
    resilience config's IO retry budget) and restore the newest step that
    verifies into ``state``'s layout (a corrupt newest step falls back to
    the one before, ``checkpoint.py``). Returns ``(ckpt, state,
    start_step, done)``; ``done`` means the checkpoint is already at or
    past ``iters``."""
    if checkpoint_dir is None:
        return None, state, 0, False
    from ..checkpoint import Checkpointer
    res = resilience or ResilienceConfig()
    ckpt = Checkpointer(checkpoint_dir, retry_attempts=res.retry_attempts,
                        retry_base_delay=res.retry_base_delay, stats=stats)
    start_step = 0
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        # The step that restored, not latest_step(): after a corrupt-step
        # fallback they differ, and resuming from the corrupt step's index
        # would skip data the weights never saw.
        start_step = int(ckpt.restored_step)
        if start_step != int(ckpt.latest_step()):
            log_fn(f"latest step {int(ckpt.latest_step())} unreadable; "
                   f"fell back to step {start_step}")
        log_fn(f"resumed from step {start_step}")
    if start_step >= iters:
        log_fn(f"checkpoint already at step {start_step} >= iters {iters}; "
               "nothing to train")
        ckpt.close()
        return ckpt, state, start_step, True
    return ckpt, state, start_step, False


def _emit_manifest(telemetry, *, measure: bool, model_cfg, train_cfg,
                   start_step: int, step_fn, state, n_data: int,
                   device: torch.device, steps_per_dispatch: int = 1,
                   preflight: Optional[dict] = None, trainer: str = "dp",
                   mesh: Optional[dict] = None,
                   overlap_microbatches: int = 1,
                   windowed: bool = False) -> None:
    """Open a telemetry run: one manifest event with the configuration,
    the step's communication profile (``telemetry.comm.measure_comm`` of
    one call of the unguarded step on a copy of the state and a batch of
    zeros) and the preflight. ``measure``: every rank of a group must run
    the probe, since its collectives are real; rank 0 alone (``telemetry``
    not None) emits. ``windowed``: the step takes ``[K, B, T]`` windows
    even at K = 1 (the elastic loop's)."""
    if not measure:
        return
    from ..telemetry import measure_comm
    comm_profile = None
    try:
        shape = (train_cfg.batch_size, train_cfg.seq_len)
        if steps_per_dispatch > 1 or windowed:
            shape = (steps_per_dispatch,) + shape
        batch = torch.zeros(shape, dtype=torch.long, device=device)
        # A copy: the step updates its state in place.
        profile = measure_comm(step_fn, tree_copy(state), batch)
        comm_profile = (profile.as_dict(
            steps_per_dispatch=steps_per_dispatch,
            overlap_microbatches=overlap_microbatches)
            if profile is not None else None)
    except Exception:
        pass                       # telemetry must never sink a trainer
    if telemetry is None:
        return
    platform = "gpu" if device.type == "cuda" else device.type
    mesh = mesh or {"data": n_data}
    telemetry.events.manifest(
        trainer=trainer, jax_version=None, torch_version=torch.__version__,
        platform=platform, n_devices=math.prod(mesh.values()),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        mesh=mesh,
        model_cfg=dataclasses.asdict(model_cfg),
        train_cfg=dataclasses.asdict(train_cfg),
        start_step=start_step, comm=comm_profile,
        peaks=introspect.platform_peaks(platform),
        **({} if preflight is None else {"preflight": preflight}))


def _fault_extra(step_fn) -> dict:
    """The StepGuard's trip attribution (the non-finite leaf paths of the
    rejected state) as extra ``fault``-event fields."""
    pop = getattr(step_fn, "pop_trip", None)
    trip = pop() if callable(pop) else None
    return {"attribution": trip} if trip else {}


def _notify_checkpoint(hook, step: int, state, log_fn) -> None:
    """Call the publication hook after a successful save with the step and
    the live state, so a serving fleet can take the weights while training
    goes on. A hook that raises loses that publication, never the run."""
    if hook is None:
        return
    try:
        hook(step, state)
    except Exception as e:
        log_fn(f"checkpoint publication hook at step {step} failed "
               f"({type(e).__name__}: {e}); continuing")


def _run_loop(step_fn, state, batches, train_cfg: TrainConfig,
              to_device: Callable, *, n_data: int, start_step: int, ckpt,
              checkpoint_every: int, loss_sink, sink_every: int,
              log_every: int, log_fn, warmup_steps_excluded: int,
              stats: ResilienceStats, steps_per_dispatch: int = 1,
              on_checkpoint=None, telemetry=None, numerics=None,
              numerics_every: int = 0, compile_watch=None,
              injit_guard: bool = False,
              memory_meter=None, controller=None,
              scale_hook=None) -> LLMTrainReport:
    """The training loop, the JAX ``_run_loop``'s. Iterations before
    ``start_step`` (a resume) only consume their batches, so the data order
    is an uninterrupted run's; step indices are stream positions, so a
    skipped or rolled-back step consumes its batch without learning from
    it and a checkpoint at step k always means "k batches consumed".

    Per step (``steps_per_dispatch`` 1): one step per batch; device losses
    are buffered and read to host floats at sink boundaries (every
    ``sink_every`` steps and at the end); the timer starts on a host read
    of the loss after ``warmup_steps_excluded`` steps; a checkpoint every
    ``checkpoint_every`` steps and one at the end.

    Windowed (K = ``steps_per_dispatch`` > 1, or elastic mode): chunks end
    on multiples of K (a resume from another step realigns with one
    shorter first chunk); each chunk's ``[k, B, T]`` window goes to the
    device in one copy, the next chunk's is staged on the host while the
    device runs this one, and the step returns the ``[k]`` losses; warmup,
    sink flushes, checkpoints, guard verdicts and fault indices fall on
    chunk edges.

    Elastic (``controller``, a ``resilience.elastic.ElasticController``;
    the JAX ``_run_elastic_loop``'s): the windowed loop even at K = 1.
    Every chunk edge feeds the controller's host mirror; a
    ``ReplicaLossError`` (``ReplicaReturnSignal``) out of a dispatch hands
    the world to ``ElasticController.recover`` (``grow``), and the loop
    swaps in the new world, state, step and stream. Step indices stay
    stream positions: a recovery that rewinds to position ``m`` truncates
    the loss record to ``m`` and re-trains from there on the new world's
    stream. ``scale_hook(it, world)`` is polled at every interior chunk
    edge on the world's rank 0 and its answer broadcast over the world; a
    target other than the current world re-meshes through
    ``ElasticController.resize``, replaying nothing. ``telemetry``,
    ``log_fn``, ``loss_sink`` and ``memory_meter`` are every rank's: the
    current world's rank 0 uses them (a loss can make another rank the
    writer). A rank that leaves the world waits
    (``ElasticController.wait_rejoin``), and a grow that takes it back
    hands it the loop's record so far; at the end every rank of the pool
    returns the final world's rank 0's report
    (``ElasticController.finish``). ``tokens_per_sec`` counts each world's
    tokens at its own width, the first chunk of each world untimed;
    ``post_remesh_tokens_per_sec`` times the final world after a re-mesh.
    With no fault the losses are bitwise the non-elastic loop's.

    SIGTERM (``PreemptionHandler``) is honoured at the next step or chunk
    boundary: a checkpoint is force-saved (with a checkpoint directory)
    and the report says ``preempted``. With ``telemetry``: a ``dispatch``
    span tree per sampled step, ``host_iter_s``, a heartbeat every step, a
    ``step`` event (and a memory sample) every ``telemetry.step_every``
    steps, a ``numerics`` event every ``numerics_every`` steps, a ``fault``
    event with the counter delta and the guard's attribution whenever a
    counter moves, and ``run_end`` with ``registry.snapshot()``.
    ``on_checkpoint(step, state)`` follows every save that succeeded."""
    report = LLMTrainReport(start_step=start_step, resilience=stats)
    injit_step0 = int(state.step) if injit_guard else None
    elastic = controller is not None
    spans = Spans()
    all_telemetry, all_log, all_sink = telemetry, log_fn, loss_sink
    tracer = None

    def _writers():
        # In elastic mode the current world's rank 0 writes, logs and
        # sinks; a re-mesh can hand these to another rank.
        nonlocal telemetry, log_fn, loss_sink, tracer
        if elastic:
            lead = controller.leader
            telemetry = all_telemetry if lead else None
            log_fn = all_log if lead else _quiet
            loss_sink = all_sink if lead else None
        tracer = Tracer(telemetry.events if telemetry is not None else None,
                        phases=spans,
                        prefix=controller.span_prefix if elastic else "")

    _writers()

    def _phase(name: str, parent, span_name: str):
        if parent is not None:
            return tracer.span(span_name, parent=parent.ctx, phase=name)
        return spans(name)

    tokens_per_step = n_data * train_cfg.batch_size * train_cfg.seq_len
    shape = (train_cfg.batch_size, train_cfg.seq_len)
    t_start = None
    excluded_steps = warmup_steps_excluded
    last_saved = -1
    pending = []   # (first step index, device loss or [k] losses)
    last_event_t = time.perf_counter()
    last_event_it = start_step - 1
    last_replay_beat = -math.inf
    prev_counters = report.resilience.as_dict()
    last_numerics_it = start_step - max(1, numerics_every)
    # Windowed: the tokens after the warmup sync, each world's at its
    # width; elastic: the current world's timer and tokens.
    timed_tokens = 0.0
    phase_t0, phase_tokens = None, 0.0

    def _emit_numerics(it, aux, index=None):
        nonlocal last_numerics_it
        if aux is None or telemetry is None or numerics is None \
                or last_numerics_it == it:
            return
        try:
            telemetry.events.numerics(
                it=it, **numerics.event_fields(aux, index=index))
        except Exception:
            pass                   # introspection must never sink the run
        last_numerics_it = it

    def _flush_losses():
        for it0, ls in pending:
            for j, v in enumerate(ls.reshape(-1).tolist()):
                i = it0 + j
                report.losses.append(v)
                if loss_sink is not None and (i % sink_every == 0
                                              or i == train_cfg.iters - 1):
                    loss_sink(i, v)
        pending.clear()

    def _checkpoint(at: int, parent) -> None:
        nonlocal last_saved
        try:
            # overwrite: after a corrupt-latest fallback resume the loop
            # re-treads step indices the dead lineage already wrote.
            with _phase("checkpoint", parent, "checkpoint"):
                ckpt.save(at, state, overwrite=True)
            last_saved = at
        except OSError as e:
            log_fn(f"periodic checkpoint at {at} failed after retries "
                   f"({type(e).__name__}: {e}); continuing")
            return
        _notify_checkpoint(on_checkpoint, at, state, log_fn)

    def _force_save(at: int) -> None:
        # A checkpoint of this run's lineage at ``at`` exists only if this
        # loop saved it or resumed from it; anything else on disk at ``at``
        # is a stale remnant the save must replace.
        if ckpt is not None and at not in (last_saved, start_step):
            ckpt.save(at, state, overwrite=True)
        report.preempted = True
        report.resilience.preemptions += 1
        log_fn(f"preempted at iter {at}: checkpoint "
               f"{'force-saved' if ckpt is not None else 'not saved'}"
               f"{'' if ckpt is not None else ' (no checkpoint dir)'}")

    def _beat_replay(it):
        nonlocal last_replay_beat
        if telemetry is not None:
            now = time.perf_counter()
            if now - last_replay_beat >= 0.5:
                telemetry.heartbeat.beat(step=it, phase="replay")
                last_replay_beat = now

    def _compute(droot, fn_args):
        n_compiles = (len(compile_watch.compiles)
                      if compile_watch is not None else 0)
        with _phase("dispatch", droot, "compute") as csp:
            out = step_fn(*fn_args)
            if (csp is not None and compile_watch is not None
                    and len(compile_watch.compiles) > n_compiles):
                csp.attrs["compiled"] = True
        return out

    def _after_dispatch(last_it, loss_for_event, naux, t_iter, extra,
                        index=None, force_event=False):
        """After a step or chunk: registry, heartbeat, step event and
        memory sample, numerics and fault event, on the writer. Every rank
        tracks the counters, so a new writer's (elastic) first fault event
        holds only what moved since the last one."""
        nonlocal last_event_t, last_event_it, prev_counters
        if telemetry is not None:
            telemetry.registry.observe("host_iter_s",
                                       time.perf_counter() - t_iter)
            telemetry.heartbeat.beat(step=last_it)
            if force_event:
                now = time.perf_counter()
                if t_start is None or (report.remeshes and phase_t0 is None):
                    extra = {**extra, "warmup": True}   # a world's first
                telemetry.events.step(it=last_it, loss=float(loss_for_event),
                                      dt_s=now - last_event_t,
                                      steps=last_it - last_event_it, **extra)
                last_event_t, last_event_it = now, last_it
                if memory_meter is not None:
                    memory_meter.sample(it=last_it, **(dict(
                        world=n_data, mirror_bytes=controller.mirror_bytes())
                        if elastic else {}))
            if naux is not None and \
                    last_it - last_numerics_it >= numerics_every:
                _emit_numerics(last_it, naux, index)
        delta = report.resilience.delta(prev_counters)
        if delta:
            if telemetry is not None:
                _emit_numerics(last_it, naux, index)
                telemetry.events.fault(counters=delta, it=last_it,
                                       **_fault_extra(step_fn))
            prev_counters = report.resilience.as_dict()

    preempt = PreemptionHandler()
    last_it = start_step - 1
    K = steps_per_dispatch
    present = True                  # elastic: this rank is in the world
    if K <= 1 and not elastic:
        with preempt:
            for it in range(train_cfg.iters):
                droot = (tracer.start("dispatch", trace="train", it=it,
                                      phase=False)
                         if (telemetry is not None and it >= start_step
                             and it % telemetry.step_every == 0) else None)
                with _phase("data", droot, "stage"):
                    host_batch = next(batches).reshape(shape)
                if it < start_step:
                    _beat_replay(it)
                    continue            # resume: replay the stream
                if preempt.requested:
                    if droot is not None:
                        droot.end(preempted=True)
                    _force_save(it)
                    break
                last_it = it
                t_iter = time.perf_counter()
                state, out = _compute(droot, (state, to_device(host_batch)))
                loss, naux = introspect.split_step_output(out)
                if it + 1 == start_step + warmup_steps_excluded:
                    float(loss)             # hard sync before the timer
                    t_start = time.perf_counter()
                    last_event_t, last_event_it = t_start, it
                pending.append((it, loss))
                if it % sink_every == 0 or it == train_cfg.iters - 1:
                    with _phase("sink", droot, "sink"):
                        _flush_losses()
                if log_every and it % log_every == 0:
                    log_fn(f"iter {it}: loss {float(loss):.4f}")
                if telemetry is not None:
                    _after_dispatch(
                        it, loss, naux, t_iter, {},
                        force_event=(it % telemetry.step_every == 0
                                     or it == train_cfg.iters - 1))
                if ckpt is not None and (it + 1) % checkpoint_every == 0:
                    _checkpoint(it + 1, droot)
                if droot is not None:
                    droot.end()
    else:
        K = max(1, K)

        def _window(it0, it1, parent=None):
            # Reads ``batches`` from the enclosing frame, so a re-mesh's
            # rebinding re-points it at the new world's stream.
            with _phase("data", parent, "stage"):
                return np.stack([next(batches).reshape(shape)
                                 for _ in range(it1 - it0)])

        staged = None               # (first step index, host window)
        edge = start_step
        last_flush_edge = start_step
        dispatch_idx = 0

        def _drain_pending():
            # Settle in-flight work as host copies: the old world's device
            # values must not be read after the world changes.
            pending[:] = [(i0, _host(ls)) for i0, ls in pending]

        def _loop_state() -> dict:
            """What a rank that joins in a grow takes over."""
            _drain_pending()
            return {"losses": list(report.losses),
                    "start_step": report.start_step,
                    "remeshes": list(report.remeshes),
                    "pending": list(pending), "last_saved": last_saved,
                    "dispatch_idx": dispatch_idx,
                    "last_flush_edge": last_flush_edge,
                    "t_start": t_start, "excluded_steps": excluded_steps,
                    "timed_tokens": timed_tokens,
                    "prev_counters": prev_counters}

        def _take_loop_state(st: dict) -> None:
            nonlocal last_saved, dispatch_idx, last_flush_edge, t_start, \
                excluded_steps, timed_tokens, prev_counters
            report.losses[:] = st["losses"]
            report.start_step = st["start_step"]
            report.remeshes[:] = st["remeshes"]
            pending[:] = st["pending"]
            last_saved, dispatch_idx = st["last_saved"], st["dispatch_idx"]
            last_flush_edge = st["last_flush_edge"]
            t_start, excluded_steps = st["t_start"], st["excluded_steps"]
            timed_tokens = st["timed_tokens"]
            prev_counters = st["prev_counters"]

        def _swap(resume):
            # Install a Resume's world: the fault paths and the resize
            # share it. The record truncates to the resume point ``m`` and
            # every cursor rewinds with it.
            nonlocal n_data, state, step_fn, to_device, batches, last_it, \
                last_flush_edge, last_event_t, last_event_it, phase_t0, \
                phase_tokens, staged, edge
            n_data = resume.n_data
            state, step_fn = resume.state, resume.step_fn
            to_device, batches = resume.window_shard_fn, resume.batches
            m = resume.step
            pending[:] = [p for p in pending if p[0] < m]
            del report.losses[max(0, m - report.start_step):]
            report.start_step = min(report.start_step, m)
            report.remeshes.append(resume.record.as_dict())
            last_it = m - 1
            last_flush_edge = min(last_flush_edge, m)
            last_event_t = time.perf_counter()
            last_event_it = m - 1
            phase_t0, phase_tokens = None, 0.0
            staged = None           # old width, old stream
            edge = m
            _writers()

        def _moved(resume) -> bool:
            """Go on in ``resume``'s world; a rank that left the world
            (None) waits outside it. False when the run ended while it
            waited; True when a grow took it back, its loop state
            installed."""
            if resume is None:
                got = controller.wait_rejoin()
                if got is None:
                    return False
                resume, st = got
                _take_loop_state(st)
            _swap(resume)
            return True

        with preempt:
            for rep in range(start_step):   # resume: replay the stream
                next(batches)
                _beat_replay(rep)
            if elastic:
                # Seed the mirror: a loss on the very first dispatch must
                # be recoverable without a checkpoint.
                controller.note_edge(start_step, state)
            while edge < train_cfg.iters:
                if preempt.requested:
                    _force_save(edge)
                    break
                it0, it1 = edge, min(train_cfg.iters, (edge // K + 1) * K)
                droot = (tracer.start("dispatch", trace="train", it=it0,
                                      steps=it1 - it0, phase=False)
                         if telemetry is not None else None)
                window = (staged[1] if staged is not None
                          and staged[0] == it0 else _window(it0, it1, droot))
                staged = None
                t_iter = time.perf_counter()
                this_dispatch, dispatch_idx = dispatch_idx, dispatch_idx + 1
                try:
                    state, out = _compute(droot, (state, to_device(window)))
                except (ReplicaLossError, ReplicaReturnSignal) as err:
                    if not elastic:
                        raise
                    grow = isinstance(err, ReplicaReturnSignal)
                    if droot is not None:
                        droot.end(**{"replica_return" if grow
                                     else "replica_loss": True})
                    with spans("recover"):
                        if grow:
                            resume = controller.grow(
                                err, failed_at=it0, dispatch=this_dispatch,
                                loop_state=_loop_state())
                        else:
                            _drain_pending()
                            resume = controller.recover(
                                err, failed_at=it0, dispatch=this_dispatch)
                    present = _moved(resume)
                    if not present:
                        break
                    continue
                losses, naux = introspect.split_step_output(out)
                tokens_per_step = (n_data * train_cfg.batch_size
                                   * train_cfg.seq_len)
                last_it = it1 - 1
                first_chunk = t_start is None
                pending.append((it0, losses))
                if it1 < train_cfg.iters:
                    # Stage the next window while the device runs this
                    # one; a re-mesh discards it (wrong width and stream).
                    nxt = min(train_cfg.iters, (it1 // K + 1) * K)
                    staged = (it1, _window(it1, nxt, droot))
                if log_every:
                    for i in range(it0, it1):
                        if i % log_every == 0:
                            log_fn(f"iter {i}: "
                                   f"loss {float(losses[i - it0]):.4f}")
                _after_dispatch(
                    last_it, losses[-1], naux, t_iter,
                    {"steps_per_dispatch": it1 - it0}, index=-1,
                    force_event=(telemetry is not None and (
                        last_it - last_event_it >= telemetry.step_every
                        or it1 == train_cfg.iters)))
                if first_chunk:
                    float(losses[-1])   # warmup quantized to the first chunk
                    t_start = time.perf_counter()
                    excluded_steps = it1 - it0
                    last_event_t, last_event_it = t_start, last_it
                    if not report.remeshes:
                        phase_t0 = t_start
                elif phase_t0 is None:
                    # The first chunk of a new world: its timer starts
                    # after it.
                    float(losses[-1])
                    phase_t0 = time.perf_counter()
                else:
                    timed_tokens += (it1 - it0) * tokens_per_step
                    phase_tokens += (it1 - it0) * tokens_per_step
                if elastic:
                    controller.note_edge(it1, state)   # last-good mirror
                if (it1 - last_flush_edge >= sink_every
                        or it1 == train_cfg.iters):
                    with _phase("sink", droot, "sink"):
                        _flush_losses()
                    last_flush_edge = it1
                if ckpt is not None and (it1 // checkpoint_every
                                         > it0 // checkpoint_every):
                    _checkpoint(it1, droot)
                if scale_hook is not None and it1 < train_cfg.iters:
                    # The capacity-change seam (resilience/autoscale.py):
                    # the world's rank 0 asks the hook, every rank hears
                    # the answer; a move re-meshes here, from this state.
                    target = dist.broadcast_object(
                        scale_hook(it1, n_data) if controller.leader
                        else None)
                    if target is not None and int(target) != n_data:
                        with spans("recover"):
                            _drain_pending()
                            resume = controller.resize(
                                int(target), state=state, at_step=it1,
                                dispatch=dispatch_idx - 1,
                                loop_state=(_loop_state() if int(target)
                                            > n_data else None))
                        if droot is not None:
                            droot.end(scaled=True)
                        present = _moved(resume)
                        if not present:
                            break
                        continue
                if droot is not None:
                    droot.end()
                edge = it1
    if not present:                 # the run ended outside the world
        return controller.finish(report)
    if ckpt is not None:
        if not report.preempted and train_cfg.iters != last_saved:
            ckpt.save(train_cfg.iters, state, overwrite=True)
            _notify_checkpoint(on_checkpoint, train_cfg.iters, state, log_fn)
        ckpt.close()
    _flush_losses()
    t_end = time.perf_counter()
    # report.start_step: an elastic recovery from the checkpoint may have
    # rewound the record's origin below the resumed-from step.
    report.steps = ((last_it + 1 if report.preempted else train_cfg.iters)
                    - report.start_step)
    if injit_step0 is not None:
        # Steps run minus step-counter advances: the fused guard's skips.
        good = int(state.step) - injit_step0
        report.resilience.skipped_steps += max(0, report.steps - good)
    if t_start is not None and report.steps > excluded_steps:
        report.wall_time = t_end - t_start
        if K <= 1 and not elastic:
            timed_tokens = tokens_per_step * (report.steps - excluded_steps)
        report.tokens_per_sec = timed_tokens / report.wall_time
    if report.remeshes and phase_t0 is not None and phase_tokens > 0:
        report.post_remesh_tokens_per_sec = (
            phase_tokens / max(t_end - phase_t0, 1e-9))
    if telemetry is not None:
        telemetry.registry.absorb_spans(spans)
        telemetry.registry.absorb_resilience(report.resilience)
        telemetry.events.run_end(
            steps=report.steps, start_step=report.start_step,
            preempted=report.preempted,
            tokens_per_sec=report.tokens_per_sec, wall_s=report.wall_time,
            metrics=telemetry.registry.snapshot(),
            **(dict(remeshes=len(report.remeshes),
                    post_remesh_tokens_per_sec=(
                        report.post_remesh_tokens_per_sec))
               if elastic else {}))
        telemetry.heartbeat.beat(step=last_it + 1, phase="done")
    return controller.finish(report) if elastic else report


def _host(losses):
    """Device losses as a host array (``pending``'s settled form)."""
    if isinstance(losses, torch.Tensor):
        return losses.detach().cpu().numpy()
    return np.asarray(losses)


def _apply_resilience(step_fn, resilience: Optional[ResilienceConfig],
                      fault_plan, ckpt, stats: ResilienceStats, *,
                      group=None, shared=None, leaf_map=None,
                      start: int = 0):
    """The resilience layer around a step: fault injection innermost (the
    guard sees the faulted step), the StepGuard outermost. ``fault_plan``
    comes as an object or through ``resilience.faults``; fault step
    indices are post-resume call indices, offset by ``start`` (the elastic
    loop re-wraps a step rebuilt mid-run at the absolute dispatch index,
    so faults already delivered never fire again; the guard starts
    fresh). A pipeline stage passes its
    stage ``group`` (the guard's verdict covers every stage) and its
    ``leaf_map`` (``pp.global_leaf_map``: fault targets are leaves of the
    whole model); a tensor-parallel shard its model ``group`` and the
    leaves it holds whole (``shared``)."""
    if fault_plan is None and resilience is not None and resilience.faults:
        fault_plan = resilience.fault_plan()
    if fault_plan:
        step_fn = fault_plan.wrap_step(step_fn, leaf_map=leaf_map,
                                       start=start)
    if resilience is not None and resilience.guard:
        from ..resilience.guard import StepGuard
        step_fn = StepGuard(
            step_fn, ckpt=ckpt, stats=stats,
            max_consecutive_bad=resilience.max_consecutive_bad,
            ema_decay=resilience.ema_decay,
            anomaly_factor=resilience.anomaly_factor,
            ema_warmup=resilience.ema_warmup, group=group, shared=shared)
    return step_fn


def _check_options(train_cfg: TrainConfig, aggregation: str,
                   resilience: Optional[ResilienceConfig],
                   scale_hook) -> None:
    """The ROADMAP.md entries of what the port does not run, then the JAX
    trainer's errors for what does not compose, in its order and with its
    texts (the ring step's wire checks included: ``compress.
    check_wire``), all before any rank starts."""
    queued = unsupported_train_fields(train_cfg)
    elastic = bool(resilience is not None and resilience.elastic)
    if queued:
        raise NotImplementedError(
            "train_llm_dp does not run these yet; see ROADMAP.md: "
            + "; ".join(queued))
    hier = train_cfg.dcn > 1
    if train_cfg.wire_dcn and not hier:
        raise ValueError(
            "wire_dcn selects the DCN tier of a hierarchical mesh; set "
            "TrainConfig.dcn > 1 (or pass a hier_data_mesh)")
    spd = train_cfg.steps_per_dispatch
    if spd < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1 (got {spd})")
    ovl = train_cfg.overlap_microbatches
    if ovl < 0:
        raise ValueError(f"overlap_microbatches must be >= 0 (got {ovl})")
    cb = train_cfg.comm_buckets
    if cb < 1:
        raise ValueError(f"comm_buckets must be >= 1 (got {cb})")
    if cb > 1 and ovl == 0:
        raise ValueError(
            "comm_buckets > 1 is a property of the overlap/ring driver "
            "(the bucketed backward splits each microbatch's ring) — set "
            f"overlap_microbatches >= 1 (got comm_buckets={cb} with "
            "overlap_microbatches=0)")
    if hier and ovl == 0:
        raise ValueError(
            "a hierarchical mesh (TrainConfig.dcn > 1 / wire_dcn) routes "
            "gradient sync through the two-level ring driver: set "
            "overlap_microbatches >= 1")
    wire = train_cfg.wire
    if train_cfg.numerics_every > 0:
        if aggregation not in ("gradient", "zero1"):
            raise ValueError("numerics_every requires gradient or zero1 "
                             f"aggregation (got {aggregation!r})")
        if ovl == 0 and wire != "fp32":
            raise ValueError(
                "numerics_every requires wire='fp32' on the legacy "
                "per-step compressed paths (they own their collective "
                "schedules) — overlap_microbatches >= 1 is the composing "
                "path")
        if elastic:
            raise ValueError("numerics_every does not compose with "
                             "elastic mode yet")
    if resilience is not None and resilience.injit_guard:
        if resilience.guard:
            raise ValueError(
                "injit_guard and guard are mutually exclusive skip "
                "mechanisms (the host StepGuard would double-count the "
                "fused skip); set ResilienceConfig(guard=False) to use "
                "the in-step guard")
        if elastic:
            raise ValueError("injit_guard does not compose with elastic "
                             "mode (the remesh path rebuilds its own "
                             "steps)")
        if aggregation not in ("gradient", "zero1"):
            raise ValueError("injit_guard requires gradient or zero1 "
                             f"aggregation (got {aggregation!r})")
        if ovl == 0 and wire != "fp32":
            raise ValueError(
                "injit_guard is not fused into the legacy per-step "
                "compressed paths — overlap_microbatches >= 1 is the "
                "composing path")
    if scale_hook is not None and not elastic:
        raise ValueError("scale_hook requires resilience.elastic=True — "
                         "capacity changes ride the elastic re-mesh "
                         "machinery")
    if elastic:
        if aggregation not in ("gradient", "zero1"):
            raise ValueError("elastic mode supports gradient and zero1 "
                             f"aggregation only (got {aggregation!r})")
        if wire != "fp32" and ovl == 0:
            raise ValueError(
                f"elastic=True composes with wire={wire!r} only "
                "through the overlap/ring driver, whose EF residual trees "
                "(OverlapEFState.ring_residual/gather_residual) the remesh "
                "path reshards N→M alongside the ZeRO-1 moments — the "
                "legacy per-step compressed paths own collective schedules "
                "nobody re-meshes. Set overlap_microbatches >= 1, or use "
                "wire='fp32'")
        if hier:
            raise ValueError("elastic mode supports data-axis-only meshes "
                             f"(got {{'dcn': {train_cfg.dcn}, 'data': "
                             f"{train_cfg.data}}})")
    if ovl >= 1:
        if aggregation not in ("gradient", "zero1"):
            raise ValueError("overlap_microbatches supports gradient and "
                             f"zero1 aggregation only (got {aggregation!r})")
        if train_cfg.accum_steps != 1:
            raise ValueError("overlap_microbatches replaces accum_steps "
                             "(both split the local batch axis); set "
                             "accum_steps=1")
        shape = ({"dcn": train_cfg.dcn, "data": train_cfg.data} if hier
                 else {"data": train_cfg.data})
        compress.check_wire(_wire_arg(train_cfg), aggregation, shape)
    elif wire != "fp32":
        if aggregation != "gradient" or train_cfg.accum_steps != 1 \
                or spd != 1:
            raise ValueError(
                "wire compression requires gradient aggregation without "
                "accumulation or multi-step dispatch (got "
                f"aggregation={aggregation!r}, "
                f"accum_steps={train_cfg.accum_steps}, "
                f"steps_per_dispatch={spd}) — overlap_microbatches >= 1 "
                "is the composing path")
        if wire not in ("bf16", "int8_ef"):
            raise ValueError(f"unknown wire format {wire!r}")
    elif aggregation == "zero1":
        if train_cfg.accum_steps != 1:
            raise ValueError("accum_steps composes with gradient aggregation "
                             "only (zero1 scatters the raw local gradient)")
    elif aggregation == "weight":
        if train_cfg.accum_steps != 1:
            raise ValueError("accum_steps needs gradient aggregation")
        if spd != 1:
            raise ValueError("steps_per_dispatch > 1 supports gradient and "
                             "zero1 aggregation only")
    elif aggregation != "gradient":
        raise ValueError(f"unknown aggregation {aggregation!r}: expected "
                         "'gradient', 'weight' or 'zero1'")


def _wire_arg(train_cfg: TrainConfig):
    """The ring step's ``wire``: the per-axis dict on a hierarchical
    layout (the island tier rides ``wire``, the DCN tier ``wire_dcn``,
    default fp32), else ``wire``."""
    if train_cfg.dcn > 1:
        return {"ici": train_cfg.wire, "dcn": train_cfg.wire_dcn or "fp32"}
    return train_cfg.wire


def _train_rank(model_cfg, train_cfg, kwargs: dict, *, device):
    """One rank of a ``train_llm_dp`` call that started its own ranks."""
    return train_llm_dp(model_cfg, train_cfg, device=device, **kwargs)


def _quiet(*_args) -> None:
    """The log of every rank but 0."""


def train_llm_dp(model_cfg: Optional[LlamaConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, *,
                 tokenizer=None,
                 aggregation: str = "gradient",
                 log_every: int = 100,
                 log_fn: Callable[[str], None] = print,
                 warmup_steps_excluded: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000,
                 loss_sink: Optional[Callable[[int, float], None]] = None,
                 sink_every: int = 10,
                 resilience: Optional[ResilienceConfig] = None,
                 fault_plan=None,
                 telemetry=None,
                 on_checkpoint=None,
                 scale_hook=None,
                 device=None) -> LLMTrainReport:
    """Train the tiny-Llama data-parallel over ``train_cfg.data`` ranks on
    ``device`` (default CUDA, rank r on ``cuda:(r % device_count)``;
    raises when no card is present); returns the losses (averaged over the
    ranks) and all ranks' throughput.

    ``aggregation``: "gradient" (per step, or ``steps_per_dispatch`` = K
    steps per window), "weight" (no ``accum_steps``, no K > 1) or "zero1"
    (no ``accum_steps``). ``overlap_microbatches`` = M >= 1 routes the
    gradient sync through the ring step (``compress.make_overlap_step``:
    ``wire`` fp32, bf16 or int8_ef, ``comm_buckets``, gradient or zero1,
    any K); a compressed ``wire`` at M = 0 takes the legacy per-step bf16
    or int8 steps (gradient aggregation, K = 1). ``dcn`` = D > 1 runs
    ``D·data`` ranks as D islands (``distributed.hier_data_mesh``) through
    the two-level ring, ``wire_dcn`` on the DCN tier (M >= 1 required).
    With no process group, a world above one starts its ranks
    (``distributed.run_ranks``) and returns rank 0's report;
    ``log_fn``, ``loss_sink``, ``on_checkpoint``, ``fault_plan`` and
    ``telemetry`` then travel to the ranks by pickling (a module-level
    function; a ``Telemetry`` reopens its files in rank 0). Inside a
    group, the group's size must be ``data``, and rank 0 alone logs,
    sinks and writes telemetry.

    The model's vocab is the tokenizer's (``load_tokenizer``: the
    SentencePiece model when one is found, else bytes, vocab 259). Rank
    i's batches are ``batch_size × seq_len`` windows of shard i's stream
    (``shard_batches``, skip i·5000: the JAX trainer's data order), weights
    come from ``llama.init_llama`` seeded ``train_cfg.seed`` (the same on
    every rank), ``accum_steps`` splits each batch into microbatches.
    ``train_cfg.remat`` (or ``model_cfg.remat``) rematerializes each block
    in the backward.

    ``checkpoint_dir``: restore the newest valid step there and skip the
    iterations it covers, save every ``checkpoint_every`` steps and at the
    end. ``loss_sink(it, loss)`` fires every ``sink_every`` iterations
    (and at the last) with the host loss. ``on_checkpoint(step, state)``
    runs after every successful save (periodic and final; on every rank of
    a group), e.g. ``serving.CheckpointPublisher``; a hook that raises is
    logged and training goes on.

    ``resilience`` (``config.ResilienceConfig``) wraps the step in a
    ``StepGuard`` (skip non-finite steps, EMA spike detection, rollback
    after K consecutive bad steps) and carries the checkpoint IO retry
    budget; ``injit_guard`` uses the step's own non-finite skip instead.
    ``fault_plan`` (``resilience.FaultPlan``) injects deterministic faults;
    counters come back in ``report.resilience``. SIGTERM force-saves and
    returns ``report.preempted=True``; calling again resumes.
    ``telemetry`` (``telemetry.Telemetry``) writes the run's event stream
    and heartbeat (``_run_loop``); ``TrainConfig.numerics_every`` adds
    ``numerics`` events. The ``TrainConfig`` fields
    ``unsupported_train_fields`` names raise ``NotImplementedError``
    naming ROADMAP.md.

    ``resilience.elastic=True`` (gradient or zero1 aggregation; a
    compressed ``wire`` through the ring step) survives the loss of ranks:
    a ``device_loss`` fault (or any ``ReplicaLossError``) at dispatch k
    drains the loop at the chunk edge, the survivors re-form the process
    world, reshard the parameters, the ZeRO-1 moments and the ring's
    residuals to the new world (host mirror, or checkpoint), re-split the
    stream and resume; a ``device_return`` fault grows the world back.
    Records land in ``report.remeshes`` and ``remesh`` events. The ranks
    must be this call's own (called outside a group) or the whole pool of
    a ``distributed.run_ranks`` launch; every rank returns the final
    world's rank 0's report. ``scale_hook(it, world)`` (elastic only) is
    polled at every interior chunk edge on the world's rank 0; a target
    world other than the current one re-meshes there through
    ``ElasticController.resize``, with nothing replayed. It must pickle
    (a module-level function or an instance of a module-level class) when
    the call starts its own ranks."""
    train_cfg = train_cfg or TrainConfig()
    _check_options(train_cfg, aggregation, resilience, scale_hook)
    hier = train_cfg.dcn > 1
    n_dcn = train_cfg.dcn if hier else 1
    world = train_cfg.data * n_dcn
    if world > 1 and not dist.is_initialized():
        kwargs = dict(tokenizer=tokenizer, aggregation=aggregation,
                      log_every=log_every, log_fn=log_fn,
                      warmup_steps_excluded=warmup_steps_excluded,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, loss_sink=loss_sink,
                      sink_every=sink_every, resilience=resilience,
                      fault_plan=fault_plan, telemetry=telemetry,
                      on_checkpoint=on_checkpoint, scale_hook=scale_hook)
        return dist.run_ranks(_train_rank, world, model_cfg,
                              train_cfg, kwargs, device=device)[0]
    n_data = dist.world_size()
    if n_data != world:
        raise ValueError(f"TrainConfig.data={train_cfg.data}"
                         + (f" x dcn={train_cfg.dcn}" if hier else "")
                         + f" but the process group has {n_data} ranks")
    elastic = bool(resilience is not None and resilience.elastic)
    pool = dist.pool()
    if elastic and n_data > 1 and (pool is None or pool.members != tuple(
            range(pool.size))):
        raise ValueError(
            "elastic mode re-forms the process world over the pool of one "
            "distributed.run_ranks launch and must start with the whole "
            "pool as its world (train_llm_dp starts the pool itself when "
            "called outside a process group)")
    mesh = dist.hier_data_mesh(n_dcn, train_cfg.data) if hier else None
    dev = dist.rank_device(device)
    rank = dist.get_rank()
    measure = telemetry is not None     # every rank runs the comm probe
    # The elastic loop hands the writers to whichever rank is the world's
    # rank 0; elsewhere rank 0 alone writes.
    run_log, run_sink, run_tel = log_fn, loss_sink, telemetry
    if rank != 0:
        log_fn, loss_sink, telemetry = _quiet, None, None
    tok = tokenizer or load_tokenizer()
    model_cfg = (model_cfg or LlamaConfig()).replace(
        vocab_size=tok.vocab_size)
    if train_cfg.remat:
        model_cfg = model_cfg.replace(remat=True)
    model = llama.init_llama(model_cfg,
                             torch.Generator().manual_seed(train_cfg.seed),
                             device=dev)
    optimizer = _make_trainer_optimizer(train_cfg)

    def loss_fn(p, batch):
        return llama.forward_loss(p, batch, model_cfg)

    params = model.tree()
    spd = train_cfg.steps_per_dispatch
    ovl = train_cfg.overlap_microbatches
    cb = train_cfg.comm_buckets
    wire = train_cfg.wire
    injit = bool(resilience is not None and resilience.injit_guard)
    numerics = (introspect.make_summarizer(
        params, psum_axis="data" if (ovl or aggregation == "zero1")
        else None) if train_cfg.numerics_every > 0 else None)
    state = None

    def _build_elastic(m):
        """(template state, raw window step, window placement) over the
        current process world: the first build and every re-mesh's go
        through here, so they cannot drift."""
        if ovl >= 1:
            st, fn = compress.make_overlap_multi_step(
                loss_fn, optimizer, params, microbatches=ovl, wire=wire,
                aggregation=aggregation, comm_buckets=cb, device=dev)
        elif aggregation == "zero1":
            st, fn = dp.make_zero1_multi_step(loss_fn, optimizer, params)
        else:
            fn = dp.make_multi_step(loss_fn, optimizer,
                                    accum_steps=train_cfg.accum_steps)
            st = dp.init_state(params, optimizer)
        # Each (re)build has its own compile watch, named by its world.
        tel = run_tel if dist.get_rank() == 0 else None
        fn = introspect.watch(
            fn, name=f"train/dp-{aggregation}-elastic"
                     + (f"-ring{wire}-m{ovl}" if ovl else "")
                     + (f"-b{cb}" if cb > 1 else "")
                     + f"-w{m.devices.size}",
            max_caches=None,
            events=(tel.events if tel is not None else None),
            meta={"steps_per_dispatch": spd},
            meta_fn=lambda st, w: {"steps_per_dispatch": int(w.shape[0])})
        return st, fn, (lambda w: torch.as_tensor(w, dtype=torch.long,
                                                  device=dev))

    if elastic:
        from ..parallel.mesh import data_mesh
        mesh0 = data_mesh(pool.members if pool is not None else (0,))
        state, step_fn, window_shard = _build_elastic(mesh0)
    elif ovl >= 1:
        make = (compress.make_overlap_multi_step if spd > 1
                else compress.make_overlap_step)
        state, step_fn = make(loss_fn, optimizer, params, mesh=mesh,
                              microbatches=ovl, wire=_wire_arg(train_cfg),
                              aggregation=aggregation, comm_buckets=cb,
                              guard_nonfinite=injit, numerics=numerics,
                              device=dev)
    elif wire == "bf16":
        step_fn = compress.make_bf16_grad_step(loss_fn, optimizer)
    elif wire == "int8_ef":
        state = compress.init_ef_state(params, optimizer)
        step_fn = compress.make_int8_ef_grad_step(loss_fn, optimizer)
    elif aggregation == "zero1":
        make = dp.make_zero1_multi_step if spd > 1 else dp.make_zero1_step
        state, step_fn = make(loss_fn, optimizer, params,
                              guard_nonfinite=injit, numerics=numerics)
    elif aggregation == "weight":
        step_fn = dp.make_weight_aggregation_step(loss_fn, optimizer)
    else:
        make = (dp.make_multi_step if spd > 1
                else dp.make_grad_aggregation_step)
        step_fn = make(loss_fn, optimizer,
                       accum_steps=train_cfg.accum_steps,
                       guard_nonfinite=injit, numerics=numerics)
    if state is None:
        state = dp.init_state(params, optimizer)
    # Each new call signature of the step is a ``compile`` record: one per
    # run per step (a tail window's shape adds one under K > 1). The name
    # carries the JAX trainer's suffixes. (The elastic build watches its
    # own step.)
    if not elastic:
        step_fn = introspect.watch(
            step_fn, name=f"train/dp-{aggregation}"
                          + (f"-k{spd}" if spd > 1 else "")
                          + ((f"-hier{n_dcn}x{train_cfg.data}"
                              f"-{wire}/{train_cfg.wire_dcn or 'fp32'}"
                              f"-m{ovl}") if hier else
                             (f"-ring{wire}-m{ovl}" if ovl else ""))
                          + (f"-b{cb}" if cb > 1 else ""),
            max_caches=(1 if spd == 1 else None),
            events=(telemetry.events if telemetry is not None else None),
            meta={"steps_per_dispatch": spd},
            meta_fn=(None if spd == 1 else
                     (lambda st, w: {"steps_per_dispatch":
                                     int(w.shape[0])})))
    compile_watch = step_fn
    stats = ResilienceStats()
    ckpt, state, start_step, done = _setup_checkpoint(
        checkpoint_dir, state, train_cfg.iters, log_fn,
        resilience=resilience, stats=stats)
    if done:
        return LLMTrainReport(start_step=start_step, resilience=stats)
    pre = memory_meter = None
    meter_tel = run_tel if elastic else telemetry
    if meter_tel is not None:
        from ..telemetry import memory as memlib
        pre = memlib.preflight(model_cfg, train_cfg, n_data=n_data,
                               aggregation=aggregation, optimizer=optimizer)
        memory_meter = memlib.MemoryMeter(meter_tel.events, source="train",
                                          device=dev)
        if pre is not None:
            memory_meter.note(params_bytes=pre["params_bytes"],
                              opt_state_bytes=pre["opt_state_bytes"],
                              residual_bytes=pre["residual_bytes"] or None,
                              window_bytes=pre["window_bytes"] or None)
    _emit_manifest(telemetry, measure=measure, model_cfg=model_cfg,
                   train_cfg=train_cfg, start_step=start_step,
                   step_fn=compile_watch._fn, state=state, n_data=n_data,
                   device=dev, steps_per_dispatch=spd, preflight=pre,
                   mesh=(mesh.shape if hier else None),
                   overlap_microbatches=max(1, ovl), windowed=elastic)
    if elastic:
        from ..resilience.elastic import ElasticController
        if fault_plan is None and resilience.faults:
            # Resolved once: every rebuild re-wraps the same schedule.
            fault_plan = resilience.fault_plan()

        def _make_batches(n):
            # This rank's shard at the new width (the reference's
            # skip=rank·5000): a fresh n-rank run's data order.
            return shard_batches(tok, train_cfg.batch_size,
                                 train_cfg.seq_len, dist.get_rank(),
                                 shard_skip=5000, seed=train_cfg.seed)

        def _rewrap(fn, start=0):
            return _apply_resilience(fn, resilience, fault_plan, ckpt,
                                     stats, start=start)

        controller = ElasticController(
            mesh0, build=_build_elastic, rewrap=_rewrap,
            make_batches=_make_batches, ckpt=ckpt,
            mirror_every=resilience.mirror_every, stats=stats,
            telemetry=run_tel, log_fn=run_log, device=dev)
        return _run_loop(
            _rewrap(step_fn), state, _make_batches(n_data), train_cfg,
            window_shard, n_data=n_data, start_step=start_step, ckpt=ckpt,
            checkpoint_every=checkpoint_every, loss_sink=run_sink,
            sink_every=sink_every, log_every=log_every, log_fn=run_log,
            warmup_steps_excluded=warmup_steps_excluded, stats=stats,
            steps_per_dispatch=spd, on_checkpoint=on_checkpoint,
            telemetry=run_tel, memory_meter=memory_meter,
            controller=controller, scale_hook=scale_hook)
    step_fn = _apply_resilience(step_fn, resilience, fault_plan, ckpt, stats)
    batches = shard_batches(tok, train_cfg.batch_size, train_cfg.seq_len,
                            rank, shard_skip=5000, seed=train_cfg.seed)
    return _run_loop(
        step_fn, state, batches, train_cfg,
        lambda b: torch.as_tensor(b, dtype=torch.long, device=dev),
        n_data=n_data, start_step=start_step, ckpt=ckpt,
        checkpoint_every=checkpoint_every, loss_sink=loss_sink,
        sink_every=sink_every, log_every=log_every, log_fn=log_fn,
        warmup_steps_excluded=warmup_steps_excluded, stats=stats,
        steps_per_dispatch=spd, on_checkpoint=on_checkpoint,
        telemetry=telemetry, numerics=numerics,
        numerics_every=train_cfg.numerics_every,
        compile_watch=compile_watch, injit_guard=injit,
        memory_meter=memory_meter)


def _check_pp_options(train_cfg: TrainConfig, aggregation: str,
                      schedule: str, resilience: Optional[ResilienceConfig],
                      scale_hook) -> None:
    """The JAX ``train_llm_pp``'s errors, in its order and with its texts,
    before any rank starts."""
    spd = train_cfg.steps_per_dispatch
    ovl = train_cfg.overlap_microbatches
    cb = train_cfg.comm_buckets
    if spd < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1 (got {spd})")
    if ovl < 0:
        raise ValueError(f"overlap_microbatches must be >= 0 (got {ovl})")
    if cb < 1:
        raise ValueError(f"comm_buckets must be >= 1 (got {cb})")
    if cb > 1 and ovl == 0:
        raise ValueError(
            "comm_buckets > 1 is a property of the overlap/ring driver "
            "(the bucketed backward splits each microbatch's ring) — set "
            f"overlap_microbatches >= 1 (got comm_buckets={cb} with "
            "overlap_microbatches=0)")
    if train_cfg.dcn != 1 or train_cfg.wire_dcn:
        raise ValueError("hierarchical DP (TrainConfig.dcn / wire_dcn) is "
                         "DP-trainer-only; the pipeline mesh has no "
                         "two-level data tier")
    if train_cfg.accum_steps != 1:
        raise ValueError("accum_steps (DP gradient accumulation) is "
                         "DP-trainer-only: the pipeline schedule owns its "
                         "microbatching — raise TrainConfig.microbatches "
                         "instead")
    if aggregation not in ("gradient", "zero1"):
        raise ValueError(f"unknown aggregation {aggregation!r}: the PP "
                         "trainer supports 'gradient' and 'zero1'")
    if train_cfg.wire != "fp32" and ovl == 0:
        raise ValueError(
            "wire compression on the PP trainer routes through the DP×PP "
            "ring driver: set overlap_microbatches >= 1 "
            f"(got wire={train_cfg.wire!r} with overlap_microbatches=0)")
    if aggregation == "zero1" and ovl == 0:
        raise ValueError(
            "PP zero1 routes the data-axis sync through the ring driver: "
            "set overlap_microbatches >= 1")
    elastic = bool(resilience is not None and resilience.elastic)
    if elastic and schedule == "interleaved":
        raise ValueError(
            "elastic mode does not compose with schedule='interleaved': a "
            "stage re-partition re-slices the blocked [n_layers/S] stage "
            "shards, and the interleaved chunk-major layer order breaks "
            "that contiguity — use schedule='gpipe' or '1f1b'")
    if elastic and train_cfg.numerics_every > 0:
        raise ValueError("numerics_every does not compose with elastic "
                         "mode yet")
    if scale_hook is not None and not elastic:
        raise ValueError("scale_hook requires resilience.elastic=True — "
                         "capacity changes ride the elastic re-mesh "
                         "machinery")
    if resilience is not None and resilience.injit_guard:
        raise ValueError("injit_guard is not fused into the pipeline step "
                         "bodies — use the host StepGuard "
                         "(ResilienceConfig.guard), which works at "
                         "dispatch granularity under steps_per_dispatch")


def _pp_mesh_shape(mesh, train_cfg: TrainConfig) -> Dict[str, int]:
    """``train_llm_pp``'s ``mesh=``: a dict of axis sizes (JAX's ``mesh``
    object's ``shape``); default ``{"data": train_cfg.data, "stage":
    train_cfg.stage}``, as the JAX trainer builds it. Returns ``data``,
    ``stage`` and ``model`` (1 when absent)."""
    shape = dict(mesh) if mesh is not None else {"data": train_cfg.data,
                                                 "stage": train_cfg.stage}
    for name, size in shape.items():
        if name not in ("data", "stage", "model") and int(size) > 1:
            raise ValueError(f"train_llm_pp runs a (data, stage, model) "
                             f"mesh; axis {name!r} has size {size}")
    if "stage" not in shape:
        raise ValueError(f"train_llm_pp needs a 'stage' axis in mesh= "
                         f"(got {shape})")
    return {"data": int(shape.get("data", 1)), "stage": int(shape["stage"]),
            "model": int(shape.get("model", 1))}


def _train_pp_rank(model_cfg, train_cfg, kwargs: dict, *, device):
    """One rank of a ``train_llm_pp`` call that started its own ranks."""
    return train_llm_pp(model_cfg, train_cfg, device=device, **kwargs)


def train_llm_pp(model_cfg: Optional[LlamaConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, *,
                 mesh=None,
                 tokenizer=None,
                 schedule: str = "gpipe",
                 aggregation: str = "gradient",
                 log_every: int = 100,
                 log_fn: Callable[[str], None] = print,
                 warmup_steps_excluded: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000,
                 loss_sink: Optional[Callable[[int, float], None]] = None,
                 sink_every: int = 10,
                 resilience: Optional[ResilienceConfig] = None,
                 fault_plan=None,
                 scale_hook=None,
                 on_checkpoint=None,
                 telemetry=None,
                 device=None) -> LLMTrainReport:
    """Train the tiny-Llama pipeline(-and-data)-parallel on ``device``
    (default CUDA; raises when no card is present): the reference's
    3-stage microbatched run (homework 1b, ``stage=3``) and its
    2-pipeline × 3-stage topology (``data=2, stage=3``).
    ``train_cfg.stage`` / ``data`` / ``microbatches`` pick the topology,
    ``schedule`` the pipeline schedule ("gpipe", "1f1b", "interleaved" at
    two chunks per stage; ``parallel.pp``). Each stage is one process:
    with no process group, ``data·stage`` ranks start
    (``distributed.run_ranks``) and rank 0's report comes back, as in
    ``train_llm_dp``; inside a group its size must be ``data·stage``.

    Every rank initializes the whole model from ``train_cfg.seed`` (the
    DP trainer's weights), keeps its stage's leaves and optimizer state,
    and reads its data row's stream itself (``shard_batches``, skip
    d·5000: the JAX trainer's data order), so tokens never travel. The
    loss is broadcast over the stages, so rank 0 (stage 0) logs, sinks
    and writes telemetry (manifest ``trainer="pp"``). The loop is
    ``train_llm_dp``'s: ``steps_per_dispatch`` = K windows, checkpoints
    (rank 0 writes the merged JAX-layout state; each rank re-slices its
    stage on resume), the guard (its verdict summed over the stages),
    faults (targets are leaves of the whole model), preemption,
    ``numerics_every`` (stage-qualified groups, ``pp.make_pp_numerics``)
    and ``remat``.

    ``overlap_microbatches`` = M >= 1 routes the data-axis gradient sync
    through the DP×PP ring drivers (``pp.make_pipeline_overlap_step`` /
    ``_multi_step``: ``wire`` fp32, bf16 or int8_ef, ``comm_buckets``,
    ``aggregation`` "gradient" or "zero1"), as the JAX trainer routes it;
    ZeRO-1 and a compressed ``wire`` need it.

    ``mesh``: JAX's keyword, as a dict of axis sizes (default ``{"data":
    train_cfg.data, "stage": train_cfg.stage}``). A ``model`` axis runs
    Megatron tensor parallelism inside each stage (``pipeline_mesh(D, S,
    T)``, ``D·S·T`` ranks), on every route above, checkpoints and resume
    included; ``numerics_every > 0`` and elastic mode refuse it with
    JAX's texts (``pp.make_pp_numerics``, ``mesh.survivor_submesh``; the
    JAX trainer meets the second at its first loss, the port before any
    rank starts).

    ``resilience.elastic=True`` (GPipe or 1F1B) survives the loss of
    stage processes: the ``(data, stage)`` grid drops the victims' data
    rows when a complete row survives, else re-partitions the layers over
    the survivors (the largest stage count that divides ``n_layers``);
    the survivors re-form the process world, each builds its new stage,
    re-slices the state from the host mirror (or the checkpoint) and
    replays its data row's stream; ``device_return`` grows the grid back
    to its original shape, and ``scale_hook`` resizes its data rows. The
    run must start on the first ``data·stage`` ranks of one
    ``distributed.run_ranks`` launch (the trainer starts them itself when
    called outside a group).

    Refused as the JAX trainer refuses them (``ValueError``, its texts):
    ``dcn`` / ``wire_dcn``, ``accum_steps``, ``injit_guard``, elastic mode
    with the interleaved schedule or ``numerics_every``, and the other
    option checks of ``_check_pp_options``."""
    train_cfg = train_cfg or TrainConfig()
    _check_pp_options(train_cfg, aggregation, schedule, resilience,
                      scale_hook)
    shape = _pp_mesh_shape(mesh, train_cfg)
    n_data, n_stage, n_model = shape["data"], shape["stage"], shape["model"]
    elastic = bool(resilience is not None and resilience.elastic)
    if n_model > 1:
        if train_cfg.numerics_every > 0:
            raise ValueError(pp.NUMERICS_MODEL_AXIS)
        if elastic:
            from ..parallel.mesh import PoolMesh, _elastic_second_axis
            _elastic_second_axis(PoolMesh(np.arange(
                n_data * n_stage * n_model).reshape(
                    n_data, n_stage, n_model), ("data", "stage", "model")),
                "survivor_submesh")
    world = n_data * n_stage * n_model
    if world > 1 and not dist.is_initialized():
        kwargs = dict(mesh=shape, tokenizer=tokenizer, schedule=schedule,
                      aggregation=aggregation, log_every=log_every,
                      log_fn=log_fn,
                      warmup_steps_excluded=warmup_steps_excluded,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, loss_sink=loss_sink,
                      sink_every=sink_every, resilience=resilience,
                      fault_plan=fault_plan, telemetry=telemetry,
                      on_checkpoint=on_checkpoint, scale_hook=scale_hook)
        return dist.run_ranks(_train_pp_rank, world, model_cfg, train_cfg,
                              kwargs, device=device)[0]
    pool = _elastic_pool(world) if elastic else None
    dev = dist.rank_device(device)
    mesh = dist.pipeline_mesh(n_data, n_stage, n_model)
    measure = telemetry is not None     # every rank runs the comm probe
    run_log, run_sink, run_tel = log_fn, loss_sink, telemetry
    if dist.get_rank() != 0:
        log_fn, loss_sink, telemetry = _quiet, None, None
    tok = tokenizer or load_tokenizer()
    model_cfg = (model_cfg or LlamaConfig()).replace(
        vocab_size=tok.vocab_size)
    if train_cfg.remat:
        model_cfg = model_cfg.replace(remat=True)
    params = llama.init_llama(model_cfg,
                              torch.Generator().manual_seed(train_cfg.seed),
                              device="cpu").tree()
    optimizer = _make_trainer_optimizer(train_cfg)
    if schedule == "interleaved":
        params = pp.interleave_params(params, mesh.stage, n_chunks=2)
    spd = train_cfg.steps_per_dispatch
    ovl = train_cfg.overlap_microbatches
    cb = train_cfg.comm_buckets
    wire = train_cfg.wire
    numerics = (pp.make_pp_numerics(params, mesh, psum_data=ovl >= 1)
                if train_cfg.numerics_every > 0 else None)
    ring = dict(n_microbatches=train_cfg.microbatches, schedule=schedule,
                aggregation=aggregation, wire=wire,
                overlap_microbatches=ovl, comm_buckets=cb, device=dev)
    # The current world's layout and stage state (an elastic re-mesh
    # replaces both).
    cur = {"mesh": mesh, "state": None}

    def _build_elastic(m):
        """(template state, raw window step, window placement) on the
        ``(data, stage)`` grid ``m``: the first build and every re-mesh's
        (at a re-partitioned stage count too) go through here."""
        pm = dist.pipeline_mesh(m.shape["data"], m.shape["stage"])
        if ovl >= 1:
            st, fn = pp.make_pipeline_overlap_multi_step(
                model_cfg, optimizer, pm, params, **ring)
        else:
            st = pp.init_state(pm, params, optimizer, device=dev)
            fn = pp.make_pipeline_multi_step(
                model_cfg, optimizer, pm,
                n_microbatches=train_cfg.microbatches, schedule=schedule,
                device=dev)
        cur.update(mesh=pm, state=st)
        # Each (re)build has its own compile watch, named by its grid.
        tel = run_tel if dist.get_rank() == 0 else None
        fn = introspect.watch(
            fn, name=f"train/pp-{schedule}-elastic"
                     + (f"-{aggregation}" if aggregation != "gradient"
                        else "")
                     + (f"-ring{wire}-m{ovl}" if ovl else "")
                     + (f"-b{cb}" if cb > 1 else "")
                     + f"-d{pm.data}s{pm.stage}",
            max_caches=None,
            events=(tel.events if tel is not None else None),
            meta={"steps_per_dispatch": spd},
            meta_fn=lambda st, w: {"steps_per_dispatch": int(w.shape[0])})
        return st, fn, (lambda w: torch.as_tensor(w, dtype=torch.long,
                                                  device=dev))

    if elastic:
        from ..parallel.mesh import PoolMesh
        mesh0 = PoolMesh(np.asarray(pool.members if pool is not None
                                    else (0,)).reshape(mesh.data,
                                                       mesh.stage),
                         ("data", "stage"))
        state, step_fn, window_shard = _build_elastic(mesh0)
    elif ovl >= 1:
        make = (pp.make_pipeline_overlap_multi_step if spd > 1
                else pp.make_pipeline_overlap_step)
        state, step_fn = make(model_cfg, optimizer, mesh, params,
                              numerics=numerics, **ring)
    else:
        state = pp.init_state(mesh, params, optimizer, device=dev)
        make = (pp.make_pipeline_multi_step if spd > 1
                else pp.make_pipeline_step)
        step_fn = make(model_cfg, optimizer, mesh,
                       n_microbatches=train_cfg.microbatches,
                       schedule=schedule, numerics=numerics, device=dev)
    if not elastic:
        del params
        step_fn = introspect.watch(
            step_fn, name=f"train/pp-{schedule}"
                          + (f"-{aggregation}" if aggregation != "gradient"
                             else "")
                          + (f"-k{spd}" if spd > 1 else "")
                          + (f"-ring{wire}-m{ovl}" if ovl else "")
                          + (f"-b{cb}" if cb > 1 else "")
                          + (f"-tp{n_model}" if n_model > 1 else ""),
            max_caches=(1 if spd == 1 else None),
            events=(telemetry.events if telemetry is not None else None),
            meta={"steps_per_dispatch": spd},
            meta_fn=(None if spd == 1 else
                     (lambda st, w: {"steps_per_dispatch":
                                     int(w.shape[0])})))
    compile_watch = step_fn
    stats = ResilienceStats()
    ckpt, state, start_step, done = _setup_checkpoint(
        checkpoint_dir, state, train_cfg.iters, log_fn,
        resilience=resilience, stats=stats)
    if done:
        return LLMTrainReport(start_step=start_step, resilience=stats)
    _emit_manifest(telemetry, measure=measure, model_cfg=model_cfg,
                   train_cfg=train_cfg, start_step=start_step,
                   step_fn=compile_watch._fn, state=state,
                   n_data=mesh.data, device=dev, steps_per_dispatch=spd,
                   trainer="pp", mesh=mesh.shape,
                   overlap_microbatches=max(1, ovl), windowed=elastic)
    if fault_plan is None and resilience is not None and resilience.faults:
        # Resolved once: every rebuild re-wraps the same schedule.
        fault_plan = resilience.fault_plan()

    def _rewrap(fn, start=0):
        st = cur["state"] if cur["state"] is not None else state
        m = cur["mesh"]
        # On a model axis the guard's verdict covers the stages and then
        # the model shards, a replicated leaf counted once.
        group, shared = ((m.stage_group, m.model_group),
                         pp._replicated(st.params)) if m.model > 1 else (
                             m.stage_group, None)
        return _apply_resilience(fn, resilience, fault_plan, ckpt, stats,
                                 group=group, shared=shared,
                                 leaf_map=pp.global_leaf_map(st),
                                 start=start)

    def _make_batches(n):
        # This rank's data row at the current grid (skip d·5000): a
        # fresh run's data order.
        return shard_batches(tok, train_cfg.batch_size, train_cfg.seq_len,
                             cur["mesh"].d, shard_skip=5000,
                             seed=train_cfg.seed)

    if elastic:
        from ..resilience.elastic import ElasticController
        controller = ElasticController(
            mesh0, build=_build_elastic, rewrap=_rewrap,
            make_batches=_make_batches, ckpt=ckpt,
            mirror_every=resilience.mirror_every,
            layer_divisor=model_cfg.n_layers, stats=stats,
            telemetry=run_tel, log_fn=run_log, device=dev)
        return _run_loop(
            _rewrap(step_fn), state, _make_batches(mesh.data), train_cfg,
            window_shard, n_data=mesh.data, start_step=start_step,
            ckpt=ckpt, checkpoint_every=checkpoint_every, loss_sink=run_sink,
            sink_every=sink_every, log_every=log_every, log_fn=run_log,
            warmup_steps_excluded=warmup_steps_excluded, stats=stats,
            steps_per_dispatch=spd, on_checkpoint=on_checkpoint,
            telemetry=run_tel, controller=controller,
            scale_hook=scale_hook)
    return _run_loop(
        _rewrap(step_fn), state, _make_batches(mesh.data), train_cfg,
        lambda b: torch.as_tensor(b, dtype=torch.long, device=dev),
        n_data=mesh.data, start_step=start_step, ckpt=ckpt,
        checkpoint_every=checkpoint_every, loss_sink=loss_sink,
        sink_every=sink_every, log_every=log_every, log_fn=log_fn,
        warmup_steps_excluded=warmup_steps_excluded, stats=stats,
        steps_per_dispatch=spd, on_checkpoint=on_checkpoint,
        telemetry=telemetry, numerics=numerics,
        numerics_every=train_cfg.numerics_every,
        compile_watch=compile_watch)


def _elastic_pool(world: int):
    """The pool of an elastic pipeline or tensor-parallel run, which
    starts on the first ``world`` ranks of one ``distributed.run_ranks``
    launch, in order (None at a world of one)."""
    pool = dist.pool()
    if world > 1 and (pool is None
                      or pool.members != tuple(range(world))):
        raise ValueError(
            "elastic mode re-forms the process world over the pool of one "
            "distributed.run_ranks launch and must start on its first "
            f"{world} ranks as its world (the trainer starts the pool "
            "itself when called outside a process group)")
    return pool


def _check_tp_options(model_cfg: LlamaConfig, train_cfg: TrainConfig,
                      aggregation: str,
                      resilience: Optional[ResilienceConfig],
                      scale_hook) -> None:
    """The JAX ``train_llm_tp``'s errors, in its order and with its texts
    (the factories' PSA and ring checks included), all before any rank
    starts."""
    spd = train_cfg.steps_per_dispatch
    ovl = train_cfg.overlap_microbatches
    psa = train_cfg.psa
    if spd < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1 (got {spd})")
    if ovl < 0:
        raise ValueError(f"overlap_microbatches must be >= 0 (got {ovl})")
    cb = train_cfg.comm_buckets
    if cb < 1:
        raise ValueError(f"comm_buckets must be >= 1 (got {cb})")
    if cb > 1 and ovl == 0:
        raise ValueError(
            "comm_buckets > 1 is a property of the overlap/ring driver "
            "(the bucketed backward splits each microbatch's ring) — set "
            f"overlap_microbatches >= 1 (got comm_buckets={cb} with "
            "overlap_microbatches=0)")
    if train_cfg.dcn != 1 or train_cfg.wire_dcn:
        raise ValueError("hierarchical DP (TrainConfig.dcn / wire_dcn) is "
                         "DP-trainer-only; the TP mesh has no two-level "
                         "data tier")
    if train_cfg.accum_steps != 1:
        raise ValueError("accum_steps (DP gradient accumulation) is "
                         "DP-trainer-only; use overlap_microbatches on "
                         "the TP trainer's ring path")
    if aggregation not in ("gradient", "zero1"):
        raise ValueError(f"unknown aggregation {aggregation!r}: the TP "
                         "trainer supports 'gradient' and 'zero1'")
    if train_cfg.wire != "fp32" and ovl == 0:
        raise ValueError(
            "wire compression on the TP trainer routes through the DP×TP "
            "ring driver: set overlap_microbatches >= 1 "
            f"(got wire={train_cfg.wire!r} with overlap_microbatches=0)")
    if aggregation == "zero1" and ovl == 0:
        raise ValueError(
            "TP zero1 routes the data-axis sync through the ring driver: "
            "set overlap_microbatches >= 1")
    elastic = bool(resilience is not None and resilience.elastic)
    if elastic and ovl >= 1:
        raise ValueError(
            "elastic mode does not compose with the DP×TP ring driver "
            "(overlap_microbatches >= 1): its (data, model)-sharded ring "
            "stacks have no cross-topology reshard rule yet — set "
            "overlap_microbatches=0 (the fused dispatch paths, including "
            "psa='int8_ef', are elastic)")
    if elastic and train_cfg.numerics_every > 0:
        raise ValueError("numerics_every does not compose with elastic "
                         "mode yet")
    if scale_hook is not None and not elastic:
        raise ValueError("scale_hook requires resilience.elastic=True — "
                         "capacity changes ride the elastic re-mesh "
                         "machinery")
    if resilience is not None and resilience.injit_guard:
        raise ValueError("injit_guard is not fused into the TP step "
                         "bodies — use the host StepGuard "
                         "(ResilienceConfig.guard), which works at "
                         "dispatch granularity under steps_per_dispatch")
    if train_cfg.model < 2:
        raise ValueError("the TP trainer needs model >= 2 "
                         "(set TrainConfig.model); model=1 is the DP "
                         "trainer's mesh")
    if ovl >= 1:
        tp._tp_overlap_setup_checks(train_cfg.wire, aggregation, psa,
                                    model_cfg.n_layers,
                                    {"data": train_cfg.data,
                                     "model": train_cfg.model})
    else:
        tp._parse_psa(psa, model_cfg.n_layers)


def _train_tp_rank(model_cfg, train_cfg, kwargs: dict, *, device):
    """One rank of a ``train_llm_tp`` call that started its own ranks."""
    return train_llm_tp(model_cfg, train_cfg, device=device, **kwargs)


def train_llm_tp(model_cfg: Optional[LlamaConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, *,
                 tokenizer=None,
                 aggregation: str = "gradient",
                 log_every: int = 100,
                 log_fn: Callable[[str], None] = print,
                 warmup_steps_excluded: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000,
                 loss_sink: Optional[Callable[[int, float], None]] = None,
                 sink_every: int = 10,
                 resilience: Optional[ResilienceConfig] = None,
                 fault_plan=None,
                 scale_hook=None,
                 on_checkpoint=None,
                 telemetry=None,
                 device=None) -> LLMTrainReport:
    """Train the tiny-Llama tensor(-and-data)-parallel on ``device``
    (default CUDA; raises when no card is present). ``train_cfg.model``
    picks the TP degree (the Megatron layout of ``parallel.tp``) and
    ``data`` the data axis: ``data·model`` processes, rank ``d·model + m``
    model shard m of data row d. With no process group the ranks start
    (``distributed.run_ranks``) and rank 0's report comes back, as in
    ``train_llm_dp``; inside a group its size must be ``data·model``.

    Every rank initializes the whole model from ``train_cfg.seed`` (the DP
    trainer's weights) and keeps its slices; each data row reads its own
    stream (``shard_batches``, skip d·5000, the JAX trainer's data order)
    and every model shard of the row the same one. Routing, JAX's:
    ``overlap_microbatches`` = M >= 1 takes the DP×TP ring drivers
    (``tp.make_tp_overlap_step`` / ``_multi_step``: ``wire``,
    ``comm_buckets``, gradient or zero1), else the shared-body drivers
    (``tp.make_tp_step`` / ``make_tp_multi_step``) with ``psa``;
    ``steps_per_dispatch`` > 1 the K-step ones. ``numerics_every``: the
    model-agreed summaries (``tp.make_tp_numerics``). The loop is
    ``train_llm_dp``'s: checkpoints (rank 0 writes the merged JAX-layout
    state, residuals stacked ``[n_data, tp, ...]``; each rank re-slices
    on resume), the guard (its verdict summed over the model group),
    faults, preemption, telemetry (manifest ``trainer="tp"``, rank 0).

    Refused as the JAX trainer refuses them (``ValueError``, its texts):
    ``model < 2``, ``dcn``/``wire_dcn``, ``accum_steps``, a ``wire``
    without a ring, zero1 without a ring, ``comm_buckets`` without a ring,
    ``injit_guard``, a bad ``psa``, the ring's own checks, and elastic
    mode with the ring or ``numerics_every``.

    ``resilience.elastic=True`` (the shared-body K-step driver,
    ``tp.make_tp_multi_step``, every ``psa``) survives the loss of ranks
    whose data rows leave a complete row: the grid drops the victims' rows,
    the survivors re-form the process world and re-slice the state (the
    ``psa="int8_ef"`` activation residual by ``dp._resize_act_residual``'s
    row rule); a model-axis loss, which leaves no complete row, ends the
    run with the ``ReplicaLossError``. ``device_return`` grows the rows
    back and ``scale_hook`` resizes them. The run must start on the first
    ``data·model`` ranks of one ``distributed.run_ranks`` launch."""
    model_cfg = model_cfg or LlamaConfig()
    train_cfg = train_cfg or TrainConfig()
    _check_tp_options(model_cfg, train_cfg, aggregation, resilience,
                      scale_hook)
    world = train_cfg.data * train_cfg.model
    if not dist.is_initialized():
        kwargs = dict(tokenizer=tokenizer, aggregation=aggregation,
                      log_every=log_every, log_fn=log_fn,
                      warmup_steps_excluded=warmup_steps_excluded,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, loss_sink=loss_sink,
                      sink_every=sink_every, resilience=resilience,
                      fault_plan=fault_plan, telemetry=telemetry,
                      on_checkpoint=on_checkpoint, scale_hook=scale_hook)
        return dist.run_ranks(_train_tp_rank, world, model_cfg, train_cfg,
                              kwargs, device=device)[0]
    elastic = bool(resilience is not None and resilience.elastic)
    pool = _elastic_pool(world) if elastic else None
    dev = dist.rank_device(device)
    mesh = dist.tp_mesh(train_cfg.data, train_cfg.model)
    measure = telemetry is not None     # every rank runs the comm probe
    run_log, run_sink, run_tel = log_fn, loss_sink, telemetry
    if dist.get_rank() != 0:
        log_fn, loss_sink, telemetry = _quiet, None, None
    tok = tokenizer or load_tokenizer()
    model_cfg = model_cfg.replace(vocab_size=tok.vocab_size)
    if train_cfg.remat:
        model_cfg = model_cfg.replace(remat=True)
    params = llama.init_llama(model_cfg,
                              torch.Generator().manual_seed(train_cfg.seed),
                              device="cpu").tree()
    optimizer = _make_trainer_optimizer(train_cfg)
    spd = train_cfg.steps_per_dispatch
    ovl = train_cfg.overlap_microbatches
    cb = train_cfg.comm_buckets
    psa = train_cfg.psa
    numerics = (tp.make_tp_numerics(params, mesh, psum_data=ovl >= 1)
                if train_cfg.numerics_every > 0 else None)
    batch_shape = (train_cfg.batch_size, train_cfg.seq_len)
    # The current world's layout and state (an elastic re-mesh replaces
    # both).
    cur = {"mesh": mesh, "state": None}

    def _build_elastic(m):
        """(template state, raw window step, window placement) on the
        ``(data, model)`` grid ``m``: the first build and every re-mesh's
        go through here."""
        tm = dist.tp_mesh(m.shape["data"], m.shape["model"])
        st, fn = tp.make_tp_multi_step(model_cfg, optimizer, tm, params,
                                       psa=psa, batch_shape=batch_shape,
                                       device=dev)
        cur.update(mesh=tm, state=st)
        tel = run_tel if dist.get_rank() == 0 else None
        fn = introspect.watch(
            fn, name="train/tp-elastic"
                     + (f"-psa-{psa.replace(':', '')}" if psa else "")
                     + f"-d{tm.data}x{tm.model}",
            max_caches=None,
            events=(tel.events if tel is not None else None),
            meta={"steps_per_dispatch": spd},
            meta_fn=lambda st, w: {"steps_per_dispatch": int(w.shape[0])})
        return st, fn, (lambda w: torch.as_tensor(w, dtype=torch.long,
                                                  device=dev))

    if elastic:
        from ..parallel.mesh import PoolMesh
        mesh0 = PoolMesh(np.asarray(pool.members if pool is not None
                                    else (0,)).reshape(mesh.data,
                                                       mesh.model),
                         ("data", "model"))
        state, step_fn, window_shard = _build_elastic(mesh0)
    elif ovl >= 1:
        make = (tp.make_tp_overlap_multi_step if spd > 1
                else tp.make_tp_overlap_step)
        state, step_fn = make(model_cfg, optimizer, mesh, params,
                              aggregation=aggregation, wire=train_cfg.wire,
                              overlap_microbatches=ovl, psa=psa,
                              comm_buckets=cb, numerics=numerics,
                              device=dev)
    else:
        make = tp.make_tp_multi_step if spd > 1 else tp.make_tp_step
        state, step_fn = make(model_cfg, optimizer, mesh, params, psa=psa,
                              batch_shape=batch_shape, numerics=numerics,
                              device=dev)
    if not elastic:
        del params
        step_fn = introspect.watch(
            step_fn,
            name="train/tp"
                 + (f"-psa-{psa.replace(':', '')}" if psa else "")
                 + (f"-{aggregation}" if aggregation != "gradient" else "")
                 + (f"-k{spd}" if spd > 1 else "")
                 + (f"-ring{train_cfg.wire}-m{ovl}" if ovl else "")
                 + (f"-b{cb}" if cb > 1 else ""),
            max_caches=(1 if spd == 1 else None),
            events=(telemetry.events if telemetry is not None else None),
            meta={"steps_per_dispatch": spd},
            meta_fn=(None if spd == 1 else
                     (lambda st, w: {"steps_per_dispatch":
                                     int(w.shape[0])})))
    compile_watch = step_fn
    stats = ResilienceStats()
    ckpt, state, start_step, done = _setup_checkpoint(
        checkpoint_dir, state, train_cfg.iters, log_fn,
        resilience=resilience, stats=stats)
    if done:
        return LLMTrainReport(start_step=start_step, resilience=stats)
    _emit_manifest(telemetry, measure=measure, model_cfg=model_cfg,
                   train_cfg=train_cfg, start_step=start_step,
                   step_fn=compile_watch._fn, state=state,
                   n_data=mesh.data, device=dev, steps_per_dispatch=spd,
                   trainer="tp", mesh=mesh.shape,
                   overlap_microbatches=max(1, ovl), windowed=elastic)
    if fault_plan is None and resilience is not None and resilience.faults:
        fault_plan = resilience.fault_plan()

    def _rewrap(fn, start=0):
        st = cur["state"] if cur["state"] is not None else state
        return _apply_resilience(
            fn, resilience, fault_plan, ckpt, stats,
            group=cur["mesh"].model_group,
            shared=[not x for x in tree_leaves(tp._sharded_mask(st.params))],
            start=start)

    def _make_batches(n):
        return shard_batches(tok, train_cfg.batch_size, train_cfg.seq_len,
                             cur["mesh"].d, shard_skip=5000,
                             seed=train_cfg.seed)

    if elastic:
        from ..resilience.elastic import ElasticController
        controller = ElasticController(
            mesh0, build=_build_elastic, rewrap=_rewrap,
            make_batches=_make_batches, ckpt=ckpt,
            mirror_every=resilience.mirror_every, stats=stats,
            telemetry=run_tel, log_fn=run_log, device=dev)
        return _run_loop(
            _rewrap(step_fn), state, _make_batches(mesh.data), train_cfg,
            window_shard, n_data=mesh.data, start_step=start_step,
            ckpt=ckpt, checkpoint_every=checkpoint_every, loss_sink=run_sink,
            sink_every=sink_every, log_every=log_every, log_fn=run_log,
            warmup_steps_excluded=warmup_steps_excluded, stats=stats,
            steps_per_dispatch=spd, on_checkpoint=on_checkpoint,
            telemetry=run_tel, controller=controller,
            scale_hook=scale_hook)
    return _run_loop(
        _rewrap(step_fn), state, _make_batches(mesh.data), train_cfg,
        lambda b: torch.as_tensor(b, dtype=torch.long, device=dev),
        n_data=mesh.data, start_step=start_step, ckpt=ckpt,
        checkpoint_every=checkpoint_every, loss_sink=loss_sink,
        sink_every=sink_every, log_every=log_every, log_fn=log_fn,
        warmup_steps_excluded=warmup_steps_excluded, stats=stats,
        steps_per_dispatch=spd, on_checkpoint=on_checkpoint,
        telemetry=telemetry, numerics=numerics,
        numerics_every=train_cfg.numerics_every,
        compile_watch=compile_watch)
