"""Elastic data parallelism: counterpart of the JAX package's
``resilience/elastic.py`` (``RemeshRecord``, ``Resume``,
``ElasticController``).

When a data-parallel replica is lost mid-run (a ``device_loss`` fault, or
any ``ReplicaLossError``), the run drains at the chunk edge, re-forms the
data world over the survivors, reshards the parameters, the ZeRO-1
moments and the ring step's error-feedback residuals N → M
(``parallel.dp.reshard_state``), re-splits the token stream at the exact
stream position and resumes. The same machinery grows the world back when
capacity returns (``device_return``, ``ReplicaReturnSignal``) or when the
autoscaler asks for another world (``resize``, the ``scale_hook`` of
``train_llm_dp``).

The JAX package re-meshes devices inside one process. Here every replica
is a process of the pool that ``distributed.run_ranks`` started, and the
data world is the process group: a re-mesh moves the pool to the next
topology epoch (``distributed.reform``). The members of the new world
leave the old group and join a fresh one, rank ``i`` being the ``i``-th
pool rank of the new mesh (``parallel.mesh``: survivors keep their order,
a rejoin restores pool order), so every collective, step factory and
checkpoint of the package runs over the new world unchanged, and the world
after a re-mesh is literally a fresh M-rank world. A rank that leaves
stays alive without a group and waits on the pool's store
(``wait_rejoin``) until an epoch includes it again or the run ends. The
ranks agree on every fault-driven move without a message, since the fault
plan raises at the same dispatch everywhere and picks the same victims and
arrivals; the rank that posts an epoch's record (the first pool rank in
both worlds) tells the waiting ranks of a grow, and after the grow
broadcasts the mirror and the loop's state to the ranks that join.

Recovery paths, fastest first:

- **mirror**: a host-RAM last-good snapshot taken at chunk edges
  (``ResilienceConfig.mirror_every``; ``host_snapshot`` gathers every
  rank's ZeRO-1 and residual blocks, so every rank holds the whole state).
  With ``mirror_every=1`` nothing is replayed.
- **checkpoint**: no mirror → restore the newest valid step through
  ``Checkpointer``'s cross-world restore, then re-train forward from it.

Either way the recovered state is persisted at once in the new layout,
the stream is rebuilt at the new width and replayed to the recovery
position (a fresh M-rank run's data order), and the step is rebuilt with
the fault and guard wrappers re-applied at the absolute dispatch index.
Each recovery is a ``remesh`` span with ``drain`` (the old world settles
and the new one forms), ``rebuild``, ``restore``, ``persist`` and
``replay`` children.

The writers follow the current world's rank 0, which a loss can take
away (pool rank 0 is index 0 of the world that loses it): the checkpoint
writer, the telemetry writer (the new one appends to the same files and
goes on numbering the events), the log and the loss sink. When the run
ends on a smaller world, the pool re-forms whole and the final world's
rank 0 broadcasts its report, so every rank returns it.

The pipeline and tensor-parallel trainers re-mesh 2-axis meshes
(``parallel.mesh``: a data-row drop, else a stage re-partition over
``layer_divisor`` layers; a model-axis loss re-raises). Their states go
through ``snapshot_state`` / ``place_state``, which pick the layout's own
host form: a stage state's merged JAX-layout tree (``pp.host_snapshot``,
re-sliced at any stage count by ``pp.slice_state``), a tensor-parallel
state's stacks (``tp.host_snapshot`` / ``tp.slice_state``), else
``dp.host_snapshot`` / ``dp.reshard_state``.

Correctness bar (tests/test_torch_elastic.py, tests/test_torch_elastic_pp.py):
bitwise. With no fault the
elastic loop's losses are the non-elastic run's; after N → M (or M → N)
the continued losses are a fresh M- (N-) rank run's restored from the same
state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from ..parallel import distributed as dist
from ..parallel import dp, pp, tp
from ..parallel.mesh import PoolMesh, rejoin_mesh, survivor_submesh
from ..telemetry.trace import Tracer
from .faults import ReplicaLossError, ReplicaReturnSignal


def snapshot_state(state):
    """The host form of any trainer's state (a collective: every rank of
    the world calls it): ``pp.host_snapshot`` for a pipeline stage,
    ``tp.host_snapshot`` for a tensor-parallel rank, else
    ``dp.host_snapshot``."""
    if getattr(state, "pp", None) is not None:
        return pp.host_snapshot(state)
    if tp._is_state(state):
        return tp.host_snapshot(state)
    return dp.host_snapshot(state)


def place_state(host_state, template):
    """``snapshot_state``'s inverse at ``template``'s topology, which may
    differ from the snapshot's: ``pp.slice_state`` (any stage count and
    data world), ``tp.slice_state`` (any data world), else
    ``dp.reshard_state``."""
    if getattr(template, "pp", None) is not None:
        return pp.slice_state(host_state, template)
    if tp._is_state(template):
        return tp.slice_state(host_state, template)
    return dp.reshard_state(host_state, template)


def _pool_mesh(members, shape, axes) -> PoolMesh:
    return PoolMesh(np.asarray(list(members)).reshape(tuple(shape)), axes)


@dataclass
class RemeshRecord:
    """Accounting for one topology change (shrink or grow): lands in
    ``LLMTrainReport.remeshes``, the telemetry ``remesh`` event and the
    elastic and autoscale twins' JSON, with the JAX record's keys."""

    detected_at: int       # stream position of the interrupted dispatch
    resume_step: int       # stream position training resumed from
    dispatch: int          # absolute dispatch index of the interruption
    old_world: int         # the data world (ranks) before
    new_world: int
    lost: List[int] = field(default_factory=list)
    path: str = "mirror"   # "mirror" (host-RAM fast path) | "checkpoint"
    seconds: float = 0.0   # drain → resharded-and-replayed wall time
    steps_replayed: int = 0  # detected_at - resume_step (re-trained steps)
    direction: str = "shrink"   # "shrink" | "grow"
    returned: List[int] = field(default_factory=list)  # rejoined pool slots
    axis: str = "data"
    old_shape: Tuple[int, int] = (0, 1)
    new_shape: Tuple[int, int] = (0, 1)

    def as_dict(self) -> dict:
        return {"detected_at": self.detected_at,
                "resume_step": self.resume_step,
                "dispatch": self.dispatch,
                "old_world": self.old_world, "new_world": self.new_world,
                "lost": list(self.lost), "path": self.path,
                "seconds": self.seconds,
                "steps_replayed": self.steps_replayed,
                "direction": self.direction,
                "returned": list(self.returned),
                "axis": self.axis,
                "old_shape": list(self.old_shape),
                "new_shape": list(self.new_shape)}


class Resume(NamedTuple):
    """What the training loop swaps in after a recovery."""
    mesh: Any
    n_data: int
    state: Any
    step_fn: Callable
    window_shard_fn: Callable
    batches: Any           # this rank's stream, already replayed to ``step``
    step: int              # stream position to resume from
    record: RemeshRecord


class ElasticController:
    """The drain → re-mesh → reshard → resume state machine.

    The training loop owns the iteration; the controller owns everything
    topology: the host-RAM mirror, victim selection, the new world, state
    resharding, the stream's re-split and replay, the step's rebuild and
    the recovery accounting. Wiring (``train/llm.py``):

    - ``build(mesh) -> (template_state, raw_step_fn, window_shard_fn)``
      builds the trainer's window step over the current process world
      (``mesh``, a ``PoolMesh``, names its pool ranks);
    - ``rewrap(raw_step_fn, start) -> step_fn`` re-applies the fault plan
      at absolute dispatch index ``start`` and a fresh StepGuard;
    - ``make_batches(n_shards) -> iterator`` is this rank's stream at the
      new width, which the controller replays to the recovery position.

    ``mesh`` is the run's world (pool rank ``i`` at world rank ``i``): a
    data mesh, or a ``(data, stage)`` / ``(data, model)`` grid, whose
    shape a full rejoin restores; ``layer_divisor`` (the model's
    ``n_layers``) lets a stage mesh re-partition its layers; ``device``
    the rank's device (the drain's barrier).
    ``telemetry`` and ``log_fn`` are every rank's: the current world's
    rank 0 writes and logs. ``recover``, ``grow`` and ``resize`` return a
    ``Resume``, or None on a rank that left the world, which then waits in
    ``wait_rejoin``; ``finish`` ends the run on every rank of the pool."""

    def __init__(self, mesh: PoolMesh, *, build: Callable, rewrap: Callable,
                 make_batches: Callable, ckpt=None, mirror_every: int = 1,
                 layer_divisor: Optional[int] = None, stats=None,
                 telemetry=None, log_fn: Callable = print, device=None):
        self.mesh = mesh
        # The run's pool: a grow restores only capacity the run started
        # with, and pool order lands every rank back in its slot.
        self._pool = list(mesh.members)
        self._pool_shape = tuple(int(s) for s in mesh.devices.shape)
        self._layer_divisor = (int(layer_divisor)
                               if layer_divisor is not None else None)
        self._build = build
        self._rewrap = rewrap
        self._make_batches = make_batches
        self._ckpt = ckpt
        self.mirror_every = int(mirror_every)
        self._stats = stats
        self._telemetry = telemetry
        self._log_fn = log_fn
        self._device = device if device is not None else "cpu"
        self._mirror: Optional[Tuple[int, Any]] = None  # (step, host state)
        self._edges = 0
        self._done_leader: Optional[int] = None
        self.records: List[RemeshRecord] = []

    # ------------------------------------------------------------ writers

    @property
    def leader(self) -> bool:
        """Whether this process is the current world's rank 0."""
        me = dist.pool().rank if dist.pool() is not None else 0
        return me in self.mesh.members and dist.get_rank() == 0

    @property
    def telemetry(self):
        """The telemetry bundle on the current world's rank 0, else None."""
        return self._telemetry if self.leader else None

    @property
    def span_prefix(self) -> str:
        """The span-id prefix of this process's tracers: the run's writers
        change process, and their ids must not collide in the stream."""
        p = dist.pool()
        return f"p{p.rank}." if p is not None else ""

    def _log(self, msg: str) -> None:
        if self.leader:
            self._log_fn(msg)

    # ------------------------------------------------------------- mirror

    def note_edge(self, step: int, state) -> None:
        """Chunk-edge hook: refresh the last-good host mirror on schedule
        (a collective: every rank of the world calls it). The first call
        always mirrors, so a loss on the very first dispatch is
        recoverable without a checkpoint."""
        if self.mirror_every <= 0:
            return
        if self._mirror is None or self._edges % self.mirror_every == 0:
            self._mirror = (step, snapshot_state(state))
        self._edges += 1

    @property
    def mirror_step(self) -> Optional[int]:
        return self._mirror[0] if self._mirror is not None else None

    def mirror_bytes(self) -> int:
        """Host RAM held by the last-good mirror."""
        from ..telemetry.memory import np_tree_bytes
        return np_tree_bytes(self._mirror[1]) if self._mirror else 0

    # ----------------------------------------------------------- recovery

    def absent(self) -> List[int]:
        """Pool positions of ranks currently out of the world: the
        capacity a grow can reclaim."""
        current = set(self.mesh.members)
        return [i for i, d in enumerate(self._pool) if d not in current]

    @staticmethod
    def _dxs(mesh: PoolMesh) -> Tuple[int, int]:
        d = int(mesh.shape.get("data", 1))
        s = 1
        for a, sz in mesh.shape.items():
            if a != "data":
                s *= int(sz)
        return d, s

    def recover(self, err: ReplicaLossError, *, failed_at: int,
                dispatch: int) -> Optional[Resume]:
        """Re-form the world over the survivors and hand back a resumable
        world (None on a victim, which has left it). ``failed_at`` is the
        stream position of the dispatch that died, ``dispatch`` its
        absolute index: the rebuilt fault wrapper continues from
        ``dispatch + 1``. A loss at a world of one re-raises ``err``."""
        old_world = self.mesh.devices.size
        lost = err.victims(old_world)
        if not lost:
            raise err
        try:
            new_mesh = survivor_submesh(self.mesh, lost,
                                        layer_divisor=self._layer_divisor)
        except ValueError as e:
            raise err from e
        self._log(f"replica loss at step {failed_at} (dispatch {dispatch}): "
                  f"lost {lost} of {old_world}; re-meshing onto "
                  f"{new_mesh.devices.size} of the "
                  f"{old_world - len(lost)} survivors")
        return self._move(new_mesh, failed_at=failed_at, dispatch=dispatch,
                          lost=lost, returned=[], direction="shrink",
                          err=err)

    def grow(self, sig: ReplicaReturnSignal, *, failed_at: int,
             dispatch: int, loop_state=None) -> Resume:
        """Scale-up re-mesh: the signal's seeded ``arrivals`` pick which
        absent pool slots rejoin, the world restores pool order, and the
        state reshards M → N through the same paths as ``recover``.
        ``loop_state`` (the training loop's record so far) travels to the
        ranks that join."""
        old_world = self.mesh.devices.size
        absent = self.absent()
        arrivals = sig.arrivals(absent)
        if not arrivals:
            raise RuntimeError(
                f"device_return at dispatch {dispatch}: no capacity is "
                f"absent (world {old_world}, pool {len(self._pool)}) — a "
                "return must follow a loss; fix the chaos spec") from sig
        returned = [self._pool[i] for i in arrivals]
        new_mesh = rejoin_mesh(self.mesh, returned, pool=self._pool,
                               pool_shape=self._pool_shape,
                               layer_divisor=self._layer_divisor)
        self._log(f"replica return at step {failed_at} "
                  f"(dispatch {dispatch}): pool slots {arrivals} rejoin; "
                  f"re-meshing onto {new_mesh.devices.size} devices")
        return self._move(new_mesh, failed_at=failed_at, dispatch=dispatch,
                          lost=[], returned=arrivals, direction="grow",
                          err=sig, loop_state=loop_state)

    def resize(self, new_world: int, *, state, at_step: int, dispatch: int,
               loop_state=None) -> Optional[Resume]:
        """Capacity-change re-mesh (the autoscaler's entry point), called
        by every rank of the world between dispatches with the same
        ``new_world``. Shrinks release the highest-indexed replicas; grows
        reclaim absent pool slots lowest-first. The just-drained ``state``
        at edge ``at_step`` is pinned as the mirror, so the move replays
        nothing. Returns None when the world is already ``new_world`` (and
        on a released rank, which has left the world)."""
        old_data, s2 = self._dxs(self.mesh)
        new_world = int(new_world)
        if new_world == old_data:
            return None
        self._mirror = (at_step, snapshot_state(state))
        if new_world < 1:
            raise ValueError(f"resize to {new_world} replicas: the training "
                             "mesh cannot shrink below 1")
        if new_world * s2 > len(self._pool):
            raise ValueError(f"resize to {new_world} data rows of {s2} "
                             f"device(s) exceeds the run's device pool "
                             f"({len(self._pool)})")
        if new_world < old_data:
            lost = list(range(new_world * s2, old_data * s2))
            new_mesh = survivor_submesh(self.mesh, lost,
                                        layer_divisor=self._layer_divisor)
            self._log(f"resize at step {at_step}: releasing data rows "
                      f"{list(range(new_world, old_data))} "
                      f"({old_data} -> {new_world})")
            return self._move(new_mesh, failed_at=at_step,
                              dispatch=dispatch, lost=lost, returned=[],
                              direction="shrink",
                              err=RuntimeError(
                                  f"resize {old_data}->{new_world} at "
                                  f"step {at_step} found no recoverable "
                                  "state (no mirror, no checkpoint)"))
        arrivals = self.absent()[:(new_world - old_data) * s2]
        if len(arrivals) < (new_world - old_data) * s2:
            raise ValueError(f"resize to {new_world} data rows: only "
                             f"{len(arrivals)} pool slots are absent "
                             f"(need {(new_world - old_data) * s2})")
        returned = [self._pool[i] for i in arrivals]
        new_mesh = rejoin_mesh(self.mesh, returned, pool=self._pool,
                               pool_shape=self._pool_shape,
                               layer_divisor=self._layer_divisor)
        self._log(f"resize at step {at_step}: pool slots {arrivals} "
                  f"rejoin ({old_data} -> {new_world})")
        return self._move(new_mesh, failed_at=at_step, dispatch=dispatch,
                          lost=[], returned=arrivals, direction="grow",
                          err=RuntimeError(
                              f"resize {old_data}->{new_world} at step "
                              f"{at_step} found no recoverable state "
                              "(no mirror, no checkpoint)"),
                          loop_state=loop_state)

    # ------------------------------------------------------ process worlds

    def _move(self, new_mesh: PoolMesh, *, failed_at: int, dispatch: int,
              lost: List[int], returned: List[int], direction: str,
              err: BaseException, loop_state=None) -> Optional[Resume]:
        """Drain the old world, move the pool to the new one (posting the
        epoch for the waiting ranks, and handing a grow's joiners the
        mirror and ``loop_state``), then ``_remesh``. None on a rank that
        left."""
        t0 = time.monotonic_ns()
        p = dist.pool()
        old = self.mesh
        if p is None:               # a world of one: only a no-op move
            raise err
        dist.barrier(self._device)   # the old world settles; its writes land
        source = min(set(old.members) & set(new_mesh.members))
        if p.rank == source:
            p.post_epoch({"members": list(new_mesh.members),
                          "axes": list(new_mesh.axis_names),
                          "shape": list(new_mesh.devices.shape),
                          "old_members": list(old.members),
                          "old_shape": list(old.devices.shape),
                          "failed_at": failed_at, "dispatch": dispatch,
                          "lost": lost, "returned": returned,
                          "direction": direction, "source": source})
        dist.reform(new_mesh.members)
        if p.rank not in new_mesh.members:
            self.mesh = new_mesh
            return None
        if direction == "grow":
            self._sync(new_mesh, source, loop_state)
        return self._remesh(new_mesh, old, failed_at=failed_at,
                            dispatch=dispatch, lost=lost, returned=returned,
                            direction=direction, err=err, t0=t0)

    def _sync(self, new_mesh: PoolMesh, source: int, loop_state):
        """Broadcast the source's mirror, records, counters and
        ``loop_state`` over the new world; returns the loop state the
        source sent."""
        payload = None
        if dist.pool().rank == source:
            payload = {"mirror": self._mirror, "records": self.records,
                       "edges": self._edges, "stats": self._stats,
                       "loop": loop_state}
        payload = dist.broadcast_object(
            payload, src=new_mesh.members.index(source))
        self._mirror = payload["mirror"]
        self.records = list(payload["records"])
        self._edges = payload["edges"]
        if self._stats is not None:
            # The joiner keeps its own object: its checkpoint and guard
            # count into it.
            for f in dataclasses.fields(self._stats):
                setattr(self._stats, f.name,
                        getattr(payload["stats"], f.name))
        return payload["loop"]

    def wait_rejoin(self):
        """On a rank outside the world: wait for the next epochs until one
        includes this rank. Returns ``(Resume, loop_state)`` when a grow
        takes it back, None when the run has ended (the pool is whole
        again then)."""
        p = dist.pool()
        while True:
            rec = p.await_epoch()
            dist.reform(rec["members"])
            if p.rank not in rec["members"]:
                continue
            if rec.get("done"):
                self._done_leader = int(rec["leader"])
                return None
            t0 = time.monotonic_ns()
            axes = tuple(rec["axes"])
            new_mesh = _pool_mesh(rec["members"], rec["shape"], axes)
            old = _pool_mesh(rec["old_members"], rec["old_shape"], axes)
            loop_state = self._sync(new_mesh, int(rec["source"]), None)
            resume = self._remesh(
                new_mesh, old, failed_at=int(rec["failed_at"]),
                dispatch=int(rec["dispatch"]), lost=list(rec["lost"]),
                returned=list(rec["returned"]), direction=rec["direction"],
                err=RuntimeError("rejoin found no recoverable state (no "
                                 "mirror, no checkpoint)"), t0=t0)
            return resume, loop_state

    def finish(self, report):
        """End of the run on every rank of the pool: when the final world
        is smaller than the pool, the pool re-forms whole and the final
        world's rank 0 broadcasts ``report``, which every rank returns."""
        p = dist.pool()
        full = tuple(self._pool)
        if p is None or (self._done_leader is None
                         and self.mesh.members == full):
            return report
        if self._done_leader is None:
            leader = self.mesh.members[0]
            if p.rank == leader:
                p.post_epoch({"members": list(full), "done": True,
                              "leader": leader})
            dist.reform(full)
        else:
            leader = self._done_leader
        return dist.broadcast_object(report, src=leader)

    def _take_over_events(self, was_leader: bool) -> None:
        """A new rank 0 goes on numbering the run's events where the old
        writer stopped (its last event is on disk: the drain's barrier
        ordered it before this read)."""
        tel = self._telemetry
        if tel is None or was_leader or not self.leader:
            return
        seq = _last_seq(tel.events.path)
        if seq is not None:
            tel.events._seq = max(tel.events._seq, seq)

    # ------------------------------------------------------------- remesh

    def _remesh(self, new_mesh: PoolMesh, old_mesh: PoolMesh, *,
                failed_at: int, dispatch: int, lost: List[int],
                returned: List[int], direction: str, err: BaseException,
                t0: int) -> Resume:
        """The shared drain → rebuild → restore → persist → replay →
        resume machinery behind ``recover``, ``grow`` and ``resize``, run
        by every rank of the new world; ``t0`` (``time.monotonic_ns``) is
        when the drain began. ``err`` is raised back when recovery is
        impossible (no mirror and no restorable checkpoint)."""
        me = dist.pool().rank
        was_leader = me == old_mesh.members[0]
        self.mesh = new_mesh
        self._take_over_events(was_leader)
        old_shape = self._dxs(old_mesh)
        new_shape = self._dxs(new_mesh)
        old_world = int(old_mesh.devices.size)
        new_world = int(new_mesh.devices.size)
        new_data = new_shape[0]
        axis = "stage" if new_shape[1] != old_shape[1] else "data"
        tel = self.telemetry
        self._beat(failed_at, "remesh")
        tracer = (Tracer(tel.events, prefix=self.span_prefix)
                  if tel is not None else None)
        rroot = (tracer.start("remesh", trace="train", it=failed_at,
                              old_world=old_world, new_world=new_world,
                              axis=axis, direction=direction)
                 if tracer is not None else None)
        if rroot is not None:
            # The drain ran before this rank knew it would write: the root
            # and its drain child start where the drain started.
            rroot.start_ns = t0
            drain = tracer.start("drain", parent=rroot.ctx)
            drain.start_ns = t0
            drain.end()

        def _span(name):
            if rroot is not None:
                return tracer.span(name, parent=rroot.ctx)
            return contextlib.nullcontext()

        with _span("rebuild"):
            template, raw_step, window_shard = self._build(new_mesh)
        if self._mirror is not None:
            resume_step, host_state = self._mirror
            with _span("restore"):
                state = place_state(host_state, template)
            path = "mirror"
        elif self._ckpt is not None:
            try:
                with _span("restore"):
                    state = self._ckpt.restore(template)
            except FileNotFoundError:
                if rroot is not None:
                    rroot.end(error=True)
                raise err from None
            resume_step = int(self._ckpt.restored_step)
            path = "checkpoint"
        else:
            if rroot is not None:
                rroot.end(error=True)
            raise err

        if self._ckpt is not None:
            # Persist the new layout now: a second loss (or a preemption)
            # must restore the cross-world work, not redo it.
            with _span("persist"):
                self._ckpt.save(resume_step, state, overwrite=True)

        with _span("replay"):
            batches = self._make_batches(new_data)
            last_beat = 0.0
            for i in range(resume_step):    # stream replay at the new width
                next(batches)
                now = time.perf_counter()
                if now - last_beat >= 0.5:
                    self._beat(i, "remesh")
                    last_beat = now

        step_fn = self._rewrap(raw_step, start=dispatch + 1)
        self._edges = 0
        self._mirror = None
        if self.mirror_every > 0:
            self.note_edge(resume_step, state)

        if rroot is not None:
            rroot.end(path=path, steps_replayed=failed_at - resume_step)
        rec = RemeshRecord(
            detected_at=failed_at, resume_step=resume_step,
            dispatch=dispatch, old_world=old_world, new_world=new_world,
            lost=list(lost), path=path,
            seconds=(time.monotonic_ns() - t0) / 1e9,
            steps_replayed=failed_at - resume_step,
            direction=direction, returned=list(returned),
            axis=axis, old_shape=old_shape, new_shape=new_shape)
        self.records.append(rec)
        if self._stats is not None:
            self._stats.remeshes += 1
        if tel is not None:
            tel.events.remesh(
                old_world=old_world, new_world=new_world, lost=list(lost),
                path=path, it=resume_step, detected_at=failed_at,
                seconds=rec.seconds, steps_replayed=rec.steps_replayed,
                direction=direction, returned=list(returned),
                axis=axis, old_shape=list(old_shape),
                new_shape=list(new_shape))
        self._log(f"re-mesh ({direction}) complete in {rec.seconds:.3f}s "
                  f"via {path}: resuming at step {resume_step} "
                  f"({rec.steps_replayed} steps to re-train)")
        return Resume(new_mesh, new_data, state, step_fn, window_shard,
                      batches, resume_step, rec)

    def _beat(self, step: int, phase: str) -> None:
        tel = self.telemetry
        if tel is not None:
            tel.heartbeat.beat(step=step, phase=phase)


def _last_seq(path: str) -> Optional[int]:
    """The ``seq`` of the last whole event in an events file."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - (1 << 16)))
            lines = f.read().split(b"\n")
    except OSError:
        return None
    for line in reversed(lines):
        try:
            return int(json.loads(line)["seq"])
        except (ValueError, KeyError, TypeError):
            continue
    return None
