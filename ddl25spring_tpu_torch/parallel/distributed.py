"""Process group, rank launcher and collectives for multi-process data
parallelism: counterpart of the JAX package's ``parallel/distributed.py``
(``initialize``, ``process_info``) and of the collectives its
``parallel/dp.py`` calls through ``telemetry/comm.py`` (``pmean``,
``psum``, ``psum_scatter``, ``all_gather``).

The reference's DP homework runs one OS process per rank, joined by
``torch.distributed`` over gloo; the JAX package runs one SPMD program over
a ``data`` mesh axis. The port goes back to processes: ``run_ranks`` starts
``world`` processes from a ``forkserver`` (CUDA forbids ``fork`` of a
process that has initialised it; the server, which imports torch and the
port once, never does), each joins the group through ``initialize`` and
runs the given function, and the launcher returns each rank's result.
Rank r drives ``cuda:(r % device_count)``, so on one card every rank
shares it.

The backend is gloo, on CPU and CUDA tensors alike, and the collectives
use only the two operations gloo provides for CUDA tensors, ``all_reduce``
(sum) and ``broadcast``; gloo itself stages a CUDA tensor through pinned
host memory, so on one card a collective is a host round trip, not NCCL:

- ``psum`` is the all-reduce; ``pmean`` its sum divided by the world size,
  as ``lax.pmean`` is;
- ``psum_scatter(flat)`` is the all-reduce followed by this rank's
  ``1/n`` slice;
- ``all_gather(piece)`` is an all-reduce of a zero buffer in which this
  rank has written its slice: adding exact zeros changes no value (a
  ``-0.0`` comes back as ``+0.0``, which compares equal).

Every rank receives the same sums, so replicated state stays bitwise
replicated. At a world of one (no group) every collective returns its
input and starts nothing. Each collective records its bytes, under its
call site's label, into ``telemetry.comm``'s active collector.

The compressed and overlapped gradient sync (``parallel/compress.py``)
adds ``pmax`` (the int8 scales), ``ppermute`` (a ring shift over a
``Group``, on the point-to-point hops below) and ``all_gather`` over a
``Group`` in the operand's own dtype. These move the int8 and bf16 wire
formats, which gloo's CUDA route is not known to sum, so they stage the
operand to the host explicitly and run gloo on CPU tensors; each records
the bytes of its operand in its own dtype. ``hier_data_mesh`` lays the
ranks out as ``{"dcn": D, "data": S}`` islands (rank ``d·S + s``) with a
gloo group per island and one per column.

Sequence and expert parallelism lay the ranks on ``{"data": D, "seq":
S}`` and ``{"data": D, "expert": E}`` meshes (``axis_mesh``: rank ``d·S +
s``, a gloo group per data row and one per column); ring attention shifts
K and V around the seq group with ``ppermute_ad``, a differentiable ring
shift whose backward shifts the cotangents back.

Pipeline parallelism lays the ranks on a ``{"data": D, "stage": S}``
mesh in the JAX mesh's order (``pipeline_mesh``: rank ``d·S + s``), with
a gloo group per data row (its stages) and one per stage (its data
rows); the collectives take such a ``Group`` as ``group=``. With a model
axis the mesh is ``{"data": D, "stage": S, "model": T}`` (rank ``(d·S +
s)·T + m``): Megatron tensor parallelism inside each stage, with the
stage and data groups per model shard and ``TPMesh``'s two model groups
per (data row, stage). Tensor
parallelism lays them on a ``{"data": D, "model": M}`` mesh the same way
(``tp_mesh``: rank ``d·M + m``), with a gloo group per data row (its model
shards), one per model column (its data rows) and a second per data row for
the ring thread's int8 scales; ``psum_ad`` is the all-reduce autograd sees
through, whose backward is the same sum (the transpose of ``lax.psum``
under ``shard_map``). Stages pass
activations and cotangents point to point (``send``, ``recv``, ``isend``,
``irecv``, and ``Hops`` for one step's hops): gloo sends CPU tensors
only, so on the card a hop is a device→host copy, gloo over loopback and
a host→device copy, as in the reference's gloo pipeline.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device
from ..telemetry import comm as _comm
from ..tree import tree_leaves, tree_unflatten

BACKEND = "gloo"
# How a collective reaches the wire: gloo's all_reduce and broadcast on the
# tensor's own device (the chip_smoke.py probe holds them exact on CUDA).
ROUTE = "gloo on the tensors' device (gloo stages CUDA tensors through host)"
# A collective that waits longer than this raises instead of hanging.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@contextlib.contextmanager
def _named(group, what: str):
    """Re-raise a failed or timed-out gloo wait (``GROUP_TIMEOUT``) naming
    the ``Group`` it waited on: with several groups per rank, a stuck
    schedule then says which axis and which ranks."""
    try:
        yield
    except RuntimeError as e:
        if group is None:
            raise
        raise RuntimeError(f"{what} on the {group.axis} group (ranks "
                           f"{list(group.ranks)}) failed or waited longer "
                           f"than {GROUP_TIMEOUT}: {e}") from e


def initialize(rank: int, world: int, init_method: str,
               device=None) -> torch.device:
    """Join rank ``rank`` of ``world`` to the default process group (gloo)
    through ``init_method`` (a ``file://`` path or ``tcp://host:port``
    shared by every rank) and return the device this rank drives:
    ``device`` ("cpu", or None for CUDA), with a CUDA device of no index
    resolved to ``cuda:(rank % device_count)``. gloo binds to the loopback
    interface unless ``GLOO_SOCKET_IFNAME`` is set: every rank is on one
    host."""
    dev = rank_device(device, rank)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(BACKEND, init_method=init_method, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """``resolve_device(device)`` (None means CUDA, raising when no card is
    present), with an index-less CUDA device pinned to ``cuda:(rank %
    device_count)``; ``rank`` defaults to this process's rank."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        r = get_rank() if rank is None else rank
        dev = torch.device("cuda", r % torch.cuda.device_count())
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The size of the default group; 1 when there is none."""
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    """This process's rank in the default group; 0 when there is none."""
    return dist.get_rank() if is_initialized() else 0


def process_info() -> Dict[str, int]:
    """This process's identity in the group (the JAX function's keys): one
    process drives one device."""
    n = world_size()
    return {"process_id": get_rank(), "num_processes": n,
            "local_devices": 1, "global_devices": n}


# ------------------------------------------------------------------ launcher

def _rank_main(fn, rank, world, directory, device, args, results,
               threads) -> None:
    """A child's body: join the group, run ``fn(*args, device=...)``, put
    ``(rank, ok, pickled result or traceback)`` on ``results``."""
    global _POOL
    try:
        torch.set_num_threads(threads)
        _POOL = Pool(rank, world, directory, members=tuple(range(world)))
        dev = initialize(rank, world,
                         "file://" + os.path.join(directory, "store"),
                         device)
        payload = (rank, True, pickle.dumps(fn(*args, device=dev)))
    except BaseException:          # reported to the parent, which raises
        payload = (rank, False, traceback.format_exc())
    # Report before leaving the group: a failure makes the other ranks'
    # collectives fail too, and the parent should hear the cause first.
    results.put(payload)
    if is_initialized():
        dist.destroy_process_group()


def _more_failures(results, failed: Dict[int, str], world: int, done: int,
                   grace: float = 5.0) -> Dict[int, str]:
    """The tracebacks of the ranks that fail within ``grace`` seconds after
    the first, added to ``failed``; stops early once every rank has
    answered."""
    deadline = time.monotonic() + grace
    while done + len(failed) < world and time.monotonic() < deadline:
        try:
            rank, ok, payload = results.get(timeout=0.5)
        except queue.Empty:
            continue
        if ok:
            done += 1
        else:
            failed[rank] = payload
    return failed


def run_ranks(fn: Callable, world: int, *args, device=None,
              timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args, device=rank_device)`` in ``world`` processes joined
    by a gloo group and return the results, rank 0's first.

    The processes are the launch's pool (``Pool``): an elastic trainer
    re-forms the process world over a subset of them and back
    (``reform``); when ``fn`` returns, every rank is in the full pool's
    world again.

    Processes start with the ``forkserver`` method: a server process,
    started on the first launch with torch and ``parallel.programs``
    imported and no device touched, forks each rank, so ``fn`` and ``args``
    are pickled: ``fn`` must be a module-level function of an importable
    module (never a test file, whose imports a child would repeat), and it
    should return host data (numbers, numpy arrays, CPU tensors). Each
    child runs with the caller's intra-op thread count. The rendezvous is
    a ``file://`` store in a fresh temporary directory, so concurrent
    launches cannot collide on a port. ``device`` is "cpu", or None for
    CUDA, where rank r drives ``cuda:(r % device_count)``; it is checked
    here first, so a missing card raises before any process starts.

    If a rank raises, this raises with its traceback and those of the
    ranks that fail within a few seconds after it (a failed rank makes its
    peers' collectives fail), then terminates the rest; a rank that dies
    without a result raises too, as does ``timeout`` (seconds) running
    out."""
    if world < 1:
        raise ValueError(f"world must be >= 1 (got {world})")
    rank_device(device, 0)
    ctx = mp.get_context("forkserver")
    # The server imports these once; every later launch of this process
    # forks from it instead of importing torch and the port again (seconds
    # per rank). Importing them initializes no device.
    ctx.set_forkserver_preload(["torch", __name__.rsplit(".", 1)[0]
                                + ".programs"])
    tmp = tempfile.mkdtemp(prefix="ddl-rendezvous-")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(fn, r, world, tmp, device, args, results,
              torch.get_num_threads()))
        for r in range(world)]
    out: Dict[int, Any] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} of {world} exited with "
                                           f"code {p.exitcode} and no result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world - len(out)} of "
                                       f"{world} ranks still running after "
                                       f"{timeout} s")
                continue
            if not ok:
                failed = _more_failures(results, {rank: payload}, world,
                                        len(out))
                raise RuntimeError("\n".join(
                    f"rank {r} of {world} raised:\n{tb}"
                    for r, tb in sorted(failed.items())))
            out[rank] = pickle.loads(payload)
    finally:
        for p in started:
            if len(out) < world and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


# ---------------------------------------------------------- the pool

@dataclass
class Pool:
    """This process's place in the pool of processes one ``run_ranks``
    launch started: its pool ``rank`` (fixed for the process's life), the
    pool's ``size``, the launch's rendezvous ``directory``, and the
    current topology ``epoch`` with its ``members`` (the pool ranks of the
    process world, in world-rank order).

    The process world is the default process group, so every collective,
    step factory and checkpoint of the package runs over the current world
    unchanged. An elastic re-mesh moves the pool to the next epoch
    (``reform``): the members leave the old group and join a fresh one
    named by the epoch, rank ``i`` being ``members[i]``; a rank outside the
    world holds no group and waits (``await_epoch``). Control records go
    through a file store in the rendezvous directory, apart from the
    process groups: ``post_epoch`` writes the next epoch's record (its
    members and whatever the joining ranks must know), which the ranks
    outside the world read in order."""

    rank: int
    size: int
    directory: str
    epoch: int = 0
    members: Tuple[int, ...] = ()
    _store: Any = None

    @property
    def store(self):
        if self._store is None:
            self._store = dist.FileStore(
                os.path.join(self.directory, "pool"), -1)
        return self._store

    def post_epoch(self, record: dict) -> None:
        """Write the record of epoch ``epoch + 1``; one rank posts it."""
        self.store.set(f"epoch-{self.epoch + 1}", json.dumps(record))

    def await_epoch(self, poll: float = 0.01) -> dict:
        """The record of epoch ``epoch + 1``, once a rank has posted it."""
        key = f"epoch-{self.epoch + 1}"
        while not self.store.check([key]):
            time.sleep(poll)
        return json.loads(self.store.get(key))


_POOL: Optional[Pool] = None


def pool() -> Optional[Pool]:
    """This process's ``Pool`` (None outside a ``run_ranks`` launch)."""
    return _POOL


def reform(members) -> None:
    """Move this process to the next topology epoch, whose world is
    ``members`` (pool ranks, in world-rank order): leave the current group
    and, as a member of a world above one, join the epoch's fresh group as
    rank ``members.index(pool rank)``. Every rank of the pool calls it for
    every epoch, members or not, so the epochs stay in step; the layouts
    made over the old group are dropped."""
    p = _POOL
    if p is None:
        raise RuntimeError("reform needs the pool of a run_ranks launch")
    members = tuple(int(m) for m in members)
    if is_initialized():
        dist.destroy_process_group()
    for cache in (_MESHES, _HIER, _TP, _AXIS):
        cache.clear()
    p.epoch += 1
    p.members = members
    if p.rank in members and len(members) > 1:
        dist.init_process_group(
            BACKEND, init_method="file://" + os.path.join(
                p.directory, f"world-{p.epoch}"),
            rank=members.index(p.rank), world_size=len(members),
            timeout=GROUP_TIMEOUT)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (any picklable value) on every rank of the
    process world (``obj`` itself at a world of one)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


# -------------------------------------------------------------- the mesh

@dataclass(frozen=True)
class Group:
    """The processes along one named axis of a process mesh: their global
    ranks in axis order, this process's ``index`` among them, and the
    gloo group joining them (None for a group of one, whose collectives
    start nothing)."""

    axis: str
    ranks: Tuple[int, ...]
    index: int
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class PipelineMesh:
    """A ``{"data": data, "stage": stage[, "model": model]}`` layout of the
    process group, in the JAX mesh's order: rank ``r = (d·stage + s)·model
    + m`` runs model shard ``m`` of stage ``s`` of data row ``d`` (``d·stage
    + s`` at ``model = 1``). ``stage_group`` joins this data row's stages
    at this model shard (the point-to-point hops and the loss broadcast),
    ``data_group`` this cell's replicas in every data row (the gradient
    mean, the ring), ``model_group`` this (data row, stage)'s model shards
    (the activation and replicated-gradient sums), and
    ``ring_model_group`` the same ranks on a gloo group of their own (the
    ring thread's int8 scale maxima, ``TPMesh``'s reason)."""

    data: int
    stage: int
    d: int
    s: int
    stage_group: Group
    data_group: Group
    model: int = 1
    m: int = 0
    model_group: Optional[Group] = None
    ring_model_group: Optional[Group] = None

    @property
    def shape(self) -> Dict[str, int]:
        out = {"data": self.data, "stage": self.stage}
        if self.model > 1:
            out["model"] = self.model
        return out


_MESHES: Dict[Tuple[int, int, int, int], PipelineMesh] = {}


@dataclass(frozen=True)
class HierMesh:
    """A ``{"dcn": dcn, "data": data}`` layout of the process group: ``dcn``
    islands of ``data`` replicas, island-major (rank ``r = d·data + s`` is
    replica ``s`` of island ``d``), as the JAX package's
    ``hier_data_mesh``. ``data_group`` joins this island's replicas (the
    fast, full-precision tier), ``dcn_group`` the replicas at this
    position in every island (the scarce tier)."""

    dcn: int
    data: int
    d: int
    s: int
    data_group: Group
    dcn_group: Group

    @property
    def shape(self) -> Dict[str, int]:
        return {"dcn": self.dcn, "data": self.data}


_HIER: Dict[Tuple[int, int, int], HierMesh] = {}


def hier_data_mesh(islands: int, island_size: int) -> HierMesh:
    """This process's place on an ``islands × island_size`` hierarchical
    data-parallel layout (a world of one without a group), with one gloo
    group per island (axis ``data``) and one per column (axis ``dcn``),
    made once per process and layout. Every rank must call it
    (``dist.new_group`` is collective). Raises unless the group has
    ``islands·island_size`` ranks."""
    n, rank = world_size(), get_rank()
    if islands < 1 or island_size < 1 or n != islands * island_size:
        raise ValueError(f"a dcn={islands} x data={island_size} layout needs "
                         f"{islands * island_size} ranks, the process group "
                         f"has {n}")
    key = (islands, island_size,
           id(dist.group.WORLD) if is_initialized() else 0)
    if key not in _HIER:
        isles = [tuple(d * island_size + s for s in range(island_size))
                 for d in range(islands)]
        cols = [tuple(d * island_size + s for d in range(islands))
                for s in range(island_size)]
        pgs = {}
        for ranks in isles + cols:     # the same order on every rank
            if len(ranks) > 1:
                pgs[ranks] = (dist.group.WORLD if len(ranks) == n else
                              dist.new_group(list(ranks), backend=BACKEND,
                                             timeout=GROUP_TIMEOUT))
        d, s = divmod(rank, island_size)
        _HIER[key] = HierMesh(islands, island_size, d, s,
                              Group("data", isles[d], s, pgs.get(isles[d])),
                              Group("dcn", cols[s], d, pgs.get(cols[s])))
    return _HIER[key]


@dataclass(frozen=True)
class TPMesh:
    """A ``{"data": data, "model": model}`` layout of the process group, in
    the JAX mesh's order: rank ``r = d·model + m`` runs model shard ``m`` of
    data row ``d``. ``model_group`` joins this data row's shards (the
    activation and replicated-gradient sums), ``data_group`` this shard's
    replicas in every data row (the gradient sync), and
    ``ring_model_group`` this data row's shards again, on a gloo group of
    its own, for the int8 scale maxima the ring thread takes while the main
    thread sums activations over ``model_group``."""

    data: int
    model: int
    d: int
    m: int
    model_group: Group
    data_group: Group
    ring_model_group: Group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


_TP: Dict[Tuple[int, int, int], TPMesh] = {}


def tp_mesh(data: int, model: int) -> TPMesh:
    """This process's place on a ``data × model`` mesh over the process
    group (a world of one without a group), with one gloo group per data
    row, one per model column and a second one per data row, made once per
    process and layout. Every rank must call it (``dist.new_group`` is
    collective). Raises unless the group has ``data·model`` ranks."""
    n, rank = world_size(), get_rank()
    if data < 1 or model < 1 or n != data * model:
        raise ValueError(f"a data={data} x model={model} mesh needs "
                         f"{data * model} ranks, the process group has {n}")
    key = (data, model, id(dist.group.WORLD) if is_initialized() else 0)
    if key not in _TP:
        rows = [tuple(d * model + m for m in range(model))
                for d in range(data)]
        cols = [tuple(d * model + m for d in range(data))
                for m in range(model)]
        pgs, ring = {}, {}
        for ranks in rows + cols:      # the same order on every rank
            if len(ranks) > 1:
                pgs[ranks] = dist.new_group(list(ranks), backend=BACKEND,
                                            timeout=GROUP_TIMEOUT)
        for ranks in rows:
            if len(ranks) > 1:
                ring[ranks] = dist.new_group(list(ranks), backend=BACKEND,
                                             timeout=GROUP_TIMEOUT)
        d, m = divmod(rank, model)
        _TP[key] = TPMesh(
            data, model, d, m,
            Group("model", rows[d], m, pgs.get(rows[d])),
            Group("data", cols[m], d, pgs.get(cols[m])),
            Group("model", rows[d], m, ring.get(rows[d])))
    return _TP[key]


@dataclass(frozen=True)
class AxisMesh:
    """A ``{"data": data, axis: size}`` layout of the process group, in the
    JAX mesh's order (data before seq and expert): rank ``r = d·size + i``
    is index ``i`` along ``axis`` in data row ``d``. ``group`` joins this
    data row's ranks along ``axis`` (the ring of sequence parallelism, the
    expert bank's shards), ``data_group`` this index's replicas in every
    data row (the gradient mean)."""

    axis: str
    data: int
    size: int
    d: int
    i: int
    group: Group
    data_group: Group

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, self.axis: self.size}

    def row(self) -> "AxisMesh":
        """This data row alone, as a mesh of one data row: the same
        ``axis`` group, no data axis (every row runs on its own)."""
        return AxisMesh(self.axis, 1, self.size, 0, self.i, self.group,
                        Group("data", (get_rank(),), 0))


_AXIS: Dict[Tuple[str, int, int, int], AxisMesh] = {}


def axis_mesh(axis: str, data: int, size: int) -> AxisMesh:
    """This process's place on a ``data × size`` mesh over the process
    group whose inner axis is ``axis`` (a world of one without a group),
    with one gloo group per data row and one per column, made once per
    process and layout. Every rank must call it (``dist.new_group`` is
    collective). Raises unless the group has ``data·size`` ranks."""
    n, rank = world_size(), get_rank()
    if data < 1 or size < 1 or n != data * size:
        raise ValueError(f"a data={data} x {axis}={size} mesh needs "
                         f"{data * size} ranks, the process group has {n}")
    key = (axis, data, size, id(dist.group.WORLD) if is_initialized() else 0)
    if key not in _AXIS:
        rows = [tuple(d * size + i for i in range(size)) for d in range(data)]
        cols = [tuple(d * size + i for d in range(data)) for i in range(size)]
        pgs = {}
        for ranks in rows + cols:      # the same order on every rank
            if len(ranks) > 1:
                pgs[ranks] = dist.new_group(list(ranks), backend=BACKEND,
                                            timeout=GROUP_TIMEOUT)
        d, i = divmod(rank, size)
        _AXIS[key] = AxisMesh(axis, data, size, d, i,
                              Group(axis, rows[d], i, pgs.get(rows[d])),
                              Group("data", cols[i], d, pgs.get(cols[i])))
    return _AXIS[key]


def seq_mesh(data: int, seq: int) -> AxisMesh:
    """``axis_mesh("seq", data, seq)``: sequence parallelism's layout."""
    return axis_mesh("seq", data, seq)


def expert_mesh(data: int, expert: int) -> AxisMesh:
    """``axis_mesh("expert", data, expert)``: expert parallelism's
    layout."""
    return axis_mesh("expert", data, expert)


def local_mesh(axis: str) -> AxisMesh:
    """A world of one on ``axis`` inside any process group: groups of this
    rank alone, whose collectives start nothing (a reference computation
    beside a mesh's)."""
    me = (get_rank(),)
    return AxisMesh(axis, 1, 1, 0, 0, Group(axis, me, 0),
                    Group("data", me, 0))


def data_group() -> Group:
    """Every rank of the process group as one ``data`` axis (a group of one
    without a process group)."""
    n = world_size()
    return Group("data", tuple(range(n)), get_rank(),
                 dist.group.WORLD if n > 1 else None)


def pipeline_mesh(data: int, stage: int, model: int = 1) -> PipelineMesh:
    """This process's place on a ``data × stage [× model]`` mesh over the
    process group (a world of one without a group), made once per process
    and layout. Every rank must call it (``dist.new_group`` is collective),
    and every rank makes the groups in one order: one per (data row, model
    shard) along ``stage``, one per (stage, model shard) along ``data``,
    then, above ``model = 1`` only, one per (data row, stage) along
    ``model`` and a second such set for the ring thread. So a 2-axis
    layout makes exactly the groups it always did. Raises unless the group
    has ``data·stage·model`` ranks."""
    n, rank = world_size(), get_rank()
    if data < 1 or stage < 1 or model < 1 or n != data * stage * model:
        axes = f"data={data} x stage={stage}" + (
            f" x model={model}" if model != 1 else "")
        raise ValueError(f"a {axes} mesh needs {data * stage * model} "
                         f"ranks, the process group has {n}")
    key = (data, stage, model,
           id(dist.group.WORLD) if is_initialized() else 0)
    if key not in _MESHES:
        def at(d, s, m):
            return (d * stage + s) * model + m

        rows = {(d, m): tuple(at(d, s, m) for s in range(stage))
                for d in range(data) for m in range(model)}
        cols = {(s, m): tuple(at(d, s, m) for d in range(data))
                for s in range(stage) for m in range(model)}
        shards = {(d, s): tuple(at(d, s, m) for m in range(model))
                  for d in range(data) for s in range(stage)}
        pgs, ring = {}, {}
        # The same order on every rank.
        for ranks in list(rows.values()) + list(cols.values()):
            if len(ranks) > 1:
                pgs[ranks] = dist.new_group(list(ranks), backend=BACKEND,
                                            timeout=GROUP_TIMEOUT)
        for table in (pgs, ring):
            for ranks in shards.values():
                if len(ranks) > 1:
                    table[ranks] = dist.new_group(
                        list(ranks), backend=BACKEND, timeout=GROUP_TIMEOUT)
        cell, m = divmod(rank, model)
        d, s = divmod(cell, stage)
        mine = shards[(d, s)]
        _MESHES[key] = PipelineMesh(
            data, stage, d, s,
            Group("stage", rows[(d, m)], s, pgs.get(rows[(d, m)])),
            Group("data", cols[(s, m)], d, pgs.get(cols[(s, m)])),
            model, m, Group("model", mine, m, pgs.get(mine)),
            Group("model", mine, m, ring.get(mine)))
    return _MESHES[key]


# --------------------------------------------------------------- collectives
# Each collective records its operand's bytes under its call site's
# ``label`` into the active ``telemetry.comm.collecting()`` list (nothing
# without one), at a world of one too, as the JAX package's wrappers do.
# ``group`` (a ``Group``) runs it over one mesh axis; None means every rank
# of the process group, recorded as the ``data`` axis.

def _size(group: Optional[Group]) -> int:
    return world_size() if group is None else group.size


def _record(op: str, label: Optional[str], x, group: Optional[Group]):
    if group is None:
        _comm.record(op, label, x)
    else:
        _comm.record(op, label, x, axis=group.axis, axis_size=group.size)


def _all_reduce_sum(x: torch.Tensor,
                    group: Optional[Group] = None) -> torch.Tensor:
    if _size(group) == 1:
        return x
    y = x.detach().clone()
    with _named(group, "all_reduce"):
        dist.all_reduce(y, group=None if group is None else group.pg)
    return y


def psum(x: torch.Tensor, *, label: Optional[str] = None,
         record: bool = True, group: Optional[Group] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, as a new tensor (``x`` itself at a
    world of one)."""
    if record:
        _record("psum", label, x, group)
    return _all_reduce_sum(x, group)


def pmean(x: torch.Tensor, *, label: Optional[str] = None,
          group: Optional[Group] = None) -> torch.Tensor:
    """The mean of ``x`` over the ranks: the sum divided by the world
    size (``x`` itself at a world of one)."""
    _record("pmean", label, x, group)
    n = _size(group)
    return x if n == 1 else _all_reduce_sum(x, group) / n


def pmean_tree(tree, *, label: Optional[str] = None, record: bool = True,
               group: Optional[Group] = None):
    """``pmean`` of every leaf of a tree (nested dicts and lists of
    tensors), one all-reduce per dtype over the leaves' concatenation.
    Returns a new tree of ``tree``'s structure (``tree`` itself at a world
    of one). Recorded as one collective of the whole tree, as the JAX
    package's ``pmean`` of a tree is."""
    if record:
        _record("pmean", label, tree, group)
    return _reduce_tree(tree, group, mean=True)


def psum_tree(tree, *, label: Optional[str] = None, record: bool = True,
              group: Optional[Group] = None):
    """``psum`` of every leaf of a tree, as ``pmean_tree``."""
    if record:
        _record("psum", label, tree, group)
    return _reduce_tree(tree, group, mean=False)


def _reduce_tree(tree, group: Optional[Group], mean: bool):
    n = _size(group)
    if n == 1:
        return tree
    leaves = tree_leaves(tree)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        with _named(group, "all_reduce"):
            dist.all_reduce(flat, group=None if group is None else group.pg)
        if mean:
            flat /= n
        for i, piece in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return tree_unflatten(tree, out)


def _sum_over(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` as a new tensor: gloo on the tensor
    itself in fp32; any other dtype (gloo is not known to sum bf16 on
    CUDA) is staged to the host in fp32, summed there and rounded back
    once, which at two ranks is the bf16 add itself."""
    if group.size == 1:
        return x
    if x.dtype == torch.float32:
        return _all_reduce_sum(x, group)
    host = x.detach().to("cpu", torch.float32)
    with _named(group, "all_reduce"):
        dist.all_reduce(host, group=group.pg)
    return host.to(device=x.device, dtype=x.dtype)


def psum_each(tensors: List[torch.Tensor], group: Group, *,
              label: str) -> List[torch.Tensor]:
    """Each tensor's sum over ``group``, recorded as its own ``psum``
    under ``label`` (the JAX package's per-leaf call), all carried by one
    sum per dtype over their concatenation (``_sum_over``)."""
    for x in tensors:
        _record("psum", label, x, group)
    if group.size == 1:
        return list(tensors)
    out: List[torch.Tensor] = [None] * len(tensors)
    for dtype in dict.fromkeys(x.dtype for x in tensors):
        ids = [i for i, x in enumerate(tensors) if x.dtype == dtype]
        flat = _sum_over(torch.cat([tensors[i].reshape(-1) for i in ids]),
                         group)
        for i, piece in zip(ids, flat.split([tensors[i].numel()
                                             for i in ids])):
            out[i] = piece.view(tensors[i].shape)
    return out


class _PsumAD(torch.autograd.Function):
    """``lax.psum`` over a ``Group`` as autograd sees it under
    ``shard_map(check_vma=False)``: forward and backward are both the
    sum over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _sum_over(ct.contiguous(), ctx.group), None


def psum_ad(x: torch.Tensor, group: Group, *,
            label: Optional[str] = None) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable: its gradient is the
    sum of the cotangents over the group (the tensor-parallel f/g pair of
    the JAX model). With ``label`` the forward sum is recorded (the
    backward's never is, as the JAX package's trace-time accounting cannot
    see autodiff's transposes); without one nothing is, the raw
    in-model ``lax.psum``."""
    if label is not None:
        _record("psum", label, x, group)
    if group.size == 1:
        return x
    return _PsumAD.apply(x, group)


def pmax(x: torch.Tensor, *, label: Optional[str] = None,
         record: bool = True, group: Optional[Group] = None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (``x`` itself at a
    world of one), reduced on a host copy."""
    if record:
        _record("pmax", label, x, group)
    if _size(group) == 1:
        return x
    host = x.detach().to("cpu", copy=True)
    with _named(group, "all_reduce(max)"):
        dist.all_reduce(host, op=dist.ReduceOp.MAX,
                        group=None if group is None else group.pg)
    return host.to(x.device)


def psum_scatter(flat: torch.Tensor, *,
                 label: Optional[str] = None) -> torch.Tensor:
    """This rank's ``1/n`` slice of the sum of the 1-D ``flat`` over the
    ranks (its length must divide by the world size): the all-reduce, then
    the slice."""
    n, r = world_size(), get_rank()
    if flat.dim() != 1 or flat.numel() % n:
        raise ValueError(f"psum_scatter takes a 1-D tensor whose length "
                         f"divides by {n}, got shape {tuple(flat.shape)}")
    _comm.record("psum_scatter", label, flat)
    local = flat.numel() // n
    return _all_reduce_sum(flat)[r * local:(r + 1) * local].clone()


def all_gather(piece: torch.Tensor, *, label: Optional[str] = None,
               group: Optional[Group] = None) -> torch.Tensor:
    """The ranks' 1-D slices concatenated in rank order. Over the process
    group (``group`` None): an all-reduce of a zero buffer in which this
    rank has written its own. Over a ``Group``: gloo's all-gather of a host
    copy, in the piece's own dtype (int8 and bf16 wire formats too), in
    the group's index order (``piece`` itself for a group of one)."""
    if group is not None:
        _record("all_gather", label, piece, group)
        if group.size == 1:
            return piece
        host = piece.detach().to("cpu").contiguous()
        parts = [torch.empty_like(host) for _ in range(group.size)]
        with _named(group, "all_gather"):
            dist.all_gather(parts, host, group=group.pg)
        return torch.cat([p.reshape(-1) for p in parts]).to(piece.device)
    _comm.record("all_gather", label, piece)
    n, r = world_size(), get_rank()
    if n == 1:
        return piece
    local = piece.numel()
    buf = torch.zeros(n * local, dtype=piece.dtype, device=piece.device)
    buf[r * local:(r + 1) * local] = piece.reshape(-1)
    dist.all_reduce(buf)
    return buf


def broadcast(x: torch.Tensor, src: int = 0, *,
              label: Optional[str] = None) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, as a new tensor (``x`` itself at
    a world of one)."""
    _comm.record("broadcast", label, x)
    if world_size() == 1:
        return x
    y = x.detach().clone()
    dist.broadcast(y, src)
    return y


def barrier(device) -> None:
    """Wait until every rank gets here: an all-reduce of one element on
    ``device`` and a host read of it."""
    if world_size() > 1:
        float(_all_reduce_sum(torch.ones((), device=device)))


# ---------------------------------------------------- point-to-point hops
# gloo's send and recv take CPU tensors only: a hop of a CUDA tensor is a
# device→host copy, gloo over loopback TCP, and a host→device copy on the
# receiving side. A send completes once its receiver has posted the
# matching receive, so a schedule posts its sends without waiting
# (``isend``) and waits for all of them at its end (``Hops.finish``).
# ``to`` and ``frm`` are indices along ``group``; every wait gives up
# after ``GROUP_TIMEOUT``. Each send records its bytes under ``label``
# (op ``ppermute``, the JAX package's, on the group's axis).

def isend(x: torch.Tensor, to: int, *, tag: int, label: str,
          group: Group, record: bool = True) -> Callable[[], None]:
    """Post an asynchronous send of ``x`` to ``group.ranks[to]`` with
    ``tag``; returns the wait, which holds the staged copy alive."""
    if record:
        _record("ppermute", label, x, group)
    host = x.detach().to("cpu").contiguous()
    work = dist.isend(host, group.ranks[to], group=group.pg, tag=tag)

    def wait(staged: torch.Tensor = host) -> None:
        with _named(group, f"send (tag {tag}) to index {to}"):
            work.wait(GROUP_TIMEOUT)

    return wait


def irecv(frm: int, shape, dtype: torch.dtype, *, tag: int, group: Group,
          device) -> Callable[[], torch.Tensor]:
    """Post an asynchronous receive from ``group.ranks[frm]`` with ``tag``;
    returns the wait, which gives the tensor on ``device``."""
    host = torch.empty(tuple(shape), dtype=dtype)
    work = dist.irecv(host, group.ranks[frm], group=group.pg, tag=tag)

    def wait() -> torch.Tensor:
        with _named(group, f"receive (tag {tag}) from index {frm}"):
            work.wait(GROUP_TIMEOUT)
        return host.to(device)

    return wait


def send(x: torch.Tensor, to: int, *, tag: int, label: str,
         group: Group) -> None:
    """``isend`` and its wait."""
    isend(x, to, tag=tag, label=label, group=group)()


def recv(frm: int, shape, dtype: torch.dtype, *, tag: int, group: Group,
         device) -> torch.Tensor:
    """``irecv`` and its wait."""
    return irecv(frm, shape, dtype, tag=tag, group=group, device=device)()


RING_TAG = 7    # every ring shift completes before the next starts


def ppermute(x: torch.Tensor, *, label: str, group: Group) -> torch.Tensor:
    """The ring shift ``lax.ppermute`` with ``perm = [(i, (i+1) % n)]`` over
    ``group``: send ``x`` to index ``i + 1``, receive the tensor of index
    ``i − 1`` (same shape and dtype) on ``x``'s device. Both hops are
    posted before either is waited on, so the ring cannot deadlock, and
    both are complete on return. Records op ``ppermute`` with ``x``'s
    bytes in its own dtype on the group's axis."""
    n, i = group.size, group.index
    if n == 1:
        _record("ppermute", label, x, group)
        return x
    shape = x.shape
    wait_send = isend(x.reshape(-1), (i + 1) % n, tag=RING_TAG, label=label,
                      group=group)
    got = irecv((i - 1) % n, (x.numel(),), x.dtype, tag=RING_TAG,
                group=group, device=x.device)()
    wait_send()
    return got.reshape(shape)


def _ring_exchange(xs: Tuple[torch.Tensor, ...], group: Group, step: int,
                   tag: int) -> Tuple[torch.Tensor, ...]:
    """Send each of ``xs`` to index ``i + step`` of ``group`` and receive
    the same shapes from ``i − step``, unrecorded: every send and receive
    posted before any is waited on, tensor ``j`` under tag ``tag + j``."""
    n, i = group.size, group.index
    sends = [isend(x.reshape(-1), (i + step) % n, tag=tag + j, label="",
                   group=group, record=False) for j, x in enumerate(xs)]
    recvs = [irecv((i - step) % n, (x.numel(),), x.dtype, tag=tag + j,
                   group=group, device=x.device) for j, x in enumerate(xs)]
    got = tuple(wait().reshape(x.shape) for wait, x in zip(recvs, xs))
    for wait in sends:
        wait()
    return got


class _RingShiftAD(torch.autograd.Function):
    """``lax.ppermute`` with ``perm = [(i, (i+1) % n)]`` as autograd sees
    it: the forward shifts every tensor to the next index, the backward
    shifts the cotangents back (the inverse permutation, ppermute's
    transpose). The tensors travel in one node, so the backward's shifts
    come in one order on every rank; the forward's and the backward's
    hops carry tags of their own."""

    @staticmethod
    def forward(ctx, group, tag, *xs):
        ctx.group, ctx.tag, ctx.n = group, tag, len(xs)
        return _ring_exchange(xs, group, +1, tag)

    @staticmethod
    def backward(ctx, *cts):
        back = _ring_exchange(tuple(c.contiguous() for c in cts), ctx.group,
                              -1, ctx.tag + ctx.n)
        return (None, None) + back


def ppermute_ad(xs: Tuple[torch.Tensor, ...], group: Group, *, label: str,
                tag: int) -> Tuple[torch.Tensor, ...]:
    """The ring shift of ``ppermute`` for several tensors at once,
    differentiable: each tensor goes to index ``i + 1`` of ``group`` and
    the tensors of ``i − 1`` come back; the gradient shifts the
    cotangents the other way. Each forward send is recorded (op
    ``ppermute``, its bytes in its own dtype, under ``label``); the
    backward's never are, as the JAX package's trace-time accounting
    cannot see autodiff's transposes. ``tag`` must differ between the
    shifts of one step, by ``2·len(xs)`` at least: the forward uses ``tag
    + j``, the backward ``tag + len(xs) + j``."""
    for x in xs:
        _record("ppermute", label, x, group)
    if group.size == 1:
        return tuple(xs)
    return _RingShiftAD.apply(group, tag, *xs)


class Hops:
    """The point-to-point hops of one pipeline step along ``group`` (a
    ``stage`` axis): ``send`` posts an ``isend`` and keeps its wait,
    ``recv`` receives and waits, ``finish`` waits for every send. A tag is
    unique per (sender, receiver) within the step. A hop from a stage to
    itself (one stage, interleaved) is handed over in memory and recorded
    alike."""

    def __init__(self, group: Group, device):
        self.group = group
        self.device = torch.device(device)
        self._sends: List[Callable[[], None]] = []
        self._local: Dict[int, torch.Tensor] = {}

    def send(self, x: torch.Tensor, to: int, *, tag: int,
             label: str) -> None:
        if to == self.group.index:
            _record("ppermute", label, x, self.group)
            self._local[tag] = x.detach().clone()
        else:
            self._sends.append(isend(x, to, tag=tag, label=label,
                                     group=self.group))

    def recv(self, frm: int, shape, dtype: torch.dtype, *,
             tag: int) -> torch.Tensor:
        if frm == self.group.index:
            return self._local.pop(tag)
        return recv(frm, shape, dtype, tag=tag, group=self.group,
                    device=self.device)

    def finish(self) -> None:
        for wait in self._sends:
            wait()
        self._sends.clear()
