"""The elastic re-mesh's topology rules: counterpart of the JAX package's
``parallel/mesh.py`` (``survivor_submesh``, ``rejoin_mesh`` and their
helpers).

The JAX package re-meshes devices inside one process. The port's replicas
are processes, started once as a pool by ``distributed.run_ranks``, so a
``PoolMesh`` lays out pool ranks where the JAX mesh lays out devices: a
numpy array of pool ranks with named axes, flat in data-major order. The
functions below are the JAX ones on that array, with their texts: the
survivors of a loss keep their relative order, and a rejoin with the pool
restores pool order, so a 4 → 3 → 4 round trip lands every rank back in
its original replica slot. ``distributed.reform`` then makes the chosen
ranks the process world, rank ``i`` being the ``i``-th pool rank of the
mesh.

The trainer re-meshes data-only meshes. ``_elastic_second_axis`` keeps
the JAX refusals of the mesh shapes no elastic trainer supports; a real
``stage`` or ``model`` axis raises ``NotImplementedError`` until the
elastic pipeline and tensor-parallel trainers bring its rules.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class PoolMesh:
    """Pool ranks laid out on named axes: ``devices`` (an integer array,
    one axis per name) and ``axis_names``, the JAX ``Mesh``'s two
    fields."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d ranks for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(s) for s in self.devices.shape)))

    @property
    def members(self) -> Tuple[int, ...]:
        """The pool ranks in data-major order: the process world's rank
        order."""
        return tuple(int(r) for r in self.devices.flatten())

    def __eq__(self, other) -> bool:
        return (isinstance(other, PoolMesh)
                and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __repr__(self) -> str:
        return f"PoolMesh({self.shape}, ranks={list(self.members)})"


def data_mesh(members: Sequence[int]) -> PoolMesh:
    """A data-only mesh over ``members`` (pool ranks, in world order)."""
    return PoolMesh(list(members), ("data",))


def _elastic_second_axis(mesh: PoolMesh, who: str) -> Optional[str]:
    """The one non-``data`` axis an elastic re-mesh may carry along —
    ``stage`` (DPxPP) or ``model`` (DPxTP) — or None for the classic
    data-only mesh. Every other axis must be size 1, and composing BOTH a
    real stage and a real model axis with elasticity is out of scope (one
    non-data axis at a time)."""
    names = mesh.axis_names
    for name in names:
        if name not in ("data", "stage", "model") and mesh.shape[name] > 1:
            raise ValueError(
                f"{who} supports data/stage/model mesh axes only; "
                f"axis {name!r} has size {mesh.shape[name]}")
    if mesh.shape.get("stage", 1) > 1 and mesh.shape.get("model", 1) > 1:
        raise ValueError(
            f"{who}: a 3-axis (data x stage x model) mesh has no "
            "supported survivor topology — elastic recovery composes "
            "over one non-data axis at a time")
    if "stage" in names:
        return "stage"
    if "model" in names:
        return "model"
    return None


def survivor_submesh(mesh: PoolMesh, lost: Sequence[int]) -> PoolMesh:
    """The data mesh that remains after losing the replicas at positions
    ``lost``; surviving ranks keep their relative order, so replica ``i``
    of the new mesh is the ``i``-th survivor of the old one."""
    _data_only(mesh, "survivor_submesh")
    total = mesh.shape.get("data", 1)
    lost = sorted(set(int(i) for i in lost))
    if any(i < 0 or i >= total for i in lost):
        raise ValueError(f"lost replicas {lost} out of range for "
                         f"{dict(mesh.shape)}")
    if len(lost) >= total:
        raise ValueError(f"losing {len(lost)} of {total} devices leaves no "
                         "survivors — nothing to re-mesh onto")
    return PoolMesh([d for i, d in enumerate(mesh.members) if i not in lost],
                    ("data",))


def rejoin_mesh(mesh: PoolMesh, returned: Sequence[int], *,
                pool: Optional[Sequence[int]] = None) -> PoolMesh:
    """The data mesh after the pool ranks ``returned`` come back: the
    inverse of ``survivor_submesh``. With ``pool`` (the run's original
    ranks) the merged ranks take their pool order, so a full rejoin
    rebuilds the original order; without it the returned ranks append at
    the end. Rejoining a rank already in the mesh raises (it would alias
    two replicas onto one process)."""
    _data_only(mesh, "rejoin_mesh")
    returned = [int(r) for r in returned]
    if not returned:
        raise ValueError("rejoin_mesh needs at least one returned device")
    if len(set(returned)) != len(returned):
        raise ValueError(f"returned devices contain duplicates: {returned}")
    current = list(mesh.members)
    for d in returned:
        if d in current:
            raise ValueError(f"device {d} is already in the mesh — "
                             "rejoining it would alias two replicas")
    ranks = current + returned
    if pool is not None:
        index = {int(d): i for i, d in enumerate(pool)}
        missing = [d for d in ranks if d not in index]
        if missing:
            raise ValueError(f"devices {missing} are not in the original "
                             "pool — rejoin_mesh can only restore capacity "
                             "the run started with")
        ranks = sorted(ranks, key=lambda d: index[d])
    return PoolMesh(ranks, ("data",))


def _data_only(mesh: PoolMesh, who: str) -> None:
    """Raise unless ``mesh`` is the data-only mesh the trainer re-meshes:
    ``_elastic_second_axis``'s refusals first, then a refusal of a real
    ``stage`` or ``model`` axis, whose re-mesh rules (row drop, stage
    re-partition) come with the elastic pipeline and tensor-parallel
    trainers."""
    second = _elastic_second_axis(mesh, who)
    if second is not None and mesh.shape[second] > 1:
        raise NotImplementedError(
            f"{who}: a {second!r} axis of size {mesh.shape[second]} — the "
            "elastic re-mesh of pipeline and tensor-parallel meshes is "
            "ROADMAP.md queue A item 8e-3")
