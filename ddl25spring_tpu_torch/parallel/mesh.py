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

A 2-axis mesh (``(data, stage)`` for the pipeline trainer, ``(data,
model)`` for the tensor-parallel one) re-meshes by JAX's rules: a data-row
drop when a complete row survives, else a stage re-partition to the
largest stage count that divides the model's layers; a model-axis loss is
fatal. ``_elastic_second_axis`` keeps the JAX refusals of the mesh shapes
no elastic trainer supports.
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


def _mesh_from_flat(mesh: PoolMesh, ranks, n_data: int,
                    second: Optional[str], second_size: int) -> PoolMesh:
    """A mesh with ``mesh``'s axis names from a flat (data-major) rank
    list, ``data`` resized to ``n_data`` and the second axis to
    ``second_size`` (every other axis stays at size 1)."""
    if second is None:
        return PoolMesh(list(ranks), ("data",))
    shape = tuple(n_data if a == "data"
                  else (second_size if a == second else 1)
                  for a in mesh.axis_names)
    return PoolMesh(np.asarray(list(ranks)).reshape(shape), mesh.axis_names)


def _largest_stage_divisor(n_layers: int, cap: int) -> int:
    """The largest stage count ``S' <= cap`` with ``S' | n_layers``: the
    factorization choice of a layer re-partition. ``S' = 1`` always
    qualifies, so this only fails on a non-positive cap."""
    for s in range(min(int(cap), int(n_layers)), 0, -1):
        if n_layers % s == 0:
            return s
    raise ValueError(f"no stage count <= {cap} divides n_layers={n_layers}")


def _second_size(mesh: PoolMesh, second: Optional[str]) -> int:
    return int(np.prod([s for a, s in mesh.shape.items() if a != "data"],
                       dtype=int)) if second is not None else 1


def survivor_submesh(mesh: PoolMesh, lost: Sequence[int], *,
                     layer_divisor: Optional[int] = None) -> PoolMesh:
    """The mesh that remains after losing the ranks at positions ``lost``;
    surviving ranks keep their relative order, so replica ``i`` of the new
    mesh is the ``i``-th survivor of the old one.

    On a data-only mesh ``lost`` indexes replicas. On a 2-axis mesh
    (``(data, stage)`` or ``(data, model)``) it indexes the flat
    (data-major) grid, and the survivor topology is chosen per axis:

    - **data shrink** (preferred): every victim's data row is dropped
      whole; the victims' column partners in the surviving rows hold the
      same shards, so the recovery is a pure reshard at the same stage or
      model count;
    - **stage re-partition**: when no complete data row survives, a
      ``stage`` mesh re-partitions the layers over the survivors: the new
      stage count is the largest ``S'`` that divides ``layer_divisor``
      (the model's ``n_layers``, required here) and fits the surviving
      rank count, and the remaining survivors fill ``S'``-wide data rows.
      A ``model`` mesh has no such fallback (the Megatron column/row
      layout is not layer-sliced) and raises instead."""
    second = _elastic_second_axis(mesh, "survivor_submesh")
    n_data = mesh.shape.get("data", 1)
    s2 = _second_size(mesh, second)
    total = n_data * s2
    lost = sorted(set(int(i) for i in lost))
    if any(i < 0 or i >= total for i in lost):
        noun = "replicas" if second is None else "devices"
        raise ValueError(f"lost {noun} {lost} out of range for "
                         f"{dict(mesh.shape)}")
    if len(lost) >= total:
        raise ValueError(f"losing {len(lost)} of {total} devices leaves no "
                         "survivors — nothing to re-mesh onto")
    flat = list(mesh.members)
    if second is None:
        return PoolMesh([d for i, d in enumerate(flat) if i not in lost],
                        ("data",))
    victim_rows = {i // s2 for i in lost}
    surviving_rows = [r for r in range(n_data) if r not in victim_rows]
    if surviving_rows:
        return _mesh_from_flat(mesh, [flat[r * s2 + c]
                                      for r in surviving_rows
                                      for c in range(s2)],
                               len(surviving_rows), second, s2)
    survivors = [d for i, d in enumerate(flat) if i not in lost]
    if second == "model":
        raise ValueError(
            f"device loss left no complete data row of the "
            f"{dict(mesh.shape)} mesh intact, and the model axis cannot "
            "re-partition (the Megatron column/row layout is not "
            "layer-sliced) — a model-axis loss is unrecoverable")
    if layer_divisor is None:
        raise ValueError(
            "stage re-partition needs layer_divisor (the model's "
            "n_layers) to choose a stage count S' with S' | n_layers — "
            "pass it through ElasticController(layer_divisor=...)")
    new_s = _largest_stage_divisor(int(layer_divisor),
                                   min(len(survivors), s2))
    new_d = len(survivors) // new_s
    return _mesh_from_flat(mesh, survivors[:new_d * new_s], new_d, second,
                           new_s)


def rejoin_mesh(mesh: PoolMesh, returned: Sequence[int], *,
                pool: Optional[Sequence[int]] = None,
                pool_shape: Optional[Sequence[int]] = None,
                layer_divisor: Optional[int] = None) -> PoolMesh:
    """The mesh after the pool ranks ``returned`` come back: the inverse
    of ``survivor_submesh``. With ``pool`` (the run's original ranks) the
    merged ranks take their pool order, so a full rejoin rebuilds the
    original order; without it the returned ranks append at the end.
    Rejoining a rank already in the mesh raises (it would alias two
    replicas onto one process).

    On a 2-axis mesh ``pool_shape`` is the run's original grid shape: a
    full rejoin reshapes the pool-ordered ranks straight back into it (a
    stage re-partition grows back to the original stage count). A partial
    rejoin on a ``stage`` mesh re-runs the factorization choice (the
    largest ``S' | layer_divisor`` that fits, capped by the original
    stage count); on a ``model`` mesh the model degree is fixed and the
    data axis takes whole rows."""
    second = _elastic_second_axis(mesh, "rejoin_mesh")
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
    if second is None:
        return PoolMesh(ranks, ("data",))
    if pool_shape is not None and len(ranks) == int(np.prod(pool_shape)):
        return PoolMesh(np.asarray(ranks).reshape(tuple(pool_shape)),
                        mesh.axis_names)
    s2 = _second_size(mesh, second)
    if second == "model":
        new_s = s2                  # the Megatron degree never changes
    else:
        cap = s2
        if pool_shape is not None:
            # Partial rejoins never exceed the run's original stage count:
            # the full-pool reshape above is the only way back to it.
            cap = int(pool_shape[mesh.axis_names.index("stage")])
        if layer_divisor is None:
            raise ValueError(
                "a partial rejoin onto a stage mesh re-runs the "
                "factorization choice and needs layer_divisor (the "
                "model's n_layers)")
        new_s = _largest_stage_divisor(int(layer_divisor),
                                       min(len(ranks), cap))
    new_d = len(ranks) // new_s
    if new_d < 1:
        raise ValueError(f"{len(ranks)} devices cannot host a "
                         f"{second}={new_s} mesh")
    return _mesh_from_flat(mesh, ranks[:new_d * new_s], new_d, second,
                           new_s)
