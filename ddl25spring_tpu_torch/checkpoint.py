"""Checkpoint and resume: counterpart of the JAX package's ``checkpoint.py``
(``Checkpointer``, ``save_best``, ``load_best``), in torch's file format
where the JAX package writes orbax directories.

One file per step, ``<dir>/<step>.pt``: the state's tensor leaves, in
``tree.nested_leaves`` order, as CPU tensors, written to a temporary name
and renamed into place, so a kill mid-write leaves no partial step. In a
process group every rank calls ``save``: a ZeRO-1 state's moment slices
are gathered into the padded flat vector that JAX's orbax saves
(``parallel.dp.host_snapshot``), a pipeline stage's parameters and
moments into the whole model's JAX-layout state (``parallel.pp.
host_snapshot``, the file a data-parallel state of the model writes), a
tensor-parallel rank's slices into the JAX global layout with the per-rank
residuals and ZeRO-1 moments stacked ``[n_data, tp, ...]``
(``parallel.tp.host_snapshot``), rank 0 alone writes, and a barrier ends
the call. Every rank reads on ``restore``; a stage or a tensor-parallel
rank re-slices its own part (``parallel.pp.slice_state``,
``parallel.tp.slice_state``).

The JAX package's contract is kept:

- each step has a manifest ``<dir>/digests/<step>.json`` with the file's
  SHA-256 digest and every saved leaf's shape and dtype;
- ``restore`` verifies the digest first: a corrupt or unreadable newest
  step is skipped for the newest one that verifies, counted in
  ``stats.ckpt_fallbacks``, and ``restored_step`` says which step won (an
  explicitly requested step does not fall back);
- a step saved at another world size (a ZeRO-1 state, or the ring
  step's state with its error-feedback residuals, saved at world N,
  restored at M) is placed through ``parallel.dp.reshard_state``
  (``resize_zero_padded`` and the ring-residual rule; a non-zero
  truncated tail raises), counted in ``stats.ckpt_reshards``;
- writes go through ``retry_call`` (retries counted in ``stats.retries``),
  and so do reads, on ``OSError``.

Saves are synchronous, so ``wait`` has nothing to wait for; it stays for
the surface.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .metrics import ResilienceStats
from .parallel import distributed as dist
from .parallel import dp, pp, tp
from .resilience.retry import retry_call
from .tree import nested_leaves, nested_unflatten, tree_unflatten

MANIFEST_VERSION = 1
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _is_stage(state) -> bool:
    """Whether ``state`` is a pipeline stage's (``parallel.pp``)."""
    return getattr(state, "pp", None) is not None


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_atomic(path: str, write) -> None:
    """``write(file)`` into a temporary file beside ``path``, renamed into
    place; the temporary file goes on failure."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class Checkpointer:
    """Usage::

        ckpt = Checkpointer(dir, max_to_keep=3)
        ckpt.save(int(state.step), state)
        state = ckpt.restore(template_state)   # a new state, template's layout
        step = ckpt.latest_step()              # None if nothing saved

    ``max_to_keep >= 2`` is what gives the corrupt-step fallback a step to
    fall back to. See the module docstring for the contract."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 retry_attempts: int = 3, retry_base_delay: float = 0.1,
                 stats: Optional[ResilienceStats] = None):
        self._max_to_keep = max_to_keep
        self._retry_attempts = max(1, retry_attempts)
        self._retry_base = retry_base_delay
        self.stats = stats if stats is not None else ResilienceStats()
        self.restored_step: Optional[int] = None    # set by restore()
        self._dir = os.path.abspath(directory)
        self._digest_dir = os.path.join(self._dir, "digests")
        os.makedirs(self._digest_dir, exist_ok=True)

    # ------------------------------------------------------------- paths

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._digest_dir, f"{step}.json")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self._dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_manifest(self, step: int) -> Optional[dict]:
        try:
            with open(self._manifest_path(step)) as f:
                m = json.load(f)
            return m if isinstance(m, dict) else None
        except (OSError, ValueError):
            return None

    def _delete(self, step: int) -> None:
        for p in (self._path(step), self._manifest_path(step)):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass

    def _count_retry(self, attempt: int, exc: BaseException) -> None:
        self.stats.retries += 1

    # -------------------------------------------------------------- save

    def save(self, step: int, state: Any, *, overwrite: bool = False) -> bool:
        """Write ``state`` (any tree of dicts, lists and tuples of tensors)
        at ``step``; every rank of the process world calls it, and the
        world's rank 0 writes (after an elastic re-mesh, the new world's).
        ``overwrite=True`` replaces an existing step (a resume after a
        corrupt-latest fallback re-treads step indices of the dead lineage;
        an elastic re-mesh persists the new world's layout over the old
        world's save at the same step); without it an existing step raises.
        Every call saves (the JAX method's ``force`` has nothing to force
        here). Returns True."""
        exists = step in self.all_steps()
        dist.barrier("cpu")     # every rank has looked before rank 0 writes
        if exists and not overwrite:
            raise ValueError(f"checkpoint step {step} already exists (pass "
                             f"overwrite=True to replace a stale entry)")
        # A collective for ZeRO-1 and for pipeline stages.
        snapshot = (pp.host_snapshot(state) if _is_stage(state)
                    else tp.host_snapshot(state) if tp._is_state(state)
                    else dp.host_snapshot(state))
        try:
            if dist.get_rank() == 0:
                self._write(step, nested_leaves(snapshot))
        finally:
            dist.barrier("cpu")     # rank 0's failure raises after it
        return True

    def _write(self, step: int, leaves: list) -> None:
        self._delete(step)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        retry_call(_write_atomic, self._path(step),
                   lambda f: torch.save({"step": step, "tensors": tensors},
                                        f),
                   attempts=self._retry_attempts, base=self._retry_base,
                   seed=step, on_retry=self._count_retry)
        manifest = {
            "version": MANIFEST_VERSION, "step": step,
            "files": {os.path.basename(self._path(step)):
                      _sha256_file(self._path(step))},
            "leaves": [{"shape": list(x.shape), "dtype": str(x.dtype)}
                       if isinstance(x, torch.Tensor) else None
                       for x in leaves]}
        _write_atomic(self._manifest_path(step),
                      lambda f: f.write(json.dumps(manifest).encode()))
        for old in self.all_steps()[:-self._max_to_keep]:
            self._delete(old)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    # ----------------------------------------------------------- restore

    def _verify_digests(self, step: int) -> Optional[str]:
        """None if the step's file matches its manifest (or the step has no
        manifest: it restores unverified); else what does not match."""
        manifest = self._read_manifest(step)
        if manifest is None or not isinstance(manifest.get("files"), dict):
            return None
        for name, want in manifest["files"].items():
            p = os.path.join(self._dir, name)
            try:
                got = _sha256_file(p)
            except OSError as e:
                return f"unreadable file {name!r}: {e}"
            if got != want:
                return f"digest mismatch in {name!r}"
        return None

    def _restore_one(self, step: int, template: Any) -> Any:
        bad = self._verify_digests(step)
        if bad is not None:
            raise ValueError(f"checkpoint step {step} failed its integrity "
                             f"check: {bad}")
        data = retry_call(torch.load, self._path(step), map_location="cpu",
                          weights_only=True, attempts=self._retry_attempts,
                          base=self._retry_base, seed=step,
                          retry_on=(OSError,), on_retry=self._count_retry)
        tensors = iter(data["tensors"])
        stage = template if _is_stage(template) else None
        shard = template if tp._is_state(template) else None
        if stage is not None:     # read the whole model, then re-slice
            template = pp.merged_template(stage)
        elif shard is not None:
            template = tp.merged_template(shard)
        t_leaves = nested_leaves(template)
        host = [next(tensors) if isinstance(t, torch.Tensor) else t
                for t in t_leaves]
        if next(tensors, None) is not None:
            raise ValueError(f"checkpoint step {step} holds more tensors "
                             f"than the template")
        saved = [tuple(h.shape) for h, t in zip(host, t_leaves)
                 if isinstance(t, torch.Tensor)]
        if stage is not None:
            return pp.slice_state(nested_unflatten(template, host), stage)
        if shard is not None:
            return tp.slice_state(nested_unflatten(template, host), shard)
        want = [s for s in dp.global_shapes(template) if s is not None]
        out = dp.reshard_state(nested_unflatten(template, host), template)
        if saved != want:
            self.stats.ckpt_reshards += 1
        return out

    def restore(self, template: Any, *, step: Optional[int] = None) -> Any:
        """A new state of ``template``'s structure, devices and dtypes (and,
        for a ZeRO-1 template, its world and rank) holding the newest step
        that verifies and loads, or ``step`` if given (no fallback then).
        Raises FileNotFoundError when no step restores."""
        if step is not None:
            out = self._restore_one(step, template)
            self.restored_step = step
            return out
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError("no checkpoint found")
        last_exc: Optional[BaseException] = None
        for s in candidates:
            try:
                out = self._restore_one(s, template)
            except Exception as e:     # corrupt, garbled or failed digest
                last_exc = e
                self.stats.ckpt_fallbacks += 1
                continue
            self.restored_step = s
            return out
        raise FileNotFoundError(
            f"all {len(candidates)} checkpoint steps failed to restore "
            f"(newest error: {last_exc!r})") from last_exc

    def close(self) -> None:
        """Nothing stays open between calls."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------ best weights

def _paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` with ``jax.tree_util.keystr``'s spelling of a path
    through dicts and lists (``['blocks']['wq']``, ``[0]['w']``)."""
    if isinstance(tree, dict):
        return {p: x for k in sorted(tree)
                for p, x in _paths(tree[k], f"{prefix}[{k!r}]").items()}
    if isinstance(tree, list):
        return {p: x for i, t in enumerate(tree)
                for p, x in _paths(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def save_best(path: str, params: Any) -> None:
    """The reference's best-weights snapshot as a one-shot file: every leaf
    of ``params`` (a tree of dicts and lists of tensors) to an ``.npz``
    keyed by its path, written to a temporary file and renamed into place
    (bf16 leaves are stored as fp32, which numpy lacks)."""
    arrays = {p: x.detach().cpu().float().numpy()
              if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
              for p, x in _paths(params).items()}
    _write_atomic(os.path.abspath(path), lambda f: np.savez(f, **arrays))


def load_best(path: str, template: Any) -> Any:
    """``save_best``'s file back into ``template``'s structure, devices and
    dtypes (a new tree)."""
    with np.load(path) as data:
        leaves = [torch.from_numpy(data[p]).to(device=x.device,
                                               dtype=x.dtype)
                  for p, x in _paths(template).items()]
    return tree_unflatten(template, leaves)
