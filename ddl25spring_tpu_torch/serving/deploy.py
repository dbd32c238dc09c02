"""Live train→deploy weight publication: checkpoint stream → serving fleet.
Counterpart of the JAX package's ``serving/deploy.py``, on the port's
``checkpoint.Checkpointer`` (one file per step, SHA-256 manifest verified
before a restore, a corrupt newest step falling back to the one before,
restore into a template's structure, devices and dtypes).

- ``CheckpointPublisher`` (trainer side) is the ``on_checkpoint`` hook
  ``train_llm_dp`` calls after every periodic and final save. It saves the
  PARAMS alone (``state.params``) as a step of the publish directory: the
  serving side needs no optimizer state, and a params tree is what
  ``Engine.swap_params`` takes. It never raises into the trainer: a failed
  publication is logged and dropped.
- ``WeightPublisher`` (serving side) watches the directory: ``poll()``
  returns ``(step, params)`` when a step newer than the last one restores
  (digest-verified) into the serving template, and ``publish_to(fleet)``
  hands it to ``ServingFleet.publish``, which rolls it out one engine per
  token boundary.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional, Tuple


def _default_params_of(state: Any):
    """A training state's ``.params``; a bare params tree as it is."""
    return getattr(state, "params", state)


class CheckpointPublisher:
    """Trainer-side publication hook (``train_llm_dp(on_checkpoint=...)``).

    >>> pub = CheckpointPublisher(publish_dir)
    >>> train_llm_dp(cfg, tcfg, checkpoint_dir=ckpt_dir,
    ...              checkpoint_every=200, on_checkpoint=pub)

    Each call saves ``params_of(state)`` at the checkpoint's step; the save
    is synchronous, so a step is on disk with its manifest before a
    watcher can list it. ``max_to_keep=2`` keeps the newest publication and
    one to fall back to. In a process group every rank calls the hook (as
    every rank calls ``Checkpointer.save``) and rank 0 writes; a hook
    handed to ``train_llm_dp(data>1)`` from a plain process runs in the
    rank processes, so it must pickle and its ``published`` list stays
    there."""

    def __init__(self, publish_dir: str, *,
                 params_of: Callable[[Any], Any] = _default_params_of,
                 max_to_keep: int = 2,
                 log_fn: Callable[[str], None] = print):
        from ..checkpoint import Checkpointer
        self.publish_dir = publish_dir
        self._params_of = params_of
        self._log = log_fn
        self._ckpt = Checkpointer(publish_dir, max_to_keep=max_to_keep)
        self.published: List[int] = []

    def __call__(self, step: int, state: Any) -> None:
        try:
            self._ckpt.save(int(step), self._params_of(state),
                            overwrite=True)
            self.published.append(int(step))
        except Exception as e:     # publication must never sink the trainer
            self._log(f"weight publication at step {step} failed "
                      f"({type(e).__name__}: {e}); training continues")

    def close(self) -> None:
        self._ckpt.close()

    def __enter__(self) -> "CheckpointPublisher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WeightPublisher:
    """Serving-side watcher over a publish directory: ``poll()`` → the
    newest fresh ``(step, params)`` or None; ``publish_to(fleet)`` → poll
    and start a staggered hot-swap. ``template_params`` (the serving
    engines' tree) fixes the restored tree's structure, devices and
    dtypes. The poll cadence is the caller's."""

    def __init__(self, publish_dir: str, template_params: Any):
        from ..models import llama
        self.publish_dir = publish_dir
        self.template = llama.as_tree(template_params)
        self.last_step: Optional[int] = None

    def poll(self) -> Optional[Tuple[int, Any]]:
        from ..checkpoint import Checkpointer
        if not os.path.isdir(self.publish_dir):
            return None               # nothing published yet
        ckpt = Checkpointer(self.publish_dir)
        latest = ckpt.latest_step()
        if latest is None or (self.last_step is not None
                              and latest <= self.last_step):
            return None
        # The step that restored (a corrupt newest step falls back), which
        # is no new publication if it was published already.
        params = ckpt.restore(self.template)
        step = int(ckpt.restored_step)
        if self.last_step is not None and step <= self.last_step:
            return None
        self.last_step = step
        return step, params

    def publish_to(self, fleet) -> Optional[int]:
        """Poll; on a fresh publication start the fleet's rollout, versioned
        by the trainer's step. Returns the step, or None."""
        got = self.poll()
        if got is None:
            return None
        step, params = got
        fleet.publish(params, version=step)
        return step
