"""Memory observability: the port's counterpart of the JAX package's
``telemetry/memory.py`` (the schema-v9 ``memory`` event).

- **Measured peak of one call** (``program_memory`` / ``compiled_memory``):
  the JAX package reads a compiled program's static footprint; eager
  PyTorch has no program, so both names run the call once between
  ``torch.cuda.reset_peak_memory_stats`` and ``max_memory_allocated`` and
  report what it took. None on the CPU.
- **Live accounting** (``MemoryMeter``): one ``memory`` event per
  ``sample()``, merging static figures (the preflight's state bytes) with
  the sample's own: host RSS (``host_rss_bytes``), the CUDA caching
  allocator's allocated, reserved and peak bytes
  (``torch.cuda.memory_stats``, which waits for nothing) when a CUDA
  device is given, and the KV pool's occupancy and fragmentation
  (``allocator_census``). Losses and served streams are the same with the
  meter on or off.
- **Preflight** (``preflight``): the per-device bytes of the training
  state, the batch window and the KV pool from the configs alone, the
  state built on ``torch.device("meta")`` (no memory, no draws) where the
  JAX package uses ``jax.eval_shape``. Its components match the JAX
  function's: ``params_bytes`` and ``opt_state_bytes`` equal (ZeRO-1's
  1/n slice included); ``window_bytes`` is twice the JAX figure, because
  the port's token ids are int64 and JAX's int32.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Optional

import torch

# The components of one ``memory`` event that live in device memory,
# summed into ``device_bytes`` when the sampler gives no total itself.
_DEVICE_COMPONENTS = ("params_bytes", "opt_state_bytes", "residual_bytes",
                      "window_bytes", "pool_used_bytes")


def _cuda_device_of(args, kwargs) -> Optional[torch.device]:
    """The device of the first CUDA tensor in the arguments (any nesting of
    dicts, lists and tuples), or None."""
    from .introspect import _flatten_with_path

    for _, leaf in _flatten_with_path((args, kwargs)):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def program_memory(fn: Callable, *args, **kwargs) -> Optional[dict]:
    """Run ``fn(*args, **kwargs)`` once (with its effects: a training step
    updates its state) and return its footprint on the CUDA device of its
    first CUDA tensor argument: ``argument_bytes`` (allocated before the
    call), ``peak_bytes`` (``max_memory_allocated`` during it),
    ``temp_bytes`` (the difference) and ``device_bytes`` (the peak). None
    for a call on the CPU."""
    dev = _cuda_device_of(args, kwargs)
    if dev is None:
        fn(*args, **kwargs)
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return {"argument_bytes": float(before), "peak_bytes": float(peak),
            "temp_bytes": float(max(0, peak - before)),
            "device_bytes": float(peak)}


compiled_memory = program_memory


def host_rss_bytes() -> Optional[int]:
    """Peak resident-set size of this process in bytes (``ru_maxrss``), or
    None where rusage is unavailable."""
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:
        return None
    return int(ru) * (1 if sys.platform == "darwin" else 1024)


def tree_state_bytes(tree: Any) -> Optional[int]:
    """Exact logical bytes of a tree's tensor and array leaves (shape ×
    dtype itemsize, from metadata: no device read)."""
    try:
        from .comm import tree_bytes
        return int(tree_bytes(tree))
    except Exception:
        return None


def np_tree_bytes(tree: Any) -> int:
    """Bytes of a host tree (nested dicts, lists, tuples of arrays or
    tensors with ``nbytes``)."""
    if tree is None:
        return 0
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is not None and not isinstance(tree, (dict, list, tuple)):
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            return 0
    if isinstance(tree, dict):
        return sum(np_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(np_tree_bytes(v) for v in tree)
    return 0


def allocator_census(allocator, *, bytes_per_block: Optional[int] = None,
                     ) -> Dict[str, Any]:
    """One ``BlockAllocator``'s occupancy and fragmentation:
    ``blocks_in_use``, ``free_blocks``, ``blocks_capacity``,
    ``peak_blocks_in_use`` and the free list's ``holes`` /
    ``largest_run``; with ``bytes_per_block`` the same in bytes."""
    out: Dict[str, Any] = {
        "blocks_in_use": int(allocator.in_use),
        "free_blocks": int(allocator.free_blocks),
        "blocks_capacity": int(allocator.capacity),
        "peak_blocks_in_use": int(allocator.peak_in_use),
    }
    out.update(allocator.fragmentation())
    if bytes_per_block:
        out["pool_used_bytes"] = out["blocks_in_use"] * int(bytes_per_block)
        out["pool_capacity_bytes"] = (out["blocks_capacity"]
                                      * int(bytes_per_block))
        out["peak_pool_used_bytes"] = (out["peak_blocks_in_use"]
                                       * int(bytes_per_block))
    return out


class MemoryMeter:
    """Live memory sampler: one ``memory`` event per ``sample()`` call,
    merging the ``note``-d static figures with the sample's fields, host
    RSS and, when ``device`` is a CUDA device, the caching allocator's
    bytes allocated now, reserved now and the peak allocated
    (``torch.cuda.memory_stats``).
    ``events=None`` keeps it an accumulator (``peaks`` still track). A
    failed emission loses the sample, never the run."""

    def __init__(self, events=None, *, source: str = "host",
                 static: Optional[Dict[str, Any]] = None, device=None):
        self.events = events
        self.source = source
        self.static: Dict[str, Any] = dict(static or {})
        self.device = (torch.device(device) if device is not None
                       else None)
        self.samples = 0
        # Running maxima of every numeric byte and occupancy field.
        self.peaks: Dict[str, float] = {}

    def note(self, **fields: Any) -> None:
        """Merge static figures into every later sample."""
        self.static.update({k: v for k, v in fields.items()
                            if v is not None})

    def sample(self, source: Optional[str] = None,
               **fields: Any) -> Dict[str, Any]:
        """One sample: returns the merged record and, with an event log
        bound, emits it as a ``memory`` event."""
        rec = dict(self.static)
        rec.update({k: v for k, v in fields.items() if v is not None})
        rss = host_rss_bytes()
        if rss is not None:
            rec.setdefault("rss_bytes", rss)
        if self.device is not None and self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            rec.update(
                cuda_allocated_bytes=stats.get("allocated_bytes.all.current"),
                cuda_reserved_bytes=stats.get("reserved_bytes.all.current"),
                cuda_peak_bytes=stats.get("allocated_bytes.all.peak"))
        if "device_bytes" not in rec:
            parts = [rec[k] for k in _DEVICE_COMPONENTS
                     if isinstance(rec.get(k), (int, float))]
            if parts:
                rec["device_bytes"] = float(sum(parts))
        self.samples += 1
        for k, v in rec.items():
            if (isinstance(v, (int, float)) and not isinstance(v, bool)
                    and (k.endswith("_bytes") or k in ("blocks_in_use",
                                                       "holes"))):
                prev = self.peaks.get(k)
                self.peaks[k] = float(v) if prev is None else max(prev,
                                                                  float(v))
        if self.events is not None:
            try:
                self.events.memory(source=source or self.source, **rec)
            except Exception:
                pass
        return rec


def preflight(model_cfg, train_cfg=None, *, n_data=None,
              aggregation: str = "gradient", optimizer=None,
              paged=None, serve_cfg=None) -> Optional[dict]:
    """Per-device bytes before anything is allocated: the training state
    (parameters and optimizer state), the ``[K, B, T]`` int64 token window
    and the serving KV pool, from the configs alone. The parameters and the
    optimizer state are built on ``torch.device("meta")``. None when the
    model cannot be built.

    - ``params_bytes``: replicated on every rank;
    - ``opt_state_bytes``: per rank; under ``aggregation="zero1"`` the
      optimizer state of one rank's padded ``1/n`` flat fp32 slice
      (``parallel.dp``'s geometry), ~1/n of ``opt_state_replicated_bytes``;
    - ``residual_bytes``: the int8 ring step's error-feedback residuals
      (``compress.OverlapEFState``: the ring slot ``[1, Ppad]`` and the
      gather slot ``[local]``, fp32) when ``overlap_microbatches >= 1`` and
      ``wire`` carries error feedback, the JAX package's count;
    - ``window_bytes``: the per-rank token window, int64 (twice the JAX
      package's int32 figure);
    - ``kv_pool_bytes``: the paged pool (``kvcache.pool_bytes``) when
      ``paged`` is given.

    ``state_bytes`` = params + optimizer state (+ residuals);
    ``device_bytes`` adds the window and the pool."""
    try:
        import math as _math

        from ..models import llama
        from ..tree import tree_leaves
        from .comm import tree_bytes
        model = llama.init_llama(model_cfg, torch.Generator(),
                                 device=torch.device("meta"))
        params = model.tree()
        params_bytes = int(tree_bytes(params))
        count = sum(int(_math.prod(x.shape)) for x in tree_leaves(params))
    except Exception:
        return None
    if n_data is None:
        n_data = (train_cfg.data * max(1, train_cfg.dcn)
                  if train_cfg is not None else 1)
    n = max(1, int(n_data))
    if optimizer is None:
        lr = train_cfg.lr if train_cfg is not None else 1e-3
        name = getattr(train_cfg, "optimizer", "adam")
        if name == "adam":
            from ..ops.adam import fused_adam
            optimizer = fused_adam(lr)
        else:
            from ..bench_utils import make_optimizer
            optimizer = make_optimizer(name, lr)
    padded = -(-count // n) * n            # parallel.dp's flat padding
    local = padded // n
    try:
        opt_replicated = int(tree_bytes(optimizer.init(params)))
        if aggregation == "zero1":
            opt_local = int(tree_bytes(optimizer.init(torch.empty(
                local, dtype=torch.float32, device="meta"))))
        else:
            opt_local = opt_replicated
    except Exception:
        return None
    window_bytes = 0
    if train_cfg is not None:
        K = max(1, getattr(train_cfg, "steps_per_dispatch", 1))
        window_bytes = (K * train_cfg.batch_size * train_cfg.seq_len
                        * torch.empty((), dtype=torch.long).element_size())
    kv_pool_bytes = 0
    if paged is not None:
        try:
            from ..serving.kvcache import pool_bytes
            kv_pool_bytes = int(pool_bytes(serve_cfg or model_cfg, paged))
        except Exception:
            kv_pool_bytes = 0
    residual_bytes = 0
    wire = getattr(train_cfg, "wire", "fp32") if train_cfg else "fp32"
    ovl = getattr(train_cfg, "overlap_microbatches", 0) if train_cfg else 0
    if ovl >= 1 and "ef" in str(wire):
        residual_bytes = 4 * (padded + local)
    state_bytes = params_bytes + opt_local + residual_bytes
    return {
        "n_data": n,
        "param_count": int(count),
        "params_bytes": params_bytes,
        "opt_state_bytes": opt_local,
        "opt_state_replicated_bytes": opt_replicated,
        "residual_bytes": residual_bytes,
        "window_bytes": window_bytes,
        "kv_pool_bytes": kv_pool_bytes,
        "state_bytes": state_bytes,
        "device_bytes": state_bytes + window_bytes + kv_pool_bytes,
    }
