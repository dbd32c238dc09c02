"""Run-health introspection: the port's counterpart of the JAX package's
``telemetry/introspect.py``.

- **Tree paths** (``path_str``, ``leaf_paths``, ``nonfinite_leaves``):
  "blocks/wq"-style strings for every leaf, in the JAX package's
  ``tree_flatten_with_path`` order (a dict's keys sorted, a list's items
  by index, a NamedTuple's fields by name), so an index means the same
  leaf in the fault plan's targeted ``nan_grad``, the numerics finite mask
  and the guard's attribution, in both packages.
- **Numerics summaries** (``make_summarizer``): per-layer-group gradient,
  parameter and update norms and the per-leaf gradient finite mask,
  computed by the step from values it already holds. The step updates its
  parameters in place, so it hands the summarizer a copy of the parameters
  taken before the update; losses and parameters are the same with
  summaries on or off.
- **Compile/retrace accounting** (``CompileWatch``): eager PyTorch
  compiles nothing, so a watch keys each call by the (shape, dtype,
  device) signature of its tensor and array arguments. A new signature is
  one ``compile`` record, whose seconds are that call's wall time (on the
  card it includes lazy CUDA initialisation and the kernels' first-use
  build); a signature past ``max_caches`` is a retrace. The serving
  engine's watches then give the JAX engine's contract: compiles equal the
  program shapes hit, and no retraces.
- **Attainment** (``platform_peaks``, ``attainment``,
  ``calibrate_cpu_peak``): roofline denominators for the run manifest;
  "gpu" is the H100's (989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s).
- **Flight recorder** (``FlightRecorder``, ``load_bundle``,
  ``find_bundles``): a bounded ring of recent events plus the pinned
  manifest, numerics, memory and compile records, dumped as a postmortem
  JSON bundle when a ``fault``, ``remesh`` or ``slo_violation`` event
  crosses the stream. The bundle format is the reference's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# --------------------------------------------------------------- tree paths


def path_str(path) -> str:
    """A sequence of keys (dict keys, list indices, NamedTuple field
    names) -> "blocks/attn_norm/scale"."""
    return "/".join(str(k) for k in path)


def _flatten_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, list and tuple items by index, NamedTuple
    fields by name; ``None`` is an empty node."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for name, v in zip(tree._fields, tree)
                for pl in _flatten_with_path(v, prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten_with_path(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def leaf_paths(tree) -> List[str]:
    """Path strings of every leaf, in the order ``make_summarizer``'s finite
    mask and ``FaultPlan``'s targeted ``nan_grad`` use."""
    return [path_str(p) for p, _ in _flatten_with_path(tree)]


def nonfinite_leaves(tree, *, limit: int = 8) -> List[str]:
    """Paths of the floating leaves holding any NaN/Inf (reads each leaf on
    the host: the fault path only). At most ``limit`` paths, with a
    ``"... +N more"`` tail when cut."""
    bad = []
    for p, leaf in _flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf.detach()).all()):
                bad.append(path_str(p))
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append(path_str(p))
    if len(bad) > limit:
        bad = bad[:limit] + [f"... +{len(bad) - limit} more"]
    return bad


# ------------------------------------------------------- numerics summaries

class NumericsSummary(NamedTuple):
    """One step's numerics: per-GROUP sums of squares (the square roots are
    taken on the host) and the per-LEAF gradient finite mask, all small
    device tensors."""
    grad_sq: Any      # [G] fp32: per-group Σ grad²
    param_sq: Any     # [G] fp32: per-group Σ new_param²
    update_sq: Any    # [G] fp32: per-group Σ (new_param − old_param)²
    grad_finite: Any  # [L] bool: per-leaf all-finite(grad)


class NumericsHandle:
    """One model's numerics instrumentation: the leaf → group geometry,
    ``summarize`` (called by the step) and ``event_fields`` (the host-side
    ``numerics`` event payload).

    Groups: every top-level key of the parameter tree is a group, except
    ``layered_keys`` (default ``"blocks"``, the stacked ``[L, ...]``
    transformer stack), which give one group per leading index."""

    def __init__(self, groups: List[str], paths: List[str],
                 summarize: Callable):
        self.groups = groups          # [G] group names
        self.paths = paths            # [L] leaf paths (flatten order)
        self.summarize = summarize    # (old params, grads, new params) -> NumericsSummary

    def event_fields(self, summary, *, index: Optional[int] = None,
                     top: int = 4) -> Dict[str, Any]:
        """Read the summary on the host and shape the ``numerics`` event
        payload. ``index`` picks one step of a stacked ``[K, ...]``
        summary (-1: a window's last step)."""

        def host(x):
            a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x))
            return a[index] if index is not None else a

        grad = np.sqrt(host(summary.grad_sq).astype(np.float64))
        param = np.sqrt(host(summary.param_sq).astype(np.float64))
        upd = np.sqrt(host(summary.update_sq).astype(np.float64))
        finite = host(summary.grad_finite).astype(bool)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(param > 0, upd / param, 0.0)
        ratio_rank = np.where(np.isfinite(ratio), ratio, np.inf)
        worst = int(np.argmax(ratio_rank))
        order = np.argsort(-ratio_rank)[:max(1, top)]
        fields: Dict[str, Any] = {
            "grad_norm": float(np.sqrt(np.sum(grad ** 2))),
            "worst_group": self.groups[worst],
            "worst_update_ratio": float(ratio[worst]),
            "groups": {
                self.groups[i]: {
                    "grad_norm": float(grad[i]),
                    "param_norm": float(param[i]),
                    "update_ratio": float(ratio[i]),
                } for i in order
            },
        }
        if not bool(finite.all()):
            bad = [self.paths[i] for i in np.flatnonzero(~finite)]
            if len(bad) > 8:
                bad = bad[:8] + [f"... +{len(bad) - 8} more"]
            fields["nonfinite_grads"] = bad
        return fields


def make_summarizer(params_template, *,
                    layered_keys: Tuple[str, ...] = ("blocks",),
                    psum_axis=None) -> NumericsHandle:
    """The numerics summarizer for one parameter tree.

    ``summarize(old_params, grads, new_params)``: per-group sums of squares
    of the gradients, of the new parameters and of new − old, in fp32, and
    the per-leaf gradient finite mask. ``psum_axis`` (any value but None:
    the port has one data axis) sums the gradient statistics and the
    finite verdicts over the ranks, for ZeRO-1, whose local gradients
    differ per rank."""
    flat = _flatten_with_path(params_template)
    paths = [path_str(p) for p, _ in flat]
    groups: List[str] = []
    group_idx: Dict[str, int] = {}

    def gid(name: str) -> int:
        if name not in group_idx:
            group_idx[name] = len(groups)
            groups.append(name)
        return group_idx[name]

    layered: List[Optional[int]] = []   # first group id of the leaf's layers
    plain: List[Optional[int]] = []     # group id of a non-layered leaf
    for p, leaf in flat:
        top = path_str(p[:1])
        shape = tuple(getattr(leaf, "shape", ()))
        if top in layered_keys and len(shape) >= 1 and shape[0] >= 1:
            base = gid(f"{top}/0")
            for i in range(1, shape[0]):
                gid(f"{top}/{i}")
            layered.append(base)
            plain.append(None)
        else:
            layered.append(None)
            plain.append(gid(top))
    n_groups = len(groups)

    def _group_sq(leaves) -> torch.Tensor:
        acc = torch.zeros(n_groups, dtype=torch.float32,
                          device=leaves[0].device)
        for leaf, lay, pl in zip(leaves, layered, plain):
            x = leaf.detach().float()
            if lay is not None:
                acc[lay:lay + x.shape[0]] += (x.reshape(x.shape[0], -1)
                                              ** 2).sum(dim=1)
            else:
                acc[pl] += (x ** 2).sum()
        return acc

    def summarize(old_params, grads, new_params) -> NumericsSummary:
        from ..tree import tree_leaves

        gs = tree_leaves(grads)
        olds, news = tree_leaves(old_params), tree_leaves(new_params)
        grad_sq = _group_sq(gs)
        finite = torch.stack([torch.isfinite(g.detach()).all() for g in gs])
        if psum_axis is not None:
            from ..parallel import distributed as dist
            grad_sq = dist.psum(grad_sq, record=False)
            finite = dist.psum((~finite).to(torch.int32), record=False) == 0
        upd = [n.detach().float() - o.detach().float()
               for n, o in zip(news, olds)]
        return NumericsSummary(grad_sq=grad_sq, param_sq=_group_sq(news),
                               update_sq=_group_sq(upd), grad_finite=finite)

    return NumericsHandle(groups, paths, summarize)


def split_step_output(out):
    """``(loss, summary or None)`` from a step's second output: a bare loss,
    or ``(loss, NumericsSummary)`` when numerics are on."""
    if isinstance(out, tuple) and len(out) == 2 \
            and isinstance(out[1], NumericsSummary):
        return out[0], out[1]
    return out, None


# ------------------------------------------------ compile/retrace watching

class CompileRecord(NamedTuple):
    name: str
    seconds: float        # wall time of the first call with this signature
    cache_size: int       # signatures seen after this call
    retrace: bool         # broke the factory's max_caches budget
    flops: Optional[float]
    bytes_accessed: Optional[float]
    memory: Optional[dict] = None


def call_signature(args, kwargs=None) -> tuple:
    """The (shape, dtype, device) of every tensor and array in ``args`` and
    ``kwargs``, in argument order (dicts by sorted key, lists and tuples by
    index); everything else is data, not shape."""
    sig: List[tuple] = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), str(x.dtype), str(x.device)))
        elif isinstance(x, np.ndarray):
            sig.append((x.shape, str(x.dtype), "host"))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(args)
    if kwargs:
        visit(kwargs)
    return tuple(sig)


class CompileWatch:
    """Wraps a callable and turns each new call signature into a
    ``compile`` record (and event, once an ``EventLog`` is bound).

    ``max_caches``: the documented number of signatures (one program per
    shape in the JAX engine); a signature past it is flagged
    ``retrace=True`` and counted in ``retraces``. ``None`` sets no budget.
    ``meta`` / ``meta_fn(*args)`` add fields to the event. ``flops`` and
    ``bytes_accessed`` are None: there is no compiled program to cost
    (``costs.hlo_cost``). Attribute access delegates to the wrapped
    callable."""

    def __init__(self, fn: Callable, *, name: str,
                 max_caches: Optional[int] = 1, events=None, meta: Optional[Dict[str, Any]] = None,
                 meta_fn: Optional[Callable] = None):
        self._fn = fn
        self.name = name
        self.max_caches = max_caches
        self.events = events
        self.meta = dict(meta or {})
        self.meta_fn = meta_fn
        self.compiles: List[CompileRecord] = []
        self.retraces = 0
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        sig = call_signature(args, kwargs)
        if sig in self._seen:
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        self._seen.add(sig)
        after = len(self._seen)
        retrace = self.max_caches is not None and after > self.max_caches
        rec = CompileRecord(self.name, seconds, after, retrace, None, None)
        self.compiles.append(rec)
        if retrace:
            self.retraces += 1
        if self.events is not None:
            meta = dict(self.meta)
            if self.meta_fn is not None:
                try:
                    meta.update(self.meta_fn(*args, **kwargs))
                except Exception:
                    pass
            self.events.compile(name=self.name, seconds=seconds,
                                cache_size=after, retrace=retrace,
                                flops=None, bytes_accessed=None, **meta)
        return out

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


def watch(fn: Callable, *, name: str, max_caches: Optional[int] = 1,
          events=None,
          meta: Optional[Dict[str, Any]] = None,
          meta_fn: Optional[Callable] = None) -> CompileWatch:
    """Wrap ``fn`` in a ``CompileWatch`` (re-watching a watch re-binds its
    name and budget instead of stacking wrappers)."""
    if isinstance(fn, CompileWatch):
        fn.name = name
        fn.max_caches = max_caches
        if events is not None:
            fn.events = events
        if meta:
            fn.meta.update(meta)
        if meta_fn is not None:
            fn.meta_fn = meta_fn
        return fn
    return CompileWatch(fn, name=name, max_caches=max_caches,
                        events=events, meta=meta, meta_fn=meta_fn)


def bind_events(fn, events) -> None:
    """Late-bind an EventLog to a ``CompileWatch`` (no-op for anything
    else): how the serving scheduler attaches its stream to the engine's
    watches."""
    if isinstance(fn, CompileWatch):
        fn.events = events


# ------------------------------------------------------ roofline peaks

# One H100 SXM (NVIDIA data sheet, dense, at 700 W): the peaks chip_smoke.py
# and PERF.md hold every kernel against.
PLATFORM_PEAKS: Dict[str, Dict[str, Any]] = {
    "gpu": {"flops_per_sec": 989e12, "fp32_flops_per_sec": 67e12,
            "hbm_bytes_per_sec": 3.35e12,
            "source": "NVIDIA H100 SXM data sheet (bf16 dense peak, fp32 "
                      "peak, HBM3)"},
}

_cpu_peak_cache: Dict[str, Any] = {}


def calibrate_cpu_peak(*, n: int = 384, repeats: int = 3) -> Dict[str, Any]:
    """A measured CPU yardstick: the FLOP/s of a small fp32 matmul on this
    host (cached per process; ~10 ms)."""
    if _cpu_peak_cache:
        return dict(_cpu_peak_cache)
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    b = a.copy()
    a @ b                                    # warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    flops = 2.0 * n ** 3 / max(best, 1e-9)
    _cpu_peak_cache.update({
        "flops_per_sec": flops,
        "hbm_bytes_per_sec": 3.0 * 4 * n * n / max(best, 1e-9),
        "source": f"calibrated ({n}^3 f32 matmul on this host)",
    })
    return dict(_cpu_peak_cache)


def platform_peaks(platform: str) -> Dict[str, Any]:
    """Roofline denominators for ``platform``: "gpu" is the H100's;
    anything else gets the calibrated CPU baseline."""
    peaks = PLATFORM_PEAKS.get(platform)
    if peaks is not None:
        return dict(peaks)
    return calibrate_cpu_peak()


def attainment(flops: Optional[float], bytes_accessed: Optional[float],
               seconds: float, peaks: Dict[str, Any]) -> Dict[str, Any]:
    """One dispatch's achieved rates against the peaks: ``{"flops_per_sec",
    "mfu", "bytes_per_sec", "hbm_frac"}`` (None where a numerator or
    denominator is missing)."""
    out: Dict[str, Any] = {"flops_per_sec": None, "mfu": None,
                           "bytes_per_sec": None, "hbm_frac": None}
    if seconds <= 0:
        return out
    if isinstance(flops, (int, float)) and flops > 0:
        out["flops_per_sec"] = flops / seconds
        peak = peaks.get("flops_per_sec")
        if isinstance(peak, (int, float)) and peak > 0:
            out["mfu"] = out["flops_per_sec"] / peak
    if isinstance(bytes_accessed, (int, float)) and bytes_accessed > 0:
        out["bytes_per_sec"] = bytes_accessed / seconds
        peak = peaks.get("hbm_bytes_per_sec")
        if isinstance(peak, (int, float)) and peak > 0:
            out["hbm_frac"] = out["bytes_per_sec"] / peak
    return out


# ------------------------------------------------------ flight recorder

# Event types whose arrival dumps a bundle: a guard or fault-injection
# trip, an elastic re-mesh, a live SLO breach.
TRIGGER_TYPES = ("fault", "remesh", "slo_violation")

BUNDLE_KIND = "ddl25_postmortem"


class FlightRecorder:
    """Bounded ring over the live event stream plus pinned context, dumped
    as a postmortem bundle when a trigger event crosses.

    Attach as an ``EventLog`` observer (``Telemetry`` does by default).
    The manifest, the latest ``numerics`` and ``memory`` events and the
    ``compile`` events are pinned so they survive the ring's eviction.
    Bounds: ``capacity`` events in the ring, ``max_bytes`` per bundle
    (oldest ring events dropped first, counted), ``max_bundles`` per
    recorder."""

    def __init__(self, out_dir: str, *, capacity: int = 256,
                 max_bytes: int = 256 * 1024, max_bundles: int = 16,
                 triggers: Tuple[str, ...] = TRIGGER_TYPES):
        self.out_dir = out_dir
        self.capacity = max(1, int(capacity))
        self.max_bytes = max(4096, int(max_bytes))
        self.max_bundles = max(1, int(max_bundles))
        self.triggers = tuple(triggers)
        self.ring: List[Dict[str, Any]] = []
        self.manifest: Optional[Dict[str, Any]] = None
        self.last_numerics: Optional[Dict[str, Any]] = None
        self.last_memory: Optional[Dict[str, Any]] = None
        self.compiles: List[Dict[str, Any]] = []
        self.bundles: List[str] = []
        self.suppressed = 0          # triggers past max_bundles
        self.write_errors = 0

    def observe(self, event: Dict[str, Any]) -> None:
        """EventLog observer: ring, pin, trigger. Never raises."""
        try:
            self.ingest(event)
            if event.get("type") in self.triggers:
                self.dump(reason=event.get("type"), trigger=event)
        except Exception:
            self.write_errors += 1

    def ingest(self, event: Dict[str, Any]) -> None:
        """Ring and pin without triggering."""
        etype = event.get("type")
        self.ring.append(event)
        if len(self.ring) > self.capacity:
            del self.ring[:len(self.ring) - self.capacity]
        if etype == "manifest":
            self.manifest = event
        elif etype == "numerics":
            self.last_numerics = event
        elif etype == "memory":
            self.last_memory = event
        elif etype == "compile":
            self.compiles.append(event)
            if len(self.compiles) > 32:
                del self.compiles[:len(self.compiles) - 32]

    def dump(self, *, reason: str,
             trigger: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one bundle; returns its path (None when capped or failed)."""
        if len(self.bundles) >= self.max_bundles:
            self.suppressed += 1
            return None
        bundle = {
            "bundle": BUNDLE_KIND,
            "schema": _schema_version(),
            "reason": reason,
            "t": time.time(),
            "run_id": (trigger or self.manifest or {}).get("run_id"),
            "trigger": trigger,
            "attribution": (trigger or {}).get("attribution"),
            "manifest": self.manifest,
            "last_numerics": self.last_numerics,
            "memory": self.last_memory,
            "compiles": self.compiles,
            "recent_events": list(self.ring),
            "dropped_events": 0,
        }
        try:
            data = _fit_bundle(bundle, self.max_bytes)
            os.makedirs(self.out_dir, exist_ok=True)
            # The first free index: a relaunch reusing the directory must
            # not overwrite a dead run's postmortem.
            n = len(self.bundles)
            while True:
                path = os.path.join(self.out_dir,
                                    f"postmortem-{n:03d}-{reason}.json")
                if not os.path.exists(path):
                    break
                n += 1
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, path)
            self.bundles.append(path)
            return path
        except Exception:
            self.write_errors += 1
            return None


def _schema_version() -> int:
    from .events import SCHEMA_VERSION
    return SCHEMA_VERSION


def _fit_bundle(bundle: Dict[str, Any], max_bytes: int) -> str:
    """Serialize under the byte cap, evicting the oldest ring events (and
    counting them) until it fits."""
    data = json.dumps(bundle, default=str)
    while len(data.encode()) > max_bytes and bundle["recent_events"]:
        drop = max(1, len(bundle["recent_events"]) // 4)
        del bundle["recent_events"][:drop]
        bundle["dropped_events"] += drop
        data = json.dumps(bundle, default=str)
    return data


def load_bundle(path: str) -> Dict[str, Any]:
    """Read one postmortem bundle back; raises on a file that is not one."""
    with open(path) as f:
        bundle = json.load(f)
    if not isinstance(bundle, dict) or bundle.get("bundle") != BUNDLE_KIND:
        raise ValueError(f"{path}: not a {BUNDLE_KIND} bundle")
    return bundle


def find_bundles(root: str) -> List[str]:
    """Bundle paths under ``root`` (a telemetry directory or its
    ``postmortem/`` subdirectory), sorted."""
    hits: List[str] = []
    for base, _, files in os.walk(root):
        for f in files:
            if f.startswith("postmortem-") and f.endswith(".json"):
                hits.append(os.path.join(base, f))
    return sorted(hits)
