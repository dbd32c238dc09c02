"""Rank programs: what each rank runs in the port's multi-rank checks.

``distributed.run_ranks`` pickles the function a child runs by its import
path, so the per-rank bodies of the multi-rank tests
(``tests/test_torch_{dp,zero1,checkpoint,pp,pp_trainer,compress,
hier_collectives}.py``) and of ``chip_smoke.py`` phases 10, 13 and 15 live
here, in the port, and a child
imports nothing but the port.
Each takes plain data (numpy trees and batches, config dicts) and its
``device`` from the launcher, and returns host data: losses, parameters
and optimizer state as numpy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import statistics
import sys
import time

import torch

from . import distributed as dist
from . import compress, dp, pp, tp
from .. import bench_utils, convert
from ..bench_utils import make_optimizer
from ..checkpoint import Checkpointer
from ..config import LlamaConfig, ResilienceConfig, TrainConfig
from ..device import fp32_products, synchronize
from ..models import llama
from ..ops import flash_attention as fa
from ..telemetry import introspect
from ..telemetry.comm import CommProfile, collecting, measure_comm
from ..ops import pallas_adam as padam
from ..tokenizers import ByteTokenizer
from ..resilience import FaultPlan
from ..train.llm import train_llm_dp, train_llm_pp, train_llm_tp
from ..tree import nested_leaves, tree_copy, tree_leaves, tree_unflatten


def gloo_probe(n: int = 26_398_368, *, device) -> dict:
    """All-reduce and broadcast, on ``device``, an int32 scalar (rank + 1)
    and an fp32 vector of ``n`` small integers (``i % 7 + rank``), and
    check every sum exactly; time the vector's all-reduce (median of 5,
    host clock to a host read). ``n`` defaults to the canonical
    tiny-Llama's parameter count."""
    r, w = dist.get_rank(), dist.world_size()
    scalar = dist.psum(torch.tensor(r + 1, dtype=torch.int32, device=device))
    base = (torch.arange(n, device=device) % 7).float()
    summed = dist.psum(base + r)
    want = base * w + sum(range(w))
    from_0 = dist.broadcast(base + r, 0)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(dist.psum(base)[-1])
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    return {"rank": r, "world": w, "device": str(summed.device),
            "scalar_exact": int(scalar) == w * (w + 1) // 2,
            "vector_exact": bool(torch.equal(summed, want)),
            "broadcast_exact": bool(torch.equal(from_0, base)),
            "elements": n, "allreduce_ms": ms[len(ms) // 2],
            "route": dist.ROUTE}


def _run_case(case: dict, device) -> dict:
    """One data-parallel run on this rank; see ``dp_cases``."""
    cfg = LlamaConfig(**case["cfg"])
    model = convert.params_from_jax(case["params"], cfg, device=device)
    opt = make_optimizer(case.get("optimizer", "fused"), case.get("lr", 8e-4))
    r, n = dist.get_rank(), dist.world_size()
    poison = case.get("poison")        # (rank, call): that loss becomes NaN
    calls = [0]

    def loss_fn(p, batch):
        loss = llama.forward_loss(p, batch, cfg)
        calls[0] += 1
        if poison is not None and (r, calls[0]) == tuple(poison):
            loss = loss * float("nan")
        return loss

    mode, guard = case["mode"], case.get("guard", False)
    if mode.startswith("zero1"):
        make = dp.make_zero1_multi_step if mode == "zero1_multi" \
            else dp.make_zero1_step
        state, step = make(loss_fn, opt, model.tree(), guard_nonfinite=guard)
    else:
        state = dp.init_state(model.tree(), opt)
        step = {"gradient": lambda: dp.make_grad_aggregation_step(
                    loss_fn, opt, case.get("accum_steps", 1), guard),
                "multi": lambda: dp.make_multi_step(
                    loss_fn, opt, case.get("accum_steps", 1), guard),
                "weight": lambda: dp.make_weight_aggregation_step(
                    loss_fn, opt)}[mode]()
    out = {"rank": r, "losses": [], "grads": None}
    for batch in case["batches"]:
        # A global batch [.., n·B, T]: this rank takes its B rows.
        b = batch.shape[-2] // n
        local = torch.as_tensor(batch[..., r * b:(r + 1) * b, :],
                                dtype=torch.long, device=device)
        if out["grads"] is None and case.get("grads"):
            loss = loss_fn(state.params, local)
            g = torch.autograd.grad(loss, tree_leaves(state.params))
            out["grads"] = [x.cpu().numpy() for x in dist.pmean_tree(list(g))]
        state, loss = step(state, local)
        out["losses"] += loss.reshape(-1).tolist()
    out["params"] = convert.params_to_numpy(state.params)
    out["opt_state"] = convert.opt_state_to_numpy(state.opt_state)
    out["step"] = int(state.step)
    return out


def dp_cases(cases, *, device) -> list:
    """Run each case of ``cases`` on this rank and return one dict per case:
    ``losses`` (averaged over the ranks), ``params`` and ``opt_state``
    after the run (numpy; a ZeRO-1 state's moments are this rank's slice),
    ``step``, and with ``grads`` set, step 1's gradient averaged over the
    ranks (leaves in ``tree_leaves`` order).

    A case is a dict: ``mode`` ("gradient", "multi", "weight", "zero1" or
    "zero1_multi"), ``cfg`` (``LlamaConfig`` fields), ``params`` (a JAX
    ``init_llama`` tree as numpy), ``batches`` (global batches ``[n·B, T]``,
    or windows ``[K, n·B, T]`` for the K-step modes; rank r takes rows
    ``[r·B, (r+1)·B)``), and optionally ``optimizer`` (a
    ``bench_utils.make_optimizer`` name), ``lr``, ``accum_steps``, ``guard``
    (``guard_nonfinite``), ``poison`` (``(rank, call)``: that rank's loss
    on that call of the loss function is NaN) and ``grads``."""
    return [_run_case(case, device) for case in cases]


def trainer_calls(calls, *, device) -> list:
    """``train.llm.train_llm_dp`` inside this rank's group for each
    ``(model_cfg fields, train_cfg fields, keyword arguments)`` of
    ``calls``, in order; returns each report's ``losses``, ``steps`` and
    ``start_step``. ``checkpoint_dir`` in the keywords is shared by the
    ranks, so one call can resume another's checkpoint."""
    out = []
    for mcfg, tcfg, kwargs in calls:
        rep = train_llm_dp(LlamaConfig(**mcfg), TrainConfig(**tcfg),
                           tokenizer=ByteTokenizer(), log_every=0,
                           device=device, **kwargs)
        out.append({"losses": rep.losses, "steps": rep.steps,
                    "start_step": rep.start_step,
                    "resilience": rep.resilience.as_dict()})
    return out


def comm_profiles(cfg: dict, params, batch, *, device) -> dict:
    """``telemetry.comm.measure_comm`` of one call of each data-parallel
    step on this rank, from the JAX ``init_llama`` tree ``params`` (numpy)
    with the "fused" optimizer: "gradient", "zero1", "weight" on this
    rank's rows of the global batch ``batch`` ``[n·B, T]``, and "k4", the
    K-step loop over a window of four copies of them. Returns each
    profile's ``as_dict`` (``steps_per_dispatch=4`` for "k4")."""
    from ..telemetry.comm import measure_comm

    mcfg = LlamaConfig(**cfg)
    r, n = dist.get_rank(), dist.world_size()
    b = batch.shape[0] // n
    local = torch.as_tensor(batch[r * b:(r + 1) * b], dtype=torch.long,
                            device=device)

    def loss_fn(p, x):
        return llama.forward_loss(p, x, mcfg)

    out = {}
    for name in ("gradient", "zero1", "weight", "k4"):
        tree = convert.params_from_jax(params, mcfg, device=device).tree()
        opt = make_optimizer("fused")
        x = local
        if name == "zero1":
            state, step = dp.make_zero1_step(loss_fn, opt, tree)
        else:
            state = dp.init_state(tree, opt)
            if name == "weight":
                step = dp.make_weight_aggregation_step(loss_fn, opt)
            elif name == "k4":
                step = dp.make_multi_step(loss_fn, opt)
                x = local.expand(4, *local.shape)
            else:
                step = dp.make_grad_aggregation_step(loss_fn, opt)
        out[name] = measure_comm(step, state, x).as_dict(
            steps_per_dispatch=4 if name == "k4" else 1)
    return out


def _zero1_state(cfg: dict, params, device):
    """A ZeRO-1 state and step of the fused Adam rule at this world, from
    a JAX-layout numpy tree."""
    lcfg = LlamaConfig(**cfg)
    model = convert.params_from_jax(params, lcfg, device=device)
    return dp.make_zero1_step(
        lambda p, b: llama.forward_loss(p, b, lcfg), make_optimizer("fused"),
        model.tree())


def _zero1_host(state) -> dict:
    return {"mu": state.opt_state.mu.cpu().numpy(),
            "nu": state.opt_state.nu.cpu().numpy(),
            "count": int(state.opt_state.count), "step": int(state.step),
            "params": convert.params_to_numpy(state.params)}


def zero1_save(directory: str, cfg: dict, params, batches, *,
               device) -> dict:
    """ZeRO-1 steps over the global ``batches`` at this world, then a save
    at the last step's index to ``directory``; returns this rank's moment
    slices, count, step and parameters."""
    state, step = _zero1_state(cfg, params, device)
    n, r = dist.world_size(), dist.get_rank()
    for batch in batches:
        b = batch.shape[0] // n
        state, _ = step(state, torch.as_tensor(batch[r * b:(r + 1) * b],
                                               dtype=torch.long,
                                               device=device))
    Checkpointer(directory).save(len(batches), state)
    return _zero1_host(state)


def zero1_restore(directory: str, cfg: dict, params, *, device) -> dict:
    """A fresh ZeRO-1 state at this world restored from ``directory``'s
    newest step; returns ``zero1_save``'s fields, the restored step and the
    checkpointer's counters."""
    template, _ = _zero1_state(cfg, params, device)
    ckpt = Checkpointer(directory)
    out = _zero1_host(ckpt.restore(template))
    out.update(restored_step=ckpt.restored_step,
               stats=ckpt.stats.as_dict(), local=template.zero1.local)
    return out


def collectives(n: int, *, device) -> dict:
    """``psum``, ``pmean``, ``psum_scatter``, ``all_gather``, ``broadcast``
    and ``pmean_tree`` on small known inputs (rank r holds ``arange(n) +
    r``, n divisible by the world), returned as numpy for the caller to
    hold against the sums it expects."""
    r = dist.get_rank()
    x = torch.arange(n, dtype=torch.float32, device=device) + r
    tree = {"a": x[:2].clone(), "b": [x.to(torch.bfloat16),
                                      torch.tensor(r, device=device)]}
    mean_tree = dist.pmean_tree({"a": tree["a"], "b": tree["b"][:1]})
    to_np = lambda t: t.float().cpu().numpy()
    return {"psum": to_np(dist.psum(x)), "pmean": to_np(dist.pmean(x)),
            "psum_scatter": to_np(dist.psum_scatter(x)),
            "all_gather": to_np(dist.all_gather(x[:2] + 10 * r)),
            "broadcast": to_np(dist.broadcast(x, 1 % dist.world_size())),
            "pmean_tree": [to_np(mean_tree["a"]), to_np(mean_tree["b"][0])],
            "info": dist.process_info()}


def loaded_modules(*, device) -> list:
    """The names in this process's ``sys.modules``."""
    return sorted(sys.modules)


def raise_on(rank: int, *, device) -> None:
    """Raise on rank ``rank``; the other ranks wait in a collective that the
    raising rank never joins."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} raises on purpose")
    dist.barrier(device)


def sequence(calls, *, device) -> list:
    """Several rank programs of this module in one launch: ``calls`` is a
    list of ``(function name, args)``; returns their results in order."""
    return [globals()[name](*args, device=device) for name, args in calls]


# ------------------------------------------ compressed and overlapped sync

def _layout(hier):
    """``None`` (the flat process group) or the ``hier_data_mesh`` of
    ``hier = (D, S)``."""
    return None if hier is None else dist.hier_data_mesh(*hier)


def ring_cases(cases, *, device) -> list:
    """Each ring case on this rank; returns per case this rank's ``owned``
    chunk and ``residual`` (numpy) and the call's comm profile by label
    and by axis. A case: ``xs`` ``[n, L]`` fp32 (rank r's vector is row
    r), ``wire`` (or ``wire_ici`` and ``wire_dcn`` with ``hier = (D, S)``:
    ``hier_reduce_scatter``), optionally ``residuals`` ``[n, L']`` and
    ``calls`` (the residual threads through that many calls); or ``xs``
    and ``encode``: ``_int8_encode`` with its scale synced over the group
    (``owned`` is then q, with the ``scale``)."""
    out = []
    r = dist.get_rank()
    for case in cases:
        mesh = _layout(case.get("hier"))
        x = torch.as_tensor(case["xs"][r], device=device)
        if case.get("encode"):
            with collecting() as records:
                q, s, res = compress._int8_encode(
                    x, scale_sync_group=dist.data_group())
            out.append({"owned": q.cpu().numpy(), "scale": float(s),
                        "residual": res.cpu().numpy(),
                        "by_label": CommProfile(list(records)).by_label()})
            continue
        res = case.get("residuals")
        res = None if res is None else torch.as_tensor(res[r], device=device)
        with collecting() as records:
            for _ in range(case.get("calls", 1)):
                if mesh is not None:
                    owned, res = compress.hier_reduce_scatter(
                        x, mesh, wire_ici=case.get("wire_ici", "fp32"),
                        wire_dcn=case.get("wire_dcn", "int8_ef"),
                        residual=res)
                else:
                    owned, res = compress.ring_reduce_scatter(
                        x, dist.data_group(), wire=case["wire"],
                        residual=res)
        prof = CommProfile(list(records))
        out.append({"owned": owned.cpu().numpy(),
                    "residual": None if res is None else res.cpu().numpy(),
                    "by_label": prof.by_label(), "by_axis": prof.by_axis()})
    return out


def _overlap_case(case: dict, device) -> dict:
    """One run of the overlap step (or a legacy compressed step) on this
    rank; see ``overlap_cases``."""
    cfg = LlamaConfig(**case["cfg"])
    tree = convert.params_from_jax(case["params"], cfg, device=device).tree()
    opt = make_optimizer(case.get("optimizer", "fused"), case.get("lr", 1e-3))
    r = dist.get_rank()
    poison = case.get("poison")        # (rank, call): that loss becomes NaN
    nan_token = case.get("nan_token")  # a batch opening with it: NaN loss
    calls = [0]

    def loss_fn(p, batch):
        loss = llama.forward_loss(p, batch, cfg)
        calls[0] += 1
        if poison is not None and (r, calls[0]) == tuple(poison):
            loss = loss * float("nan")
        if nan_token is not None and int(batch[0, 0]) == nan_token:
            loss = loss * float("nan")
        return loss

    mesh = _layout(case.get("hier"))
    numerics = (introspect.make_summarizer(tree, psum_axis="data")
                if case.get("numerics") else None)
    legacy = case.get("legacy")
    if legacy == "bf16":
        state = dp.init_state(tree, opt)
        step = compress.make_bf16_grad_step(loss_fn, opt)
    elif legacy == "int8_ef":
        state = compress.init_ef_state(tree, opt)
        step = compress.make_int8_ef_grad_step(loss_fn, opt)
    else:
        make = (compress.make_overlap_multi_step if case.get("multi")
                else compress.make_overlap_step)
        state, step = make(
            loss_fn, opt, tree, mesh=mesh,
            microbatches=case.get("microbatches", 1),
            wire=case.get("wire", "fp32"),
            aggregation=case.get("aggregation", "gradient"),
            comm_buckets=case.get("comm_buckets", 1),
            guard_nonfinite=case.get("guard", False), numerics=numerics,
            device=device)
    if case.get("restore"):
        state = Checkpointer(case["restore"]).restore(state)
    out = {"rank": r, "losses": [], "comm": None, "numerics": [],
           "evidence": None, "steps": []}
    shard = (dp.shard_batch_window if case.get("multi")
             else dp.shard_batch)
    for i, batch in enumerate(case["batches"]):
        local = shard(batch, device=device)
        if i == 0 and case.get("evidence"):
            out["evidence"] = compress.ring_overlap_evidence(
                step, tree_copy(state), local)
        with collecting() as records:
            state, o = step(state, local)
        if out["comm"] is None:
            out["comm"] = CommProfile(list(records)).as_dict()
        loss, summary = introspect.split_step_output(o)
        if summary is not None:
            out["numerics"].append(numerics.event_fields(summary))
        out["losses"] += loss.reshape(-1).tolist()
        out["steps"].append(int(state.step))
    out["params"] = convert.tree_to_numpy(state.params)
    out["snapshot"] = [x.numpy() if isinstance(x, torch.Tensor) else x
                       for x in nested_leaves(dp.host_snapshot(state))]
    ckpt = case.get("checkpoint")
    if ckpt is not None:
        Checkpointer(ckpt).save(int(state.step), state, overwrite=True)
    return out


def overlap_cases(cases, *, device) -> list:
    """Run each case on this rank and return one dict per case: ``losses``
    (averaged over the ranks), ``params`` (numpy), ``steps`` (the step
    counter after each call), the first call's comm profile (``comm``),
    the numerics event fields of every call, the state's host snapshot
    leaves (``snapshot``: residuals and moments stacked in rank order) and
    with ``evidence`` the ``ring_overlap_evidence`` of the first call.

    A case is a dict: ``cfg`` (``LlamaConfig`` fields), ``params`` (a JAX
    ``init_llama`` tree as numpy), ``batches`` (global ``[n·B, T]``
    batches, or with ``multi`` ``[K, n·B, T]`` windows), and optionally
    ``optimizer``, ``lr``, ``microbatches``, ``wire`` (a string, or the
    per-axis dict with ``hier = (D, S)``), ``aggregation``,
    ``comm_buckets``, ``guard``, ``numerics``, ``poison`` (``(rank,
    call)``), ``nan_token`` (a microbatch whose first token is this has a
    NaN loss), ``legacy`` ("bf16" or "int8_ef": the per-step compressed
    steps instead), ``restore`` (a checkpoint directory the fresh state
    is restored from first) and ``checkpoint`` (a directory the final
    state is saved to)."""
    return [_overlap_case(case, device) for case in cases]


# ------------------------------------------------- pipeline parallelism

def sgd(lr: float):
    """Plain SGD, ``u = −lr·g``, with the optax surface (no state): a
    step's update divided by ``−lr`` is its gradient."""
    from ..ops.adam import GradientTransformation
    from ..tree import tree_map
    return GradientTransformation(
        lambda params: (),
        lambda grads, state, params=None: (
            tree_map(lambda g: -lr * g, grads), state))


def _pp_case_mesh(case: dict) -> dist.PipelineMesh:
    """A case's pipeline mesh: ``pipeline_mesh(data, stage, model)``, or
    with ``view`` a part of the ``grid`` mesh (``pipeline_mesh(*grid)``)
    that runs on its own: ``"row"`` each data row as a ``1 × S × T`` mesh,
    ``"column"`` each model shard's ranks as a ``D × S`` mesh (the groups
    of one model shard, no model axis)."""
    view = case.get("view")
    if view is None:
        return dist.pipeline_mesh(case["data"], case["stage"],
                                  case.get("model", 1))
    full = dist.pipeline_mesh(*case["grid"])
    me = (dist.get_rank(),)
    if view == "row":
        return dataclasses.replace(full, data=1, d=0,
                                   data_group=dist.Group("data", me, 0))
    assert view == "column", view
    alone = dist.Group("model", me, 0)
    return dataclasses.replace(full, model=1, m=0, model_group=alone,
                               ring_model_group=alone)


def _pp_case(case: dict, device) -> dict:
    """One pipeline run on this rank; see ``pp_cases``."""
    cfg = LlamaConfig(**case["cfg"])
    mesh = _pp_case_mesh(case)
    sched, v = case["schedule"], case.get("n_chunks", 2)
    params = convert.params_from_jax(case["params"], cfg,
                                     device=device).tree()
    if sched == "interleaved":
        params = pp.interleave_params(params, mesh.stage, v)
    name, lr = case.get("optimizer", "sgd"), case.get("lr", 1024.0)
    opt = sgd(lr) if name == "sgd" else make_optimizer(name, lr)
    numerics = (pp.make_pp_numerics(params, mesh) if case.get("numerics")
                else None)
    state = pp.init_state(mesh, params, opt, device=device)
    make = (pp.make_pipeline_multi_step if case.get("window")
            else pp.make_pipeline_step)
    step = make(cfg, opt, mesh, case["microbatches"], sched, v,
                numerics=numerics, device=device)
    out = {"rank": dist.get_rank(), "d": mesh.d, "s": mesh.s, "m": mesh.m,
           "losses": [], "comm": None, "numerics": None}
    if case.get("init"):
        out["init"] = convert.tree_to_numpy(state.params)
    for batch in case["batches"]:
        with collecting() as records:
            state, loss = step(state, pp.shard_batch(mesh, batch, device))
        loss, summary = introspect.split_step_output(loss)
        if out["comm"] is None:
            out["comm"] = CommProfile(list(records)).as_dict()
        if summary is not None and out["numerics"] is None:
            out["numerics"] = {"fields": numerics.event_fields(summary),
                               "groups": numerics.groups,
                               "paths": numerics.paths}
        out["losses"] += loss.reshape(-1).tolist()
    out["params"] = convert.tree_to_numpy(state.params)
    out["step"] = int(state.step)
    if case.get("merged"):
        out["merged"] = convert.tree_to_numpy(pp.host_snapshot(state).params)
    if case.get("checkpoint"):
        Checkpointer(case["checkpoint"]).save(int(state.step), state)
    return out


def pp_cases(cases, *, device) -> list:
    """Run each pipeline case of ``cases`` on this rank (a rank of a
    ``data × stage`` group) and return one dict per case: ``losses``,
    this stage's ``params`` after the run (numpy, its data row ``d`` and
    stage ``s``), ``step``, the first call's communication profile
    (``comm``) and, with ``numerics``, the first step's numerics event
    fields with the handle's group names and leaf paths.

    A case is a dict: ``cfg`` (``LlamaConfig`` fields), ``params`` (a JAX
    ``init_llama`` tree as numpy; interleaved for ``schedule=
    "interleaved"`` here), ``data``, ``stage``, ``schedule``,
    ``microbatches``, ``batches`` (global ``[D·B, T]`` batches, or with
    ``window`` set ``[K, D·B, T]`` windows for the K-step loop; row d
    takes its B rows), and optionally ``model`` (a model axis) or
    ``view`` and ``grid`` (``_pp_case_mesh``), ``n_chunks``,
    ``optimizer`` ("sgd", the default, or a ``make_optimizer`` name),
    ``lr`` (default 1024: SGD's update is then far above the parameters'
    rounding, so update / lr recovers the gradient), ``numerics``,
    ``init`` (also return the cell's parameters before the first step),
    ``merged`` (also return ``pp.host_snapshot``'s whole parameters) and
    ``checkpoint`` (a directory the final state is saved to)."""
    return [_pp_case(case, device) for case in cases]


def pp_trainer_calls(calls, *, device) -> list:
    """``train.llm.train_llm_pp`` inside this rank's group for each
    ``(model_cfg fields, train_cfg fields, keyword arguments)`` of
    ``calls``, in order (the byte tokenizer); returns each report's
    ``losses``, ``steps``, ``start_step`` and counters. A ``fault_plan``
    keyword is a spec string; ``checkpoint_dir`` is shared by the ranks,
    so one call can resume another's checkpoint."""
    out = []
    for mcfg, tcfg, kwargs in calls:
        kwargs = dict(kwargs)
        if isinstance(kwargs.get("fault_plan"), str):
            kwargs["fault_plan"] = FaultPlan.from_spec(kwargs["fault_plan"])
        rep = train_llm_pp(LlamaConfig(**mcfg), TrainConfig(**tcfg),
                           tokenizer=ByteTokenizer(), log_every=0,
                           device=device, **kwargs)
        out.append({"losses": rep.losses, "steps": rep.steps,
                    "start_step": rep.start_step,
                    "resilience": rep.resilience.as_dict()})
    return out


def pp_bench_calls(calls, *, device) -> list:
    """``bench_utils.time_pp_train_step`` on ``pipeline_mesh(*grid)`` for
    each ``(grid, cfg fields, batch, keyword arguments)`` of ``calls``;
    returns each call's tokens/s."""
    return [bench_utils.time_pp_train_step(
        dist.pipeline_mesh(*grid), LlamaConfig(**cfg), batch, device=device,
        **kwargs) for grid, cfg, batch, kwargs in calls]


class _RingSpy:
    """While active, records every ``compress.ring_reduce_scatter`` call of
    this process under a label starting with ``prefix``: its input vector,
    residual in and out, and owned chunk (numpy), for a check against
    ``ring_spec``."""

    def __init__(self, prefix: str):
        self.prefix, self.calls = prefix, []

    def __enter__(self):
        self._orig = orig = compress.ring_reduce_scatter
        calls, prefix = self.calls, self.prefix

        def spy(x, group, *, wire="fp32", residual=None, label=None, **kw):
            red, res = orig(x, group, wire=wire, residual=residual,
                            label=label, **kw)
            if label is not None and label.startswith(prefix):
                host = (lambda t: None if t is None
                        else t.detach().cpu().numpy().copy())
                calls.append({"label": label, "x": host(x),
                              "res_in": host(residual), "owned": host(red),
                              "res_out": host(res)})
            return red, res

        compress.ring_reduce_scatter = spy
        return self

    def __exit__(self, *exc):
        compress.ring_reduce_scatter = self._orig


def _pp_overlap_case(case: dict, device) -> dict:
    """One DP×PP ring-driver run on this rank; see ``pp_overlap_cases``."""
    cfg = LlamaConfig(**case["cfg"])
    mesh = _pp_case_mesh(case)
    params = convert.params_from_jax(case["params"], cfg,
                                     device=device).tree()
    name, lr = case.get("optimizer", "sgd"), case.get("lr", 1.0)
    opt = sgd(lr) if name == "sgd" else make_optimizer(name, lr)
    if case.get("plain"):
        state = pp.init_state(mesh, params, opt, device=device)
        step = pp.make_pipeline_step(cfg, opt, mesh, case["microbatches"],
                                     case.get("schedule", "gpipe"),
                                     device=device)
    else:
        make = (pp.make_pipeline_overlap_multi_step if case.get("window")
                else pp.make_pipeline_overlap_step)
        state, step = make(
            cfg, opt, mesh, params, n_microbatches=case["microbatches"],
            schedule=case.get("schedule", "gpipe"),
            aggregation=case["aggregation"], wire=case["wire"],
            overlap_microbatches=case.get("overlap", 1),
            comm_buckets=case.get("comm_buckets", 1), device=device)
    out = {"rank": dist.get_rank(), "d": mesh.d, "s": mesh.s, "m": mesh.m,
           "losses": [], "comm": None, "ring": None}
    spy = _RingSpy("pp_ring_grad")
    for i, batch in enumerate(case["batches"]):
        with collecting() as records, spy:
            state, loss = step(state, pp.shard_batch(mesh, batch, device))
        if out["comm"] is None:
            out["comm"] = CommProfile(list(records)).as_dict()
        out["losses"] += loss.reshape(-1).tolist()
    if case.get("spy"):
        out["ring"] = spy.calls
    snap = pp.host_snapshot(state)
    out["params"] = convert.tree_to_numpy(snap.params)
    out["local"] = convert.tree_to_numpy(state.params)
    out["step"] = int(state.step)
    if case.get("snapshot"):
        out["snapshot"] = [x.numpy() if isinstance(x, torch.Tensor) else x
                           for x in nested_leaves(snap)]
    return out


def pp_overlap_cases(cases, *, device) -> list:
    """Each DP×PP ring-driver case on this rank (a rank of a ``data ×
    stage`` group); returns per case: ``losses``, the whole model's
    ``params`` after the run (``pp.host_snapshot``, numpy, the same on the
    ranks of a data row), ``step``, the first step's communication
    profile (``comm``), with ``spy`` every ``pp_ring_grad`` ring call of
    the run (``_RingSpy``), and with ``snapshot`` the snapshot's leaves.

    A case is a dict: ``cfg`` (``LlamaConfig`` fields), ``params`` (a JAX
    ``init_llama`` tree as numpy), ``data``, ``stage``, ``microbatches``
    (the pipeline's), ``aggregation``, ``wire``, ``batches`` (global ``[D·B,
    T]`` batches, or with ``window`` set ``[K, D·B, T]`` windows), and
    optionally ``schedule``, ``overlap`` (M, default 1), ``comm_buckets``,
    ``optimizer`` ("sgd", the default, or a ``make_optimizer`` name),
    ``lr`` (default 1.0), ``plain`` (the plain DP×PP step instead, the
    ring's reference) and ``model`` / ``view`` / ``grid``
    (``_pp_case_mesh``). Each result also holds this cell's own parameters
    (``local``)."""
    return [_pp_overlap_case(case, device) for case in cases]


# --------------------------------------------- chip_smoke.py phase 10

def _zero_counts() -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = padam.launches = 0


def _counts(device, steps: int) -> dict:
    """Each port kernel's launches in this process since ``_zero_counts``,
    per step."""
    synchronize(device)
    return {"flash_fwd": fa.launches / steps,
            "flash_bwd_dq": fa.dq_launches / steps,
            "flash_bwd_dkv": fa.dkv_launches / steps,
            "adam": padam.launches / steps}


def _moment_bytes(opt_state) -> int:
    return sum(x.numel() * x.element_size()
               for x in tree_leaves([opt_state.mu, opt_state.nu]))


def _digest(params, device) -> torch.Tensor:
    """The SHA-256 of the parameters' bytes, as 32 int32 values on
    ``device``."""
    flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(params)])
    h = hashlib.sha256(flat.cpu().numpy().tobytes()).digest()
    return torch.tensor(list(h), dtype=torch.int32, device=device)


def phase10(tokens, directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 10 on this rank (every rank of a group of
    two on one card): a. the gloo probe; b. five gradient-aggregation steps
    of the canonical model at fp32 on this rank's rows of ``tokens`` ``[5,
    n·B, T]`` (the first step's averaged loss and gradient, rank 0 returns
    the gradient); c. ``time_train_step`` at bf16, B = 32 per rank, and the
    gradient all-reduce alone; d. ZeRO-1 on b's batches; e. three steps of
    weight aggregation with the parameters' digest broadcast from rank 0;
    f. the K-step loop at K = 4 against four per-step calls; c also
    records the bf16 step's communication profile (``comm``); g.
    ``train_llm_dp`` at vocab 259 (20 steps; 10 resumed to 20 from a
    checkpoint in ``directory``; the master-weight optimizer on bf16
    parameters). Returns the numbers and the per-step launch counts of
    each part; the caller checks them."""
    r, n = dist.get_rank(), dist.world_size()
    out = {"rank": r, "probe": gloo_probe(device=device)}
    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    b = tokens.shape[1] // n
    local = torch.as_tensor(tokens[:, r * b:(r + 1) * b], dtype=torch.long,
                            device=device)

    def loss_fn(p, x):
        return llama.forward_loss(p, x, cfg)

    def fresh():
        return llama.init_llama(cfg, torch.Generator().manual_seed(0),
                                device=device).tree()

    def run(step, state, batches, name, **extra):
        _zero_counts()
        losses = []
        for x in batches:
            state, loss = step(state, x)
            losses.append(float(loss))
        out[name] = dict(losses=losses, launches=_counts(device, len(losses)),
                         moment_bytes=_moment_bytes(state.opt_state), **extra)
        return state

    with fp32_products():
        params = fresh()
        loss = loss_fn(params, local[0])
        grads = dist.pmean_tree(list(torch.autograd.grad(
            loss, tree_leaves(params))))
        out["loss1"] = float(dist.pmean(loss.detach()))
        if r == 0:
            out["grads"] = [g.cpu() for g in grads]
        del grads, loss
        opt = make_optimizer("pallas")
        run(dp.make_grad_aggregation_step(loss_fn, opt),
            dp.init_state(params, opt), local, "gradient")
        state, step = dp.make_zero1_step(loss_fn, opt, fresh())
        mine = state.opt_state.mu
        run(step, state, local, "zero1", local=state.zero1.local,
            kernel_eligible=padam._pallas_eligible(mine, mine))
        del state
        state = dp.init_state(fresh(), opt)
        step = dp.make_weight_aggregation_step(loss_fn, opt)
        _zero_counts()
        losses, same = [], []
        for x in local[:3]:
            state, loss = step(state, x)
            losses.append(float(loss))
            mine = _digest(state.params, device)
            same.append(bool(torch.equal(dist.broadcast(mine, 0), mine)))
        out["weight"] = dict(losses=losses, digests_equal=same,
                             launches=_counts(device, 3))
        per = dp.make_grad_aggregation_step(loss_fn, opt)
        a = dp.init_state(fresh(), opt)
        la = []
        for x in local[:4]:
            a, loss = per(a, x)
            la.append(loss)
        k = dp.init_state(fresh(), opt)
        _zero_counts()
        k, lk = dp.make_multi_step(loss_fn, opt)(k, local[:4])
        out["kstep"] = dict(
            launches=_counts(device, 4),
            losses_equal=torch.equal(torch.stack(la), lk),
            params_equal=all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a.params), tree_leaves(k.params))),
            moments_equal=all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a.opt_state.mu), tree_leaves(k.opt_state.mu))))
        del a, k, state, params

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    state, step, batch = bench_utils.build_train_step(
        tcfg, 32, opt_name="pallas", device=device)
    with collecting() as records:      # the step's communication profile
        bf16_loss = float(step(state, batch)[1])
    out["comm"] = CommProfile(list(records)).as_dict()
    del state, step, batch
    _zero_counts()
    tok_s = bench_utils.time_train_step(tcfg, 32, seq=tcfg.ctx_size,
                                        opt_name="pallas", warmup=2,
                                        timed_steps=5, device=device)
    launches = _counts(device, 7)
    grads = [torch.ones_like(p) for p in tree_leaves(fresh())]
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(dist.pmean_tree(grads)[-1].reshape(-1)[-1])
        ms.append((time.perf_counter() - t0) * 1e3)
    out["throughput"] = dict(
        tokens_per_sec=tok_s, launches=launches, loss=bf16_loss,
        allreduce_ms=statistics.median(ms), allreduce_ms_all=ms,
        allreduce_bytes=sum(g.numel() * 4 for g in grads))
    del grads

    tc = dict(data=n, optimizer="pallas")
    _zero_counts()
    full = train_llm_dp(None, TrainConfig(iters=20, **tc), log_every=0,
                        device=device)
    launches = _counts(device, 20)
    ck = os.path.join(directory, "trainer")
    first = train_llm_dp(None, TrainConfig(iters=10, **tc), log_every=0,
                         checkpoint_dir=ck, checkpoint_every=10,
                         device=device)
    second = train_llm_dp(None, TrainConfig(iters=20, **tc), log_every=0,
                          checkpoint_dir=ck, checkpoint_every=10,
                          device=device)
    resumed = first.losses + second.losses
    mcfg = LlamaConfig(param_dtype="bfloat16")
    mdir = os.path.join(directory, "master")
    master = train_llm_dp(mcfg, TrainConfig(iters=20, data=n,
                                            optimizer="master"),
                          log_every=0, checkpoint_dir=mdir,
                          checkpoint_every=20, device=device)
    tok = ByteTokenizer()
    mcfg = mcfg.replace(vocab_size=tok.vocab_size)
    opt = make_optimizer("master")
    template = dp.init_state(llama.init_llama(
        mcfg, torch.Generator().manual_seed(0), device=device).tree(), opt)
    saved = Checkpointer(mdir).restore(template)
    out["trainer"] = dict(
        losses=full.losses, tokens_per_sec=full.tokens_per_sec,
        launches=launches, resumed_start=second.start_step,
        resume_max_abs_diff=max(abs(x - y) for x, y in zip(resumed,
                                                           full.losses)),
        resumed_len=len(resumed), master_losses=master.losses,
        master_param_dtypes=sorted({str(x.dtype) for x in
                                    tree_leaves(saved.params)}),
        master_dtypes=sorted({str(x.dtype) for x in
                              tree_leaves(saved.opt_state.master)}))
    return out


# --------------------------------------------- chip_smoke.py phase 13

PP_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _stage_grads_vs_world_of_one(state, grads, full, cfg, tokens, schedule,
                                 mesh) -> dict:
    """This stage's gradient leaves against the world-of-one gradient of
    the whole model on the same weights and batch: the largest
    ``max|d| / max|ref|`` over the stage's leaves, and the loss."""
    leaves = tree_leaves(full)
    loss = llama.forward_loss(full, tokens, cfg)
    ref = tree_unflatten(full, list(torch.autograd.grad(loss, leaves)))
    if schedule == "interleaved":
        ref["blocks"] = pp.interleave_blocks(ref["blocks"], mesh.stage, 2)
    ref = pp._stage_tree(ref, mesh.stage, mesh.s)
    grads = {k: g for k, g in grads.items() if k in ref}   # no layout tag
    worst = 0.0
    for g, r in zip(tree_leaves(grads), tree_leaves(ref)):
        scale = float(r.abs().max())
        if scale > 0:
            worst = max(worst, float((g - r).abs().max()) / scale)
    return {"loss": float(loss.detach()), "grad_rel_err": worst}


def _hop_ms(mesh, device, reps: int = 20) -> dict:
    """The host-staged hop of phase 13's bf16 activation ([8, 256, 288],
    1.18 MB) between stages 0 and 1: a round trip's median halved, and
    its device→host and host→device copies alone (stage 0's medians)."""
    x = torch.randn(8, 256, 288, device=device).to(torch.bfloat16)
    g = mesh.stage_group
    trips, d2h, h2d = [], [], []
    for k in range(reps):
        if mesh.s == 0:
            synchronize(device)
            t0 = time.perf_counter()
            dist.send(x, 1, tag=k, label="pp_activation_hop", group=g)
            y = dist.recv(1, x.shape, x.dtype, tag=k, group=g, device=device)
            synchronize(device)
            trips.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            host = x.to("cpu")
            d2h.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            y = host.to(device)
            synchronize(device)
            h2d.append((time.perf_counter() - t0) * 1e3)
        elif mesh.s == 1:
            y = dist.recv(0, x.shape, x.dtype, tag=k, group=g, device=device)
            dist.send(y, 0, tag=k, label="pp_activation_hop", group=g)
    dist.barrier(device)
    if mesh.s != 0:
        return {}
    return {"hop_ms": statistics.median(trips) / 2, "round_trips_ms": trips,
            "d2h_ms": statistics.median(d2h), "h2d_ms": statistics.median(h2d),
            "bytes": x.numel() * x.element_size()}


def phase13(tokens_check, tokens_time, directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 13 on this rank (stage ``s`` of a 3-stage
    pipeline, every stage on the one card): a. at the canonical model in
    fp32, each schedule's loss and gradient on ``tokens_check`` ``[12,
    256]`` (M = 3) against the world of one on the card, and the kernels'
    launches; b. at bf16 on ``tokens_time`` ``[48, 256]`` (M = 6, the
    "pallas" optimizer), each schedule's ms per step timed in turns (3
    rounds of 5 steps, the order rotating), launches per step, and the
    host-staged hop alone; c. the homework's 3-stage run,
    ``train_llm_pp(stage=3, microbatches=3)`` at vocab 259 for 20 steps,
    with launches per step; d. the same trainer at K = 4 (8 steps), 10
    steps resumed to 20 from a checkpoint in ``directory``, and 10 steps
    guarded with ``nan_grad@3``. Returns the numbers; the caller checks
    them."""
    mesh = dist.pipeline_mesh(1, 3)
    out = {"rank": dist.get_rank(), "stage": mesh.s}
    t_phase = time.perf_counter()

    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    full = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                            device=device).tree()
    tokens = torch.as_tensor(tokens_check, dtype=torch.long, device=device)
    out["check"] = {}
    with fp32_products():
        for sched in PP_SCHEDULES:
            params = (pp.interleave_params(full, mesh.stage, 2)
                      if sched == "interleaved" else full)
            state = pp.init_state(mesh, params, make_optimizer("fused"),
                                  device=device)
            _zero_counts()
            loss, grads = pp.loss_and_grad(state, tokens, cfg, mesh, 3,
                                           sched, device=device)
            launches = _counts(device, 1)
            res = _stage_grads_vs_world_of_one(state, grads, full, cfg,
                                               tokens, sched, mesh)
            out["check"][sched] = dict(res, pp_loss=float(loss),
                                       launches=launches)
            del state, grads
    del full

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    whole = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    tokens = torch.as_tensor(tokens_time, dtype=torch.long, device=device)
    opt = make_optimizer("pallas")
    runs = {}
    for sched in PP_SCHEDULES:
        params = (pp.interleave_params(whole, mesh.stage, 2)
                  if sched == "interleaved" else whole)
        step = pp.make_pipeline_step(tcfg, opt, mesh, 6, sched,
                                     device=device)
        state = pp.init_state(mesh, params, opt, device=device)
        state, loss = step(state, tokens)           # warm up
        runs[sched] = [state, step, [float(loss)], [], None]
    del whole
    for rnd in range(3):
        for sched in PP_SCHEDULES[rnd:] + PP_SCHEDULES[:rnd]:
            run = runs[sched]
            _zero_counts()
            dist.barrier(device)
            t0 = time.perf_counter()
            for _ in range(5):
                run[0], loss = run[1](run[0], tokens)
            run[2].append(float(loss))
            run[3].append((time.perf_counter() - t0) / 5 * 1e3)
            run[4] = _counts(device, 5)
    out["timing"] = {sched: {"ms_per_step": statistics.median(run[3]),
                             "ms_per_step_turns": run[3], "losses": run[2],
                             "launches": run[4]}
                     for sched, run in runs.items()}
    del runs, state
    out["hop"] = _hop_ms(mesh, device)

    def trainer(iters, spd=1, **kw):
        _zero_counts()
        tc = TrainConfig(iters=iters, stage=3, microbatches=3,
                         optimizer="pallas", steps_per_dispatch=spd)
        rep = train_llm_pp(None, tc, log_every=0, device=device, **kw)
        return rep, _counts(device, iters)

    t0 = time.perf_counter()
    rep, launches = trainer(20)
    out["b1"] = dict(losses=rep.losses, launches=launches,
                     tokens_per_sec=rep.tokens_per_sec,
                     seconds=time.perf_counter() - t0)
    rep, _ = trainer(8, spd=4)
    out["kstep_losses"] = rep.losses
    ck = os.path.join(directory, "pp")
    first, _ = trainer(10, checkpoint_dir=ck, checkpoint_every=10)
    second, _ = trainer(20, checkpoint_dir=ck, checkpoint_every=10)
    out["resumed"] = dict(losses=first.losses + second.losses,
                          start=second.start_step)
    rep, _ = trainer(10, resilience=ResilienceConfig(),
                     fault_plan=FaultPlan.from_spec("nan_grad@3"))
    out["fault"] = dict(losses=rep.losses,
                        resilience=rep.resilience.as_dict())
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase13_b2(*, device) -> dict:
    """``chip_smoke.py`` phase 13c's second topology on this rank: the
    homework's 2 pipelines × 3 stages, ``train_llm_pp(data=2, stage=3,
    microbatches=3)`` at vocab 259 for 20 steps, with launches per step."""
    _zero_counts()
    t0 = time.perf_counter()
    rep = train_llm_pp(None, TrainConfig(iters=20, data=2, stage=3,
                                         microbatches=3, optimizer="pallas"),
                       log_every=0, device=device)
    return dict(rank=dist.get_rank(), losses=rep.losses,
                launches=_counts(device, 20),
                tokens_per_sec=rep.tokens_per_sec,
                seconds=time.perf_counter() - t0)


# --------------------------------------------- chip_smoke.py phase 15

RING_SEED = 15
RING_CALLS = 2           # the int8 residual threads through two calls


def _ring_vectors(n: int, length: int) -> "np.ndarray":
    """The ``[n, length]`` fp32 vectors of phase 15a (every rank draws all
    of them from one seed, so each can hold its own result to the spec)."""
    import numpy as np
    return np.random.default_rng(RING_SEED).standard_normal(
        (n, length), dtype=np.float32)


def _ms(fn, device) -> float:
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def _spec_equal(got, want) -> dict:
    import numpy as np
    g = got.cpu().numpy()
    return {"bitwise": bool(np.array_equal(g, want)),
            "max_abs_diff": float(np.abs(g - want).max())}


def _ring_phase(length: int, device, layouts) -> dict:
    """Phase 15a on this rank: ``ring_reduce_scatter`` over the process
    group in each wire format (int8 over ``RING_CALLS`` calls, its residual
    held too) and ``hier_reduce_scatter`` at each ``(D, S)`` of
    ``layouts``, each held bitwise to ``ring_spec`` (and at D = 1 or S = 1
    to the flat ring's own result); then each format's
    call and one hop, and the fp32 all-reduce of the whole vector, timed
    in turns (3 rounds, median)."""
    from . import ring_spec
    import numpy as np
    n, r = dist.world_size(), dist.get_rank()
    xs = _ring_vectors(n, length)
    x = torch.as_tensor(xs[r], device=device)
    group = dist.data_group()
    out = {"rank": r, "elements": length, "flat": {}, "hier": {}}
    flat_out = {}
    for wire in compress.WIRES:
        res = (torch.zeros(length, device=device) if wire == "int8_ef"
               else None)
        sres = None if res is None else [np.zeros(length, np.float32)] * n
        for _ in range(RING_CALLS if res is not None else 1):
            owned, res = compress.ring_reduce_scatter(x, group, wire=wire,
                                                      residual=res)
            want, sres = ring_spec.ring(list(xs), wire, sres)
        rec = _spec_equal(owned, want[r])
        if res is not None:
            rec["residual"] = _spec_equal(res, sres[r])
        out["flat"][wire] = rec
        flat_out[wire] = (owned, res)
    for D, S in layouts:
        mesh = dist.hier_data_mesh(D, S)
        res = torch.zeros(D * length // n, device=device)
        sres = [np.zeros(D * length // n, np.float32)] * n
        for _ in range(RING_CALLS):
            owned, res = compress.hier_reduce_scatter(
                x, mesh, wire_ici="fp32", wire_dcn="int8_ef", residual=res)
            want, sres = ring_spec.hier(list(xs), D, S, "fp32", "int8_ef",
                                        sres)
        rec = _spec_equal(owned, want[r])
        rec["residual"] = _spec_equal(res, sres[r])
        if D == 1 or S == 1:
            # One ring is the identity: the fp32 island ring at D = 1, the
            # int8 DCN ring (its residual too) at S = 1.
            f_owned, f_res = flat_out["fp32" if D == 1 else "int8_ef"]
            rec["flat_bitwise"] = bool(torch.equal(owned, f_owned)) and (
                D == 1 or bool(torch.equal(res, f_res)))
        out["hier"][f"{D}x{S}"] = rec
    del xs, flat_out
    chunk = length // n
    times = {k: [] for k in ("allreduce", *compress.WIRES)}
    hops = {k: [] for k in compress.WIRES}
    copies = {"d2h": [], "gloo": [], "h2d": []}
    res = torch.zeros(length, device=device)
    host = torch.empty(chunk, dtype=torch.float32)
    dev_chunk = x[:chunk].clone()
    for rnd in range(3):
        order = ("allreduce", *compress.WIRES)
        for k in order[rnd % 4:] + order[:rnd % 4]:
            if k == "allreduce":
                times[k].append(_ms(lambda: dist.psum(x), device))
            else:
                times[k].append(_ms(lambda: compress.ring_reduce_scatter(
                    x, group, wire=k,
                    residual=res if k == "int8_ef" else None), device))
        for k, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("int8_ef", torch.int8)):
            piece = dev_chunk.to(dt)
            hops[k].append(_ms(lambda: dist.ppermute(
                piece, label="hop", group=group), device))
        copies["d2h"].append(_ms(lambda: host.copy_(dev_chunk), device))
        copies["gloo"].append(_ms(lambda: dist.ppermute(
            host, label="hop", group=group), device))
        copies["h2d"].append(_ms(lambda: dev_chunk.copy_(host), device))
    out["call_ms"] = {k: statistics.median(v) for k, v in times.items()}
    out["call_ms_all"] = times
    out["hop_ms"] = {k: statistics.median(v) for k, v in hops.items()}
    out["fp32_hop_parts_ms"] = {k: statistics.median(v)
                                for k, v in copies.items()}
    out["hop_bytes"] = {"fp32": 4 * chunk, "bf16": 2 * chunk,
                        "int8_ef": chunk + 4}
    out["allreduce_bytes"] = 4 * length
    return out


PHASE15_CELLS = (
    # name, ring step options (None: phase 10's plain step)
    ("plain", None),
    ("fp32-gradient", dict(wire="fp32", aggregation="gradient")),
    ("fp32-zero1", dict(wire="fp32", aggregation="zero1")),
    ("bf16-gradient", dict(wire="bf16", aggregation="gradient")),
    ("bf16-zero1", dict(wire="bf16", aggregation="zero1")),
    ("int8_ef-gradient", dict(wire="int8_ef", aggregation="gradient")),
    ("int8_ef-zero1", dict(wire="int8_ef", aggregation="zero1")),
    ("int8_ef-zero1-m2", dict(wire="int8_ef", aggregation="zero1",
                              microbatches=2)),
    ("int8_ef-zero1-b8", dict(wire="int8_ef", aggregation="zero1",
                              comm_buckets=8)),
)


def _replicas_equal(params, device) -> bool:
    mine = _digest(params, device)
    return bool(torch.equal(dist.broadcast(mine, 0), mine))


def _time_cells(cells, batch, device, rounds: int = 2, steps: int = 3,
                replicas: bool = True):
    """Each cell ``name -> (state, step[, who])`` warmed (its first call's
    comm profile kept), then timed in turns: ``rounds`` rounds of
    ``steps`` steps per cell, the cell order rotating, each cell's
    launches read per step. ``who`` True makes a solo cell (a world of one
    inside the group), run on rank 0 alone while the others wait; a tuple
    of ranks runs the cell on those ranks alone. ``replicas``: each
    cell's parameters held bitwise across the ranks at the end. Returns
    ``(states, report)``."""
    names = list(cells)
    who = {k: cells[k][2] if len(cells[k]) > 2 else False for k in names}
    solo = {k: who[k] is not False for k in names}
    mine = {k: (dist.get_rank() in ((0,) if who[k] is True else who[k])
                if solo[k] else True) for k in names}
    states = {k: cells[k][0] for k in names}
    report = {k: {"ms": [], "launches": None} for k in names}
    for k in names:
        if mine[k]:
            with collecting() as records:
                states[k], loss = cells[k][1](states[k], batch)
            report[k]["comm"] = CommProfile(list(records)).as_dict()
            states[k], loss = cells[k][1](states[k], batch)
            report[k]["loss"] = float(loss)
        if solo[k]:
            dist.barrier(device)
    for rnd in range(rounds):
        for k in names[rnd % len(names):] + names[:rnd % len(names)]:
            dist.barrier(device)
            synchronize(device)
            _zero_counts()
            t0 = time.perf_counter()
            if mine[k]:
                for _ in range(steps):
                    states[k], loss = cells[k][1](states[k], batch)
                report[k]["last_loss"] = float(loss)
            dist.barrier(device)
            report[k]["ms"].append((time.perf_counter() - t0) * 1e3 / steps)
            report[k]["launches"] = _counts(device, steps)
    for k in names:
        report[k]["ms_per_step"] = statistics.median(report[k]["ms"])
        if replicas:
            report[k]["replicas_bitwise"] = _replicas_equal(
                states[k].params, device)
    return states, report


def phase15_two(tokens_check, directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 15 on each of two ranks: a. the rings at
    full size (the canonical padded gradient vector) against the spec,
    timed; b. the ring step: the fp32 check at B = 4 per rank on this
    rank's rows of ``tokens_check`` ``[5, n·4, T]`` (one step of SGD at lr
    1024, whose update over −lr is the averaged gradient: rank 0 returns
    it), K = 4 bitwise four per-step calls under int8_ef, and the grid of
    ``PHASE15_CELLS`` at bf16, B = 32 per rank, timed in turns with
    launches and wire bytes per step; d. ``train_llm_dp(data=2,
    overlap_microbatches=2, wire="int8_ef")`` under ZeRO-1 at vocab 259,
    batch 4 × 256 per rank, 20 steps."""
    r, n = dist.get_rank(), dist.world_size()
    total = sum(x.numel() for x in tree_leaves(llama.init_llama(
        LlamaConfig(), torch.Generator().manual_seed(0),
        device="meta").tree()))
    out = {"rank": r}
    t0 = time.perf_counter()
    out["rings"] = _ring_phase(total + (-total) % n, device, [])
    out["rings"]["seconds"] = time.perf_counter() - t0

    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    b = tokens_check.shape[1] // n
    local = torch.as_tensor(tokens_check[:, r * b:(r + 1) * b],
                            dtype=torch.long, device=device)

    def loss_fn(p, x):
        return llama.forward_loss(p, x, cfg)

    def fresh():
        return llama.init_llama(cfg, torch.Generator().manual_seed(0),
                                device=device).tree()

    with fp32_products():
        lr = 1024.0
        params = fresh()
        before = [p.detach().clone() for p in tree_leaves(params)]
        state, step = compress.make_overlap_step(
            loss_fn, sgd(lr), params, wire="fp32", device=device)
        state, loss = step(state, local[0])
        out["check"] = {"loss": float(loss)}
        if r == 0:
            out["check"]["grads"] = [
                ((p0 - p1.detach()) / lr).cpu()
                for p0, p1 in zip(before, tree_leaves(state.params))]
        del before, state, params
        kres = {}
        for name in ("per_step", "multi"):
            opt = make_optimizer("pallas")
            make = (compress.make_overlap_multi_step if name == "multi"
                    else compress.make_overlap_step)
            st, fn = make(loss_fn, opt, fresh(), wire="int8_ef",
                          aggregation="zero1", microbatches=2,
                          device=device)
            if name == "multi":
                st, ls = fn(st, local[:4])
                ls = ls.tolist()
            else:
                ls = []
                for x in local[:4]:
                    st, loss = fn(st, x)
                    ls.append(float(loss))
            kres[name] = (ls, dp.host_snapshot(st))
        (la, sa), (lb, sb) = kres["per_step"], kres["multi"]
        out["kstep"] = {
            "losses_equal": la == lb,
            "state_equal": all(
                torch.equal(x, y) for x, y in zip(nested_leaves(sa),
                                                  nested_leaves(sb))
                if isinstance(x, torch.Tensor))}
        del kres, sa, sb

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, tcfg.vocab_size, (n * 32, tcfg.ctx_size),
                           generator=gen, device=device)
    batch = tokens[r * 32:(r + 1) * 32]

    def tloss(p, x):
        return llama.forward_loss(p, x, tcfg)

    cells = {}
    for name, kw in PHASE15_CELLS:
        opt = make_optimizer("pallas")
        tree = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                                device=device).tree()
        if kw is None:
            cells[name] = (dp.init_state(tree, opt),
                           dp.make_grad_aggregation_step(tloss, opt))
        else:
            cells[name] = compress.make_overlap_step(tloss, opt, tree,
                                                     device=device, **kw)
    t0 = time.perf_counter()
    states, out["grid"] = _time_cells(cells, batch, device)
    out["grid_seconds"] = time.perf_counter() - t0
    del states, cells

    _zero_counts()
    t0 = time.perf_counter()
    rep = train_llm_dp(None, TrainConfig(
        iters=20, data=n, batch_size=4, overlap_microbatches=2,
        wire="int8_ef", optimizer="pallas"), aggregation="zero1",
        log_every=0,
        device=device)
    out["trainer"] = {"losses": rep.losses, "launches": _counts(device, 20),
                      "seconds": time.perf_counter() - t0,
                      "tokens_per_sec": rep.tokens_per_sec}
    return out


def phase15_four(directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 15 on each of four ranks laid out 2 × 2: a.
    the flat ring at four and ``hier_reduce_scatter`` at (2, 2), (1, 4)
    and (4, 1) against the spec at full size, timed; c. the two-level
    driver (fp32 islands, int8_ef across ``dcn``) at bf16, B = 16 per
    rank, gradient and ZeRO-1: ms per step, launches, the comm profile by
    axis beside the flat fp32 all-reduce's, replicas bitwise, and a save
    at step 2 resumed to step 4 against an uninterrupted 4-step run; d.
    ``train_llm_dp(dcn=2, data=2, wire_dcn="int8_ef")`` at vocab 259,
    batch 4 × 256 per rank, 20 steps, observed (``Telemetry``: its comm
    probe runs one more step, counted in the launches per step)."""
    from ..telemetry import Telemetry, read_events
    r, n = dist.get_rank(), dist.world_size()
    total = sum(x.numel() for x in tree_leaves(llama.init_llama(
        LlamaConfig(), torch.Generator().manual_seed(0),
        device="meta").tree()))
    out = {"rank": r}
    t0 = time.perf_counter()
    out["rings"] = _ring_phase(total + (-total) % n, device,
                               [(2, 2), (1, 4), (4, 1)])
    mesh = dist.hier_data_mesh(2, 2)
    x = torch.as_tensor(_ring_vectors(n, total + (-total) % n)[r],
                        device=device)
    res = torch.zeros(2 * x.numel() // n, device=device)
    out["rings"]["hier_call_ms"] = statistics.median(
        _ms(lambda: compress.hier_reduce_scatter(x, mesh, residual=res),
            device) for _ in range(3))
    del x, res
    out["rings"]["seconds"] = time.perf_counter() - t0

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    tokens = torch.randint(0, tcfg.vocab_size, (4, n * 16, tcfg.ctx_size),
                           generator=gen, device=device)
    local = tokens[:, r * 16:(r + 1) * 16]

    def tloss(p, x):
        return llama.forward_loss(p, x, tcfg)

    def make(aggregation):
        return compress.make_overlap_step(
            tloss, make_optimizer("pallas"), llama.init_llama(
                tcfg, torch.Generator().manual_seed(0), device=device
            ).tree(), mesh=mesh, wire={"ici": "fp32", "dcn": "int8_ef"},
            aggregation=aggregation, device=device)

    tree = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                            device=device).tree()
    flat = measure_comm(dp.make_grad_aggregation_step(
        tloss, make_optimizer("pallas")), dp.init_state(
        tree, make_optimizer("pallas")), local[0])
    out["flat_allreduce_wire"] = flat.wire_bytes_per_device_per_step
    del tree
    hier = {}
    for agg in ("gradient", "zero1"):
        st, fn = make(agg)
        with collecting() as records:
            st, loss = fn(st, local[0])
        comm = CommProfile(list(records)).as_dict()
        _zero_counts()
        synchronize(device)
        t0 = time.perf_counter()
        losses = [float(loss)]
        for x in local[1:]:
            st, loss = fn(st, x)
            losses.append(float(loss))
        ms = (time.perf_counter() - t0) * 1e3 / 3
        hier[agg] = {"comm": comm, "losses": losses, "ms_per_step": ms,
                     "launches": _counts(device, 3),
                     "replicas_bitwise": _replicas_equal(st.params, device),
                     "local": st.ring_residual.shape[1] // 2}
        if agg == "zero1":
            full = dp.host_snapshot(st)
            ck = os.path.join(directory, "hier")
            st, fn = make(agg)
            for x in local[:2]:
                st, _ = fn(st, x)
            Checkpointer(ck).save(2, st, overwrite=True)
            st, fn = make(agg)
            st = Checkpointer(ck).restore(st)
            resumed = []
            for x in local[2:]:
                st, loss = fn(st, x)
                resumed.append(float(loss))
            hier[agg]["resume"] = {
                "losses_equal": resumed == losses[2:],
                "state_equal": all(
                    torch.equal(a, b) for a, b in zip(
                        nested_leaves(dp.host_snapshot(st)),
                        nested_leaves(full))
                    if isinstance(a, torch.Tensor))}
        del st, fn
    out["hier"] = hier

    tel_dir = os.path.join(directory, "trainer-tel")
    _zero_counts()
    t0 = time.perf_counter()
    rep = train_llm_dp(None, TrainConfig(
        iters=20, dcn=2, data=2, batch_size=4, wire_dcn="int8_ef",
        overlap_microbatches=1, optimizer="pallas"), log_every=0,
        telemetry=Telemetry(tel_dir), device=device)
    # 20 steps and the manifest's comm probe, one more step.
    out["trainer"] = {"losses": rep.losses, "launches": _counts(device, 21),
                      "seconds": time.perf_counter() - t0,
                      "tokens_per_sec": rep.tokens_per_sec}
    if r == 0:
        events = read_events(os.path.join(tel_dir, "events.jsonl"))
        manifest = next(e for e in events if e["type"] == "manifest")
        compiles = [e for e in events if e["type"] == "compile"]
        out["trainer"].update(
            manifest_axes=sorted((manifest.get("comm") or {}).get("axes",
                                                                  {})),
            manifest_mesh=manifest.get("mesh"),
            dcn_wire=manifest["comm"]["axes"]["dcn"][
                "wire_bytes_per_device"],
            compiles=len(compiles),
            retraces=sum(1 for e in compiles if e.get("retrace")))
    return out


# -------------------------------------------------- tensor parallelism

def _tp_step(case: dict, cfg, opt, mesh, device):
    """The state and step of a TP case's ``driver``."""
    params = case["params"]
    driver = case.get("driver", "step")
    overlap = driver.startswith("overlap")
    numerics = (tp.make_tp_numerics(params, mesh, psum_data=overlap)
                if case.get("numerics") else None)
    if driver == "train":
        return (tp.init_state(mesh, params, opt, device),
                tp.make_tp_train_step(cfg, opt, mesh, device), numerics)
    if overlap:
        make = (tp.make_tp_overlap_multi_step if driver == "overlap_multi"
                else tp.make_tp_overlap_step)
        state, step = make(
            cfg, opt, mesh, params,
            aggregation=case.get("aggregation", "zero1"),
            wire=case.get("wire", "fp32"),
            overlap_microbatches=case.get("microbatches", 1),
            psa=case.get("psa", ""),
            comm_buckets=case.get("comm_buckets", 1), numerics=numerics,
            device=device)
        return state, step, numerics
    make = tp.make_tp_multi_step if driver == "multi" else tp.make_tp_step
    state, step = make(cfg, opt, mesh, params, psa=case.get("psa", ""),
                       batch_shape=case.get("batch_shape"),
                       numerics=numerics, device=device)
    return state, step, numerics


def _tp_case(case: dict, device) -> dict:
    """One TP case on this rank; see ``tp_cases``."""
    cfg = LlamaConfig(**case["cfg"])
    mesh = dist.tp_mesh(case["data"], case["model"])
    r = dist.get_rank()
    out = {"rank": r, "d": mesh.d, "m": mesh.m}
    driver = case.get("driver", "step")
    if driver == "forward":
        local = tp.shard_params(mesh, case["params"], device)
        with torch.no_grad():
            logits = tp.tp_forward(local, tp.shard_batch(
                mesh, case["batches"][0], device), cfg, mesh)
        out["logits"] = logits.cpu().numpy()
        return out
    if driver == "int8_sync":
        y = torch.as_tensor(case["y"][r], device=device)
        res0 = torch.zeros_like(y)
        out1, res1 = tp._psa_int8_sync(y, res0, mesh.model_group)
        out2, res2 = tp._psa_int8_sync(y, res1, mesh.model_group)
        exact = dist.psum(y, record=False, group=mesh.model_group)
        out.update({k: v.detach().cpu().numpy() for k, v in (
            ("out1", out1), ("out2", out2), ("res1", res1), ("res2", res2),
            ("exact", exact))})
        return out
    if driver == "trainer":
        return {**out, **_tp_trainer_call(case, device)}
    name, lr = case.get("optimizer", "fused"), case.get("lr", 1e-3)
    opt = sgd(lr) if name == "sgd" else make_optimizer(name, lr)
    state, step, numerics = _tp_step(case, cfg, opt, mesh, device)
    if case.get("restore"):
        state = Checkpointer(case["restore"]).restore(state)
    out.update({"losses": [], "comm": None, "numerics": []})
    for batch in case["batches"]:
        local = tp.shard_batch(mesh, batch, device)
        with collecting() as records:
            state, o = step(state, local)
        if out["comm"] is None:
            out["comm"] = CommProfile(list(records)).as_dict()
        loss, summary = introspect.split_step_output(o)
        if summary is not None:
            out["numerics"].append(numerics.event_fields(
                summary, index=-1 if driver.endswith("multi") else None))
        out["losses"] += loss.reshape(-1).tolist()
    out["step"] = int(state.step)
    out["params"] = convert.tree_to_numpy(state.params)
    snap = tp.host_snapshot(state)
    if r == 0:
        out["merged"] = convert.tree_to_numpy(snap.params)
        out["snapshot"] = [x.numpy() for x in nested_leaves(snap)
                           if isinstance(x, torch.Tensor)]
    if case.get("checkpoint"):
        Checkpointer(case["checkpoint"]).save(int(state.step), state,
                                              overwrite=True)
    return out


def _tp_trainer_call(case: dict, device) -> dict:
    """``train.llm.train_llm_tp`` inside this rank's group (the byte
    tokenizer): the report's losses, steps, start step and counters. A
    ``fault_plan`` keyword is a spec string, which only the ranks in
    ``case["fault_ranks"]`` (default: every rank) inject."""
    kwargs = dict(case.get("kwargs", {}))
    spec = kwargs.pop("fault_plan", None)
    if spec and dist.get_rank() in case.get("fault_ranks",
                                            range(dist.world_size())):
        kwargs["fault_plan"] = FaultPlan.from_spec(spec)
    rep = train_llm_tp(LlamaConfig(**case["cfg"]),
                       TrainConfig(**case["train_cfg"]),
                       tokenizer=ByteTokenizer(), log_every=0,
                       device=device, **kwargs)
    return {"losses": rep.losses, "steps": rep.steps,
            "start_step": rep.start_step,
            "tokens_per_sec": rep.tokens_per_sec,
            "resilience": rep.resilience.as_dict()}


def tp_cases(cases, *, device) -> list:
    """Run each TP case of ``cases`` on this rank (a rank of a ``data ×
    model`` group; every case of a launch shares the group) and return
    one dict per case, with this rank's data row ``d`` and model shard
    ``m``: ``losses``, ``step``, this rank's ``params`` (numpy), the first
    call's ``comm`` profile, the ``numerics`` event fields of every call,
    and on rank 0 the merged JAX-layout parameters (``merged``) and the
    host snapshot's tensors (``snapshot``, per-rank stacks ``[n_data, tp,
    ...]``).

    A case is a dict: ``cfg`` (``LlamaConfig`` fields), ``params`` (a JAX
    ``init_llama`` tree as numpy), ``data``, ``model``, ``batches``
    (global ``[D·B, T]`` batches, ``[K, D·B, T]`` windows for the K-step
    drivers), and optionally ``driver`` ("step", the default, "multi",
    "train" for ``make_tp_train_step``, "overlap", "overlap_multi"),
    ``psa``, ``batch_shape``, ``optimizer`` ("fused" default, "sgd", or a
    ``make_optimizer`` name), ``lr``, ``numerics``, ``aggregation``,
    ``wire``, ``microbatches``, ``comm_buckets``, ``restore`` (a
    checkpoint directory the fresh state is restored from) and
    ``checkpoint`` (a directory the final state is saved to). Three
    drivers take other keys: "forward" returns the logits of the first
    batch; "int8_sync" runs ``_psa_int8_sync`` twice on ``y[rank]`` and
    returns both outputs, both residuals and the exact sum; "trainer" runs
    ``train_llm_tp`` with ``cfg``, ``train_cfg`` (``TrainConfig`` fields),
    ``kwargs`` and ``fault_ranks`` (``_tp_trainer_call``)."""
    return [_tp_case(case, device) for case in cases]


# --------------------------------------------- chip_smoke.py phase 16

PHASE16_PSA = ("full", "defer:3", "int8_ef")


def _tp_check(mesh, tokens, device) -> dict:
    """Phase 16a on this rank: one SGD step at lr 1024 of the canonical
    model in fp32 from the seed-0 weights on this data row's rows of
    ``tokens``; the loss, and on rank 0 the merged JAX-layout gradient
    (the update over −lr)."""
    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    lr = 1024.0
    whole = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    with fp32_products():
        state, step = tp.make_tp_step(cfg, sgd(lr), mesh, whole,
                                      device=device)
        before = tp.host_snapshot(state).params
        state, loss = step(state, tp.shard_batch(mesh, tokens, device))
        after = tp.host_snapshot(state).params
    out = {"loss": float(loss)}
    if dist.get_rank() == 0:
        out["grads"] = [(b - a) / lr for b, a in zip(tree_leaves(before),
                                                     tree_leaves(after))]
    return out


def _data_replicas_equal(params, mesh, device) -> bool:
    """Whether every data row's copy of this model shard's slices holds
    the same bits."""
    mine = _digest(params, device)
    rows = dist.all_gather(mine, group=mesh.data_group).view(mesh.data, -1)
    return bool((rows == rows[0]).all())


def _solo_step(cfg, optimizer):
    """The world of one's gradient step (``dp.make_grad_aggregation_step``
    at one rank) inside a larger group: no collective."""
    from ..ops.adam import apply_optimizer

    def step(state, batch):
        leaves = tree_leaves(state.params)
        loss = llama.forward_loss(state.params, batch, cfg)
        grads = tree_unflatten(state.params,
                               list(torch.autograd.grad(loss, leaves)))
        params, opt_state = apply_optimizer(optimizer, grads,
                                            state.opt_state, state.params)
        return dp.TrainState(params, opt_state, state.step + 1), loss.detach()

    return step


def _trainer_run(tcfg: TrainConfig, directory: str, device,
                 aggregation: str = "gradient") -> dict:
    """``train_llm_tp`` inside this group with telemetry in ``directory``
    (rank 0 writes it): losses, launches per step, seconds, throughput,
    and on rank 0 the manifest's mesh and comm axes and the compiles."""
    from ..telemetry import Telemetry, read_events
    tel = Telemetry(directory)
    _zero_counts()
    t0 = time.perf_counter()
    rep = train_llm_tp(None, tcfg, aggregation=aggregation, log_every=0,
                       telemetry=tel, device=device)
    out = {"losses": rep.losses, "launches": _counts(device, tcfg.iters),
           "seconds": time.perf_counter() - t0,
           "tokens_per_sec": rep.tokens_per_sec}
    tel.close()
    dist.barrier(device)
    if dist.get_rank() == 0:
        events = read_events(os.path.join(directory, "events.jsonl"))
        manifest = next(e for e in events if e["type"] == "manifest")
        compiles = [e for e in events if e["type"] == "compile"]
        out.update(manifest_mesh=manifest["mesh"],
                   manifest_axes=sorted(manifest["comm"]["axes"]),
                   model_wire=manifest["comm"]["axes"]["model"][
                       "wire_bytes_per_device"],
                   compiles=len(compiles),
                   retraces=sum(1 for e in compiles if e.get("retrace")))
    return out


def phase16_two(tokens_check, directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 16 on each of two ranks, ``model=2`` on the
    one card: a. the fp32 check on ``tokens_check`` ``[4, 256]``
    (``_tp_check``); c. the bf16 step at B = 32 (the "pallas" optimizer)
    timed in turns with a world of one at B = 32 on rank 0, with launches
    per step, one activation sum and the replicated-gradient sum timed
    apart; d. the PSA modes ``PHASE16_PSA`` in the same turns, with their
    model-axis bytes per step; f. ``train_llm_tp(model=2, psa="int8_ef",
    steps_per_dispatch=2)`` at vocab 259 for 20 steps, and the same with
    ``psa=""``."""
    mesh = dist.tp_mesh(1, 2)
    out = {"rank": dist.get_rank(), "m": mesh.m}
    t0 = time.perf_counter()
    out["check"] = _tp_check(mesh, tokens_check, device)
    out["check_seconds"] = time.perf_counter() - t0

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    b, t = 32, tcfg.ctx_size
    whole = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    batch = torch.randint(0, tcfg.vocab_size, (b, t), generator=gen,
                          device=device)
    cells = {}
    if dist.get_rank() == 0:
        one = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                               device=device).tree()
        opt = make_optimizer("pallas")
        cells["world of one"] = (dp.init_state(one, opt),
                                 _solo_step(tcfg, opt), True)
    else:
        cells["world of one"] = (None, None, True)
    for psa in ("",) + PHASE16_PSA:
        state, step = tp.make_tp_step(
            tcfg, make_optimizer("pallas"), mesh, whole, psa=psa,
            batch_shape=(b, t), device=device)
        cells[psa or "tp"] = (state, step, False)
    t0 = time.perf_counter()
    states, out["grid"] = _time_cells(cells, batch, device,
                                      replicas=False)
    out["grid_seconds"] = time.perf_counter() - t0
    for psa in PHASE16_PSA:
        by = out["grid"][psa]["comm"]["collectives"]
        out["grid"][psa]["model_wire"] = sum(
            by[k]["wire_bytes_per_device"] for k in (
                "psa_full_sync", "psa_defer_sync", "psa_act_int8",
                "psa_act_scale") if k in by)
        out["grid"][psa]["budget"] = tp.psa_sync_wire_bytes(tcfg, psa, 2, b,
                                                            t)

    # One activation sum, and the replicated-gradient sum, alone.
    act = torch.randn(b, t, tcfg.dmodel, generator=gen, device=device,
                      dtype=torch.bfloat16)
    params = states["tp"].params
    grads = [torch.ones_like(p, dtype=torch.float32)
             for p in tree_leaves(params)]

    def timed(fn, reps):
        ms = []
        for _ in range(reps):
            dist.barrier(device)
            synchronize(device)
            t1 = time.perf_counter()
            fn()
            synchronize(device)
            ms.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ms)

    out["act_sum_ms"] = timed(lambda: dist.psum_ad(act, mesh.model_group),
                              10)
    out["act_sum_bytes"] = act.numel() * act.element_size()
    out["replicated_sum_ms"] = timed(
        lambda: tp._sum_replicated(params, grads, mesh.model_group), 5)
    out["replicated_sum_elements"] = sum(
        g.numel() for g, s in zip(grads, tree_leaves(
            tp._sharded_mask(params))) if not s)
    del states, cells, params, grads, whole

    for key, psa in (("trainer", "int8_ef"), ("trainer_plain", "")):
        out[key] = _trainer_run(TrainConfig(
            iters=20, model=2, batch_size=4, psa=psa, steps_per_dispatch=2,
            optimizer="pallas"), os.path.join(directory, f"tel16f{psa}"),
            device)
    return out


def phase16_four(tokens_check, directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 16 on each of four ranks laid out ``data=2 ×
    model=2``: a. the fp32 check on ``tokens_check`` ``[8, 256]`` (B = 4
    per data row); e. the DP×TP ring (int8_ef, ZeRO-1) at bf16, B = 16
    per data row, M ∈ {1, 2}: ms per step, launches, the data-axis ring
    bytes, data replicas bitwise, and at M = 1 a save at step 2 resumed
    to step 4 against 4 uninterrupted steps (the merged states, residuals
    included); f. ``train_llm_tp(data=2, model=2, overlap_microbatches=2,
    wire="int8_ef")`` under ZeRO-1 at vocab 259 for 20 steps."""
    mesh = dist.tp_mesh(2, 2)
    r = dist.get_rank()
    out = {"rank": r, "d": mesh.d, "m": mesh.m}
    out["check"] = _tp_check(mesh, tokens_check, device)

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True, flash_block=512)
    b, t = 16, tcfg.ctx_size
    whole = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    tokens = torch.randint(0, tcfg.vocab_size, (4, mesh.data * b, t),
                           generator=gen, device=device)
    local = tp.shard_batch(mesh, tokens, device)
    _, _, n_local, _ = tp._tp_flat_geometry(mesh, whole)
    out["local"] = n_local

    def ring(m):
        return tp.make_tp_overlap_step(
            tcfg, make_optimizer("pallas"), mesh, whole,
            aggregation="zero1", wire="int8_ef", overlap_microbatches=m,
            device=device)

    out["ring"] = {}
    for m in (1, 2):
        state, step = ring(m)
        with collecting() as records:
            state, loss = step(state, local[0])
        comm = CommProfile(list(records)).as_dict()
        ms = []
        for rnd in range(3):
            dist.barrier(device)
            synchronize(device)
            _zero_counts()
            t1 = time.perf_counter()
            state, loss = step(state, local[1 + rnd % 3])
            float(loss)
            dist.barrier(device)
            ms.append((time.perf_counter() - t1) * 1e3)
            launches = _counts(device, 1)
        by = comm["collectives"]
        out["ring"][f"m{m}"] = {
            "ms_per_step": statistics.median(ms), "ms": ms,
            "launches": launches, "axes": comm["axes"],
            "ring_int8": by["tp_ring_grad_int8"]["payload_bytes"],
            "ring_scale": by["tp_ring_grad_scale"]["payload_bytes"],
            "gather_int8": by["tp_delta_gather_int8"]["payload_bytes"],
            "data_replicas_bitwise": _data_replicas_equal(state.params, mesh,
                                                          device),
            "last_loss": float(loss)}
        del state, step

    # Save at step 2, resume, and compare with 4 uninterrupted steps.
    def run(state, step, batches):
        for x in batches:
            state, _ = step(state, x)
        return state

    straight = tp.host_snapshot(run(*ring(1), local))
    ckpt = os.path.join(directory, "ckpt16e")
    state, step = ring(1)
    state = run(state, step, local[:2])
    Checkpointer(ckpt).save(2, state, overwrite=True)
    del state
    template, step = ring(1)
    resumed = tp.host_snapshot(run(Checkpointer(ckpt).restore(template),
                                   step, local[2:]))
    out["resume_bitwise"] = all(
        torch.equal(x, y) for x, y in zip(nested_leaves(straight),
                                          nested_leaves(resumed))
        if isinstance(x, torch.Tensor))
    del straight, resumed, template, step, whole

    out["trainer"] = _trainer_run(TrainConfig(
        iters=20, data=2, model=2, batch_size=4, overlap_microbatches=2,
        wire="int8_ef", optimizer="pallas"),
        os.path.join(directory, "tel16f4"), device, aggregation="zero1")
    return out


# ------------------------------------ sequence and expert parallelism

def _axis_mesh(axis: str, data: int, size: int,
               row: bool = False) -> dist.AxisMesh:
    """The ``data × size`` mesh of ``axis``, or with ``row`` its data row
    alone (every row runs on its own)."""
    mesh = dist.axis_mesh(axis, data, size)
    return mesh.row() if row else mesh


def _case_mesh(case: dict) -> dist.AxisMesh:
    return _axis_mesh(case["axis"], case["data"], case["size"],
                      case.get("row", False))


def _window(x, mesh: dist.AxisMesh, device) -> torch.Tensor:
    """Seq shard ``mesh.i``'s window of a ``[B, T, ...]`` array, as a
    tensor on ``device`` that requires grad."""
    t = x.shape[1] // mesh.size
    return torch.as_tensor(x[:, mesh.i * t:(mesh.i + 1) * t]).to(
        device).requires_grad_()


def _opt(case: dict):
    name, lr = case.get("optimizer", "fused"), case.get("lr", 1e-3)
    return sgd(lr) if name == "sgd" else make_optimizer(name, lr)


def _steps(out: dict, state, step, mesh, case: dict, device):
    """Run ``step`` over the case's global batches (this rank's data row
    of each), keeping the losses and the first call's comm by label."""
    from . import sp
    out.update(losses=[], comm=None)
    for batch in case["batches"]:
        with collecting() as records:
            state, loss = step(state, sp.shard_batch(mesh, batch, device))
        if out["comm"] is None:
            out["comm"] = CommProfile(list(records)).by_label()
        out["losses"].append(float(loss))
    out["params"] = convert.tree_to_numpy(state.params)
    return out


def _sp_case(case: dict, device) -> dict:
    """One sequence-parallel case on this rank; see ``sp_cases``."""
    from . import sp
    mesh = _case_mesh(case)
    out = {"rank": dist.get_rank(), "d": mesh.d, "i": mesh.i}
    run = case["run"]
    if run == "ring":
        q, k, v = (_window(case[x], mesh, device) for x in "qkv")
        with collecting() as records:
            o = sp.ring_attention(q, k, v, mesh.group,
                                  causal=case["causal"])
        ct = torch.as_tensor(case["ct"][:, mesh.i * q.shape[1]:
                                        (mesh.i + 1) * q.shape[1]])
        grads = torch.autograd.grad(o, (q, k, v), ct.to(device))
        out["out"] = o.detach().cpu().numpy()
        out.update({f"d{x}": g.cpu().numpy() for x, g in zip("qkv", grads)})
        out["comm"] = CommProfile(list(records)).by_label()
        return out
    cfg = LlamaConfig(**case["cfg"])
    if run == "forward":
        model = convert.params_from_jax(case["params"], cfg, device=device)
        with torch.no_grad():
            logits = sp.sp_forward(model, sp.shard_batch(
                mesh, case["batches"][0], device), cfg, mesh)
        out["logits"] = logits.cpu().numpy()
        return out
    opt = _opt(case)
    state = sp.init_state(mesh, case["params"], opt, device)
    return _steps(out, state, sp.make_sp_train_step(cfg, opt, mesh, device),
                  mesh, case, device)


def sp_cases(cases, *, device) -> list:
    """Run each sequence-parallel case of ``cases`` on this rank and return
    one dict per case, with this rank's data row ``d`` and seq index
    ``i``. A case is a dict: ``axis`` "seq", ``data``, ``size``, ``row``
    (optional: each data row on its own), ``run`` and its keys:
    "ring" (``q``, ``k``, ``v``, ``ct`` global ``[B, T, H, Dh]`` arrays,
    ``causal``) returns this shard's ``out`` and ``dq``/``dk``/``dv``
    under the cotangent ``ct`` and the comm by label; "forward" (``cfg``,
    ``params`` a JAX ``init_llama`` tree as numpy, ``batches``) returns
    the row's logits of the first batch; "step" (also ``optimizer``,
    ``lr``) runs ``make_sp_train_step`` over the batches and returns the
    ``losses``, the first call's ``comm`` by label and the ``params``."""
    return [_sp_case(case, device) for case in cases]


def _ep_case(case: dict, device) -> dict:
    """One expert-parallel case on this rank; see ``ep_cases``."""
    from . import ep
    from ..config import MoEConfig
    mesh = _case_mesh(case)
    out = {"rank": dist.get_rank(), "d": mesh.d, "i": mesh.i}
    cfg = MoEConfig(base=LlamaConfig(**case["cfg"]), **case["moe"])
    if case["run"] == "forward":
        local = ep.shard_params(mesh, case["params"], device)
        logits, aux = ep.ep_forward(local, torch.as_tensor(
            case["batches"][0], device=device), cfg, mesh)
        out.update(logits=logits.cpu().numpy(), aux=float(aux))
        return out
    opt = _opt(case)
    state = ep.init_state(mesh, case["params"], opt, device)
    return _steps(out, state, ep.make_ep_train_step(cfg, opt, mesh, device),
                  mesh, case, device)


def ep_cases(cases, *, device) -> list:
    """Run each expert-parallel case of ``cases`` on this rank and return
    one dict per case, with ``d`` and expert shard ``i``. A case is a
    dict: ``axis`` "expert", ``data``, ``size``, ``row`` (optional),
    ``cfg`` (``LlamaConfig`` fields of the base), ``moe`` (the other
    ``MoEConfig`` fields), ``params`` (a JAX ``init_moe_llama`` tree as
    numpy), ``batches``, ``run``: "forward" returns ``ep_forward``'s
    ``logits`` and ``aux`` on the whole first batch; "step" (also
    ``optimizer``, ``lr``) runs ``make_ep_train_step`` over the batches
    (this rank's data row of each) and returns the ``losses``, the first
    call's ``comm`` by label and this rank's ``params``."""
    return [_ep_case(case, device) for case in cases]


# --------------------------------------------- chip_smoke.py phase 17

def _sgd_grads(step, state, batch, lr: float):
    """One ``step`` (plain SGD at ``lr``) from ``state``: the loss and the
    gradient leaves recovered from the update, and the new state."""
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    state, loss = step(state, batch)
    grads = [(b - a) / lr for b, a in zip(before,
                                          tree_leaves(state.params))]
    return float(loss), grads, state


def _rel_errs(got, want) -> float:
    """The largest of max|got − want| / max|want| over paired leaves."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


def _ref_grads(loss_fn, params, batches):
    """The world of one's mean loss and gradient over equal-sized
    ``batches`` (the data rows' mean)."""
    leaves = tree_leaves(params)
    loss, grads = 0.0, [torch.zeros_like(p) for p in leaves]
    for b in batches:
        l = loss_fn(params, b)
        for acc, g in zip(grads, torch.autograd.grad(l, leaves)):
            acc += g / len(batches)
        loss += float(l.detach()) / len(batches)
    return loss, grads


def _timed_ms(fn, group_barrier, device, reps: int) -> float:
    """The median host ms of ``reps`` calls of ``fn``, each started after
    ``group_barrier()`` on an idle device and ended by a device sync."""
    ms = []
    for _ in range(reps):
        group_barrier()
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


# Phase 17's layouts over its four ranks: (data, size, each row alone).
SP17_MESHES = {"ring2": (2, 2, True), "ring4": (1, 4, False),
               "d2s2": (2, 2, False)}
EP17_MESHES = {"expert2": (2, 2, True), "expert4": (1, 4, False),
               "d2e2": (2, 2, False)}


def _phase17_sp_check(tokens, device) -> dict:
    """17a: the fp32 SP forward and step (SGD at lr 1024) of the canonical
    model at T = 1024 on each layout against the world of one (plain
    attention) computed here."""
    from ..ops.losses import causal_lm_loss
    from . import sp
    cfg = LlamaConfig(ctx_size=tokens.shape[1], attention_impl="xla")
    whole = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device=device).tree()
    toks = torch.as_tensor(tokens, device=device)
    b = toks.shape[0] // 2
    loss_fn = lambda p, x: causal_lm_loss(llama.forward(p, x, cfg), x)
    out = {}
    with fp32_products():
        with torch.no_grad():
            ref_logits = llama.forward(whole, toks[:b], cfg)
        refs = {1: _ref_grads(loss_fn, whole, [toks[:b]]),
                2: _ref_grads(loss_fn, whole, [toks[:b], toks[b:]])}
        for name, spec in SP17_MESHES.items():
            mesh = _axis_mesh("seq", *spec)
            batch = toks[:b] if mesh.data == 1 else sp.shard_batch(mesh, toks,
                                                                  device)
            res = {}
            if mesh.data == 1:
                with torch.no_grad():
                    logits = sp.sp_forward(whole, batch, cfg, mesh)
                res["logits_abs_err"] = float((logits - ref_logits).abs()
                                              .max())
                del logits
            opt = sgd(1024.0)
            state = sp.init_state(mesh, whole, opt, device)
            loss, grads, state = _sgd_grads(
                sp.make_sp_train_step(cfg, opt, mesh, device), state, batch,
                1024.0)
            ref_loss, ref_grads = refs[mesh.data]
            res.update(loss=loss, ref_loss=ref_loss,
                       loss_abs_err=abs(loss - ref_loss),
                       grad_rel_err=_rel_errs(grads, ref_grads),
                       replicas_bitwise=_replicas_equal(state.params, device))
            out[name] = res
            del state, grads
    return out


def _phase17_sp_time(device) -> dict:
    """17b: the bf16 SP step at ring 4 (B = 2, T = 1024, the "pallas"
    optimizer) timed in turns with the world of one on rank 0 (plain and
    flash attention), its launches and ``ring_kv_hop`` bytes per step, and
    alone one ring hop of K and V and the fp32 gradient sum over the
    ring."""
    from . import sp
    mesh = dist.seq_mesh(1, 4)
    cfg = LlamaConfig(ctx_size=1024, dtype="bfloat16", attention_impl="xla")
    whole = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    batch = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                          device=device)
    cells = {}
    for name, c in (("world of one", cfg),
                    ("world of one flash", cfg.replace(
                        attention_impl="pallas", flash_dh_major=True))):
        if dist.get_rank() == 0:
            one = llama.init_llama(c, torch.Generator().manual_seed(0),
                                   device=device).tree()
            opt = make_optimizer("pallas")
            cells[name] = (dp.init_state(one, opt), _solo_step(c, opt), True)
        else:
            cells[name] = (None, None, True)
    opt = make_optimizer("pallas")
    cells["sp ring 4"] = (sp.init_state(mesh, whole, opt, device),
                          sp.make_sp_train_step(cfg, opt, mesh, device))
    states, grid = _time_cells(cells, batch, device, replicas=False)
    params = states["sp ring 4"].params
    grid["sp ring 4"]["replicas_bitwise"] = _replicas_equal(params, device)
    barrier = lambda: dist.psum(torch.ones((), device=device), record=False,
                                group=mesh.group)
    ones = tree_unflatten(params, [torch.ones_like(p)
                                   for p in tree_leaves(params)])
    grad_sum_ms = _timed_ms(lambda: dist.psum_tree(ones, group=mesh.group),
                            barrier, device, 3)
    del states, cells, params, ones
    # One hop: K and V of one layer's window, bf16 [2, 256, 6, 48] each.
    k, v = (torch.randn(2, 256, cfg.num_heads, cfg.head_dim, generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))

    def hop():
        with torch.no_grad():
            dist.ppermute_ad((k, v), mesh.group, label="ring_kv_hop",
                             tag=900)

    return {"grid": grid, "hop_ms": _timed_ms(hop, barrier, device, 20),
            "hop_bytes": 2 * k.numel() * k.element_size(),
            "grad_sum_ms": grad_sum_ms}


def _phase17_sp_peaks(device) -> dict:
    """17b: each rank's peak allocated bytes over one bf16 SP step at
    T = 4096 (the ``sp_bench`` twin at full width), at ring 4, 2 (each
    data row on its own) and 1 (rank 0 alone while the others wait)."""
    from ..experiments.sp_bench import step_peak
    cfg = LlamaConfig(ctx_size=4096, dtype="bfloat16", attention_impl="xla")
    out = {}
    for name, mesh in (("ring4", dist.seq_mesh(1, 4)),
                       ("ring2", dist.seq_mesh(2, 2).row()),
                       ("ring1", dist.local_mesh("seq"))):
        dist.barrier(device)
        if name != "ring1" or dist.get_rank() == 0:
            out[name] = step_peak(cfg, 4096, mesh, 2, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier(device)
    return out


def _leaf_copies(tree, device):
    """A copy of a tree of tensors on ``device`` that requires grad."""
    from ..tree import tree_map
    return tree_map(lambda x: x.detach().to(device).clone().requires_grad_(),
                    tree)


def _digest_of(tensors) -> str:
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def _phase17_ep_check(tokens, device) -> dict:
    """17c: the fp32 EP forward and step (SGD at lr 1024) of the canonical
    MoE (8 experts, top-2, capacity factor 1.25) at B = 8 per data row ×
    256 on each layout against the unsharded model computed here; the
    routing's digest and dropped share."""
    from ..config import MoEConfig
    from ..models import moe
    from ..ops.losses import causal_lm_loss
    from . import ep
    cfg = MoEConfig(base=LlamaConfig(attention_impl="pallas",
                                     flash_dh_major=True))
    whole = _leaf_copies(moe.init_moe_llama(
        cfg, torch.Generator().manual_seed(0), device="cpu"), device)
    toks = torch.as_tensor(tokens, device=device)
    b = toks.shape[0] // 2

    def loss_fn(p, x):
        logits, aux = moe.forward(p, x, cfg)
        return causal_lm_loss(logits, x) + cfg.aux_loss_coef * aux

    out = {}
    with fp32_products():
        refs = {1: _ref_grads(loss_fn, whole, [toks[:b]]),
                2: _ref_grads(loss_fn, whole, [toks[:b], toks[b:]])}
        for name, spec in EP17_MESHES.items():
            mesh = _axis_mesh("expert", *spec)
            batch = toks[:b] if mesh.data == 1 else ep.shard_batch(
                mesh, toks, device)
            local = ep.shard_params(mesh, whole, device)
            routes, ref_routes = [], []
            logits, aux = ep.ep_forward(local, batch, cfg, mesh, routes)
            with torch.no_grad():
                ref_logits, ref_aux = moe.forward(whole, batch, cfg,
                                                  routes=ref_routes)
            n_assign = cfg.top_k * batch.numel()
            dropped = [1.0 - float(d.sum()) / n_assign for d in routes]
            res = {"logits_abs_err": float((logits - ref_logits).abs().max()),
                   "aux_abs_err": abs(float(aux) - float(ref_aux)),
                   "route_digest": _digest_of(routes),
                   "route_equals_unsharded":
                       _digest_of(routes) == _digest_of(ref_routes),
                   "dropped_share": dropped}
            del logits, ref_logits, routes, ref_routes
            opt = sgd(1024.0)
            state = ep.init_state(mesh, whole, opt, device)
            loss, grads, state = _sgd_grads(
                ep.make_ep_train_step(cfg, opt, mesh, device), state, batch,
                1024.0)
            ref_loss, ref_grads = refs[mesh.data]
            mine = tree_leaves(ep.shard_params(
                mesh, tree_unflatten(whole, ref_grads), device))
            res.update(loss=loss, ref_loss=ref_loss,
                       loss_abs_err=abs(loss - ref_loss),
                       grad_rel_err=_rel_errs(grads, mine))
            out[name] = res
            del state, grads, mine, local
    return out


def _phase17_ep_time(device) -> dict:
    """17d: the bf16 EP step at expert 2 (ranks 0 and 1; the "pallas"
    optimizer, B = 8 × 256) timed in turns with the unsharded MoE step on
    rank 0, its launches per step, one combine sum and the
    replicated-gradient sum alone."""
    from ..config import MoEConfig
    from ..models import moe
    from ..ops.adam import apply_optimizer
    from ..ops.losses import causal_lm_loss
    from . import ep
    cfg = MoEConfig(base=LlamaConfig(dtype="bfloat16",
                                     attention_impl="pallas",
                                     flash_dh_major=True))
    mesh = dist.expert_mesh(2, 2).row()
    active = dist.get_rank() < 2
    whole = moe.init_moe_llama(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    batch = torch.randint(0, cfg.base.vocab_size, (8, 256), generator=gen,
                          device=device)

    def unsharded(state, x):
        leaves = tree_leaves(state.params)
        logits, aux = moe.forward(state.params, x, cfg)
        loss = causal_lm_loss(logits, x) + cfg.aux_loss_coef * aux
        grads = tree_unflatten(state.params,
                               list(torch.autograd.grad(loss, leaves)))
        params, opt_state = apply_optimizer(
            opt, grads, state.opt_state, state.params)
        return dp.TrainState(params, opt_state, state.step + 1), loss.detach()

    opt = make_optimizer("pallas")
    cells = {"unsharded": ((dp.init_state(_leaf_copies(whole, device), opt),
                            unsharded, True) if dist.get_rank() == 0
                           else (None, None, True))}
    ep_opt = make_optimizer("pallas")
    cells["ep expert 2"] = ((ep.init_state(mesh, whole, ep_opt, device),
                             ep.make_ep_train_step(cfg, ep_opt, mesh, device),
                             (0, 1)) if active else (None, None, (0, 1)))
    states, grid = _time_cells(cells, batch, device, replicas=False)
    out = {"grid": grid}
    if active:
        params = states["ep expert 2"].params
        specs = tree_leaves(ep.param_specs(params))
        reps = [torch.ones_like(p) for p, s in zip(tree_leaves(params), specs)
                if s is None]
        y = torch.randn(8 * 256, cfg.base.dmodel, generator=gen,
                        device=device).to(torch.bfloat16)
        barrier = lambda: dist.psum(torch.ones((), device=device),
                                    record=False, group=mesh.group)
        out.update(
            combine_ms=_timed_ms(lambda: dist.psum_ad(y, mesh.group),
                                 barrier, device, 10),
            combine_bytes=y.numel() * y.element_size(),
            replicated_sum_ms=_timed_ms(
                lambda: dist.psum_each(reps, mesh.group, label="x"), barrier,
                device, 5),
            replicated_elements=sum(r.numel() for r in reps))
    del states, cells
    dist.barrier(device)
    return out


def phase17(sp_tokens, ep_tokens, *, device) -> dict:
    """``chip_smoke.py`` phase 17 on each of four ranks on the one card:
    a. the fp32 SP check on ``sp_tokens`` ``[4, 1024]`` at ring 2, ring 4
    and data 2 × seq 2 (``_phase17_sp_check``); b. the bf16 SP step at
    ring 4 in turns with the world of one, one hop, and the peaks at
    T = 4096 over ring 4, 2 and 1; c. the fp32 EP check on ``ep_tokens``
    ``[16, 256]`` at expert 2, expert 4 and data 2 × expert 2; d. the
    bf16 EP step at expert 2 in turns with the unsharded step, one
    combine sum and the replicated sum. Each part's seconds ride along."""
    out = {"rank": dist.get_rank()}
    for key, fn, args in (("sp_check", _phase17_sp_check, (sp_tokens,)),
                          ("sp_time", _phase17_sp_time, ()),
                          ("sp_peaks", _phase17_sp_peaks, ()),
                          ("ep_check", _phase17_ep_check, (ep_tokens,)),
                          ("ep_time", _phase17_ep_time, ())):
        dist.barrier(device)
        t0 = time.perf_counter()
        out[key] = fn(*args, device)
        out[f"{key}_seconds"] = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


# --------------------------------------------- elastic data parallelism

def prune_checkpoint(src: str, dst: str, step: int) -> None:
    """Copy the checkpoint directory ``src`` to ``dst`` keeping only step
    ``step``, so a fresh run resumes from exactly that recovery point."""
    import shutil
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        stem = name.partition(".")[0]
        if stem.isdigit() and int(stem) != step:
            os.unlink(os.path.join(dst, name))
    dig = os.path.join(dst, "digests")
    for name in os.listdir(dig):
        if int(name.partition(".")[0]) != step:
            os.unlink(os.path.join(dig, name))


def _report_dict(rep) -> dict:
    return {"losses": rep.losses, "steps": rep.steps,
            "start_step": rep.start_step, "preempted": rep.preempted,
            "remeshes": rep.remeshes,
            "post_remesh_tokens_per_sec": rep.post_remesh_tokens_per_sec,
            "tokens_per_sec": rep.tokens_per_sec,
            "resilience": rep.resilience.as_dict()}


_TRAINERS = {"dp": train_llm_dp, "pp": train_llm_pp, "tp": train_llm_tp}


def _follow_epochs(pool) -> None:
    """On a pool rank outside a call's world: take part in every topology
    epoch the call's elastic run posts (``distributed.reform``, as a
    non-member) until the record that ends the call, which re-forms the
    whole pool."""
    while True:
        rec = pool.await_epoch()
        dist.reform(rec["members"])
        if rec.get("call_done"):
            return


def elastic_calls(calls, *, device) -> list:
    """Trainer calls (``train.llm.train_llm_dp``, ``train_llm_pp`` or
    ``train_llm_tp``) on this launch's pool, in order; returns one dict per
    call (``_report_dict`` of the report, the same on every rank of the
    call's world after an elastic call, or ``error``: the type and text of
    what the call raised).

    A call is a dict: ``cfg`` and ``train_cfg`` (``LlamaConfig`` and
    ``TrainConfig`` fields), ``kwargs`` (the trainer's; a ``fault_plan``
    spec string becomes a ``FaultPlan``), and optionally ``trainer`` ("dp",
    the default, "pp" or "tp"), ``world`` (run on the first ``world`` pool
    ranks alone, the others following the run's topology epochs; default
    the whole pool), ``audit`` (hold every re-mesh against its mirror:
    ``_ReshardAudit``, key ``audit``) and ``prune`` (``(src, dst, call
    index, remesh index)``: before the call, ``prune_checkpoint(src, dst,
    m)`` at that earlier call's re-mesh's resume step ``m``)."""
    pool = dist.pool()
    full = tuple(range(pool.size))
    out = []
    for call in calls:
        if call.get("prune") is not None:
            src, dst, ci, ri = call["prune"]
            if pool.rank == 0:
                prune_checkpoint(
                    src, dst, out[ci]["remeshes"][ri]["resume_step"])
            dist.barrier("cpu")
        world = call.get("world", pool.size)
        if world != pool.size:
            dist.reform(full[:world])
        res = None
        audit = _ReshardAudit() if call.get("audit") else None
        if pool.rank < world:
            kwargs = dict(call.get("kwargs", {}))
            if isinstance(kwargs.get("fault_plan"), str):
                kwargs["fault_plan"] = FaultPlan.from_spec(
                    kwargs["fault_plan"])
            train = _TRAINERS[call.get("trainer", "dp")]
            try:
                with audit or contextlib.nullcontext():
                    rep = train(LlamaConfig(**call["cfg"]),
                                TrainConfig(**call["train_cfg"]),
                                tokenizer=ByteTokenizer(), log_every=0,
                                device=device, **kwargs)
                res = _report_dict(rep)
            except Exception as e:         # the bar of a refusal
                res = {"error": [type(e).__name__, str(e)]}
        own = None if audit is None else audit.found
        if world != pool.size:
            if pool.rank == 0:
                pool.post_epoch({"members": list(full), "call_done": True})
            if pool.rank < world:
                dist.reform(full)
            else:
                _follow_epochs(pool)
            res = dist.broadcast_object(res, 0)
        if own is not None:     # each rank's own audits
            res = dict(res, audit=own)
        out.append(res)
    return out


class KeepWorldHook:
    """A ``scale_hook`` that asks for no change of world at every poll."""

    def __call__(self, it: int, world: int):
        return None


class PlanScaleHook:
    """A ``scale_hook`` that asks for ``plan[it]`` data rows at the chunk
    edge ``it`` (no change elsewhere)."""

    def __init__(self, plan: dict):
        self.plan = dict(plan)

    def __call__(self, it: int, world: int):
        return self.plan.get(it)


class SeriesScaleHook:
    """A ``scale_hook`` that ticks an ``Autoscaler`` (``policy``: its
    ``AutoscalePolicy`` fields) on a fixed series of p95 TTFT values, one
    per call, and returns each decision's training world: the trainer's
    side of the autoscaler without a serving fleet. The autoscaler is made
    on the first call, in the process that calls it (the training world's
    rank 0), and writes its ``scale`` events to ``events_path``."""

    def __init__(self, series, policy: dict, *, train_world: int,
                 serve_engines: int, events_path=None):
        self.series = list(series)
        self.policy = dict(policy)
        self.train_world, self.serve_engines = train_world, serve_engines
        self.events_path = events_path
        self.scaler = None

    def __call__(self, it: int, world: int):
        from ..resilience import Autoscaler, AutoscalePolicy
        from ..telemetry import EventLog
        if self.scaler is None:
            self.scaler = Autoscaler(
                AutoscalePolicy(**self.policy), train_world=self.train_world,
                serve_engines=self.serve_engines, log_fn=None,
                events=(EventLog(self.events_path)
                        if self.events_path else None))
            self._k = 0
        p95 = self.series[self._k] if self._k < len(self.series) else None
        self._k += 1
        d = self.scaler.tick(p95, it=it)
        return None if d is None else d.train_world


# --------------------------------------------- chip_smoke.py phase 18

class _WorldLaunches:
    """This process's kernel launches per world of an elastic run: the
    counters are read whenever the process leaves a world (a re-mesh it
    takes part in, or the start of a wait outside the world) and at the
    end; each segment is ``{"world": size or 0 while outside, "launches":
    {...}}``."""

    def __init__(self, device):
        from ..resilience.elastic import ElasticController
        self.device, self.cls = device, ElasticController
        self.segments, self._base, self._waiting = [], None, False

    def _cut(self, world: int) -> None:
        synchronize(self.device)
        now = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
               "flash_bwd_dkv": fa.dkv_launches, "adam": padam.launches}
        self.segments.append({"world": world, "launches": {
            k: v - self._base[k] for k, v in now.items()}})
        self._base = now

    def __enter__(self):
        cls = self.cls
        self._move, self._wait = cls._move, cls.wait_rejoin
        me = self

        def move(ctl, new_mesh, **kw):
            me._cut(ctl.mesh.devices.size)
            return me._move(ctl, new_mesh, **kw)

        def wait(ctl):
            me._cut(0)
            got = me._wait(ctl)
            me._waiting = got is None     # the run ended outside the world
            return got

        cls._move, cls.wait_rejoin = move, wait
        _zero_counts()
        self._base = {"flash_fwd": 0, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0, "adam": 0}
        return self

    def __exit__(self, *exc):
        self.cls._move, self.cls.wait_rejoin = self._move, self._wait

    def finish(self, world: int) -> list:
        if not self._waiting:     # a rank that ends waiting cut at the wait
            self._cut(world)
        return self.segments


def _own_chunks(params, n: int, stages: int):
    """``[n, coordinates]`` booleans: row r marks, on every stage of an
    ``n × stages`` pipeline grid, the coordinates of the whole tree
    ``params`` (its leaves raveled in sorted-key order) in data row r's
    own chunk of that stage's flat vector. A stage holds its ``[L/S]``
    rows of every block leaf, ``embed`` on the first, ``final_norm`` and
    ``lm_head`` on the last, the layout tag on every one, in the whole
    tree's order; its vector is padded to a multiple of n."""
    import numpy as np
    paths = introspect.leaf_paths(params)
    leaves = tree_leaves(params)
    starts = np.cumsum([0] + [x.numel() for x in leaves])
    mask = np.zeros((n, int(starts[-1])), bool)
    for s in range(stages):
        ids = []
        for p, x, b in zip(paths, leaves, starts):
            top = p.split("/")[0]
            if top == "blocks":
                per = x.numel() // stages
                ids.append(np.arange(b + s * per, b + (s + 1) * per))
            elif (top == "embed" and s == 0
                  or top in ("final_norm", "lm_head") and s == stages - 1
                  or top not in ("embed", "final_norm", "lm_head")):
                ids.append(np.arange(b, b + x.numel()))
        ids = np.concatenate(ids)
        local = -(-len(ids) // n)
        for r in range(n):
            mask[r, ids[r * local:(r + 1) * local]] = True
    return mask


def reshard_differences(pre, post, stages=None) -> list:
    """Where ``post`` (the host form, ``elastic.snapshot_state``, of the
    state an elastic re-mesh resumed with) departs from the cross-world
    placement of ``pre`` (the host mirror it was resharded from, taken at
    the old world), as texts; empty when every coordinate is in place.
    The rule is stated here in numpy, apart from the reshard code:
    parameters, the step and every leaf of unchanged shape bitwise; a
    flat per-rank stack (ZeRO-1 moment slices, the gather residual) equal
    on the parameters' coordinates, its pad zero; ring-residual row ``r``
    of the new world row ``r`` of the old on the parameters' coordinates,
    its own chunk in the new geometry and its pad zero, and a row the old
    world did not have zero; an ``act_residual`` stack (``[n_data, tp,
    ...]``) row ``r`` row ``r`` of the old, a new row zero. ``stages``:
    the new grid's stage count when the forms are a pipeline's (every
    field in the whole model's coordinates, ``pp.host_snapshot``), whose
    ring rows' own chunks follow the new stage layout (``_own_chunks``).
    One ring residual (``comm_buckets=1``)."""
    import numpy as np
    n_real = sum(x.numel() for x in tree_leaves(post.params))
    out = []

    def arr(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                          else x)

    for name in post._fields:
        a, b = getattr(pre, name), getattr(post, name)
        if name == "ring_residual":
            if isinstance(b, tuple):
                raise ValueError("reshard_differences takes one ring "
                                 "residual (comm_buckets=1)")
            a, b = arr(a), arr(b)
            n_new = b.shape[0]
            want = np.zeros_like(b)
            if stages is None:
                local = b.shape[1] // n_new
                own = np.zeros(b.shape, bool)
                for r in range(n_new):
                    own[r, r * local:(r + 1) * local] = True
                own[:, n_real:] = True
            else:
                own = _own_chunks(post.params, n_new, stages)
            for r in range(min(a.shape[0], n_new)):
                want[r, :n_real] = a[r, :n_real]
            want[own] = 0
            if not np.array_equal(b, want):
                rows = [r for r in range(n_new)
                        if not np.array_equal(b[r], want[r])]
                out.append(f"ring_residual rows {rows} misplaced")
            continue
        if name == "act_residual":
            a, b = arr(a), arr(b)
            want = np.zeros_like(b)
            keep = min(a.shape[0], b.shape[0])
            want[:keep] = a[:keep]
            if not np.array_equal(b, want):
                out.append(f"act_residual {a.shape} -> {b.shape} misplaced")
            continue
        pl, bl = nested_leaves(a), nested_leaves(b)
        if len(pl) != len(bl):
            out.append(f"{name}: {len(pl)} leaves before, {len(bl)} after")
            continue
        for i, (x, y) in enumerate(zip(pl, bl)):
            if not isinstance(y, torch.Tensor):
                continue
            x, y = arr(x), arr(y)
            if x.shape == y.shape:
                ok = np.array_equal(x, y)
            elif x.ndim == y.ndim == 1:        # a flat per-rank stack
                ok = (np.array_equal(x[:n_real], y[:n_real])
                      and not y[n_real:].any() and not x[n_real:].any())
            else:
                ok = False
            if not ok:
                out.append(f"{name} leaf {i}: {x.shape} -> {y.shape} "
                           "misplaced")
    return out


class _ReshardAudit:
    """Holds every re-mesh of an elastic run against
    ``reshard_differences``: while active, each member of a new world
    gathers the state it resumes with (``elastic.snapshot_state``, after
    ``ElasticController._remesh``) and compares it with the mirror it was
    resharded from. ``found``: one entry per re-mesh this process took
    part in, ``{"worlds": [old, new], "path", "differences"}``
    (``differences`` None on the checkpoint path, which has no mirror)."""

    def __init__(self):
        from ..resilience.elastic import ElasticController
        self.cls, self.found = ElasticController, []

    def __enter__(self):
        from ..resilience.elastic import snapshot_state
        self._remesh = orig = self.cls._remesh
        found = self.found

        def remesh(ctl, new_mesh, old_mesh, **kw):
            mirror = ctl._mirror
            resume = orig(ctl, new_mesh, old_mesh, **kw)
            post = snapshot_state(resume.state)
            found.append({
                "worlds": [old_mesh.devices.size, new_mesh.devices.size],
                "shapes": [list(old_mesh.devices.shape),
                           list(new_mesh.devices.shape)],
                "path": resume.record.path,
                "differences": (reshard_differences(
                    mirror[1], post,
                    stages=new_mesh.shape.get("stage")
                    if getattr(resume.state, "pp", None) is not None
                    else None)
                                if resume.record.path == "mirror"
                                else None)})
            return resume

        self.cls._remesh = remesh
        return self

    def __exit__(self, *exc):
        self.cls._remesh = self._remesh


def _remesh_spans(path: str) -> list:
    """Per ``remesh`` span of an event stream: its seconds and its
    children's (drain, rebuild, restore, persist, replay)."""
    from ..telemetry import read_events
    spans = [e for e in read_events(path) if e["type"] == "span"]
    out = []
    for root in (s for s in spans if s["name"] == "remesh"):
        kids = {s["name"]: s["dur_ns"] / 1e9 for s in spans
                if s.get("parent_span_id") == root["span_id"]}
        out.append({"seconds": root["dur_ns"] / 1e9, **kids})
    return out


def phase18(cfg: dict, tcfg: dict, directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 18 on this rank of a pool of four on one
    card: the elastic ``train_llm_dp`` at ``cfg`` (``LlamaConfig``
    fields) and ``tcfg`` (``TrainConfig`` fields besides the per-leg
    ones), each call on the whole pool:

    a. no fault: elastic and non-elastic, gradient at K = 1 and ZeRO-1 at
       K = 2 (losses to compare bitwise);
    b. ``device_loss@2,device_return@5`` (gradient, K = 1, mirror path,
       checkpoint and telemetry in ``directory``), then a fresh 4-rank run
       restored from the grow point;
    c. a ``SeriesScaleHook`` that resizes 4 → 2 → 4;
    d. b's walk under ``wire="int8_ef"``, M = 2, ZeRO-1, and its fresh run.

    Returns each call's report (``_report_dict``), this process's
    launches per world (``_WorldLaunches``) and its re-meshes held against
    their mirrors (``_ReshardAudit``, key ``audit``) for b, c and d, and
    from b's and d's streams each re-mesh's span seconds and the mirror's
    bytes per chunk edge (the ``memory`` events, on whichever rank wrote
    them)."""
    from ..telemetry import Telemetry, read_events
    pool = dist.pool()
    mcfg = LlamaConfig(**cfg)
    walk = "device_loss@2,device_return@5"
    iters = tcfg.pop("iters")

    def train(agg="gradient", spd=1, res=None, ckpt=None, tel=None,
              hook=None, **extra):
        kw = dict(aggregation=agg, log_every=0, checkpoint_every=1000,
                  resilience=res, scale_hook=hook, telemetry=tel)
        if ckpt is not None:
            kw["checkpoint_dir"] = os.path.join(directory, ckpt)
        t0 = time.perf_counter()
        rep = train_llm_dp(mcfg, TrainConfig(
            **tcfg, iters=iters, data=pool.size, steps_per_dispatch=spd,
            **extra), tokenizer=ByteTokenizer(), device=device, **kw)
        return dict(_report_dict(rep), seconds=time.perf_counter() - t0)

    def restored(src, dst, report, **kw):
        if pool.rank == 0:
            prune_checkpoint(os.path.join(directory, src),
                             os.path.join(directory, dst),
                             report["remeshes"][1]["resume_step"])
        dist.barrier(device)
        return train(ckpt=dst, **kw)

    def walked(name, ckpt, **kw):
        tel_dir = os.path.join(directory, f"{name}-tel")
        tel = Telemetry(tel_dir, step_every=1)
        with _WorldLaunches(device) as wl, _ReshardAudit() as audit:
            rep = train(res=ResilienceConfig(
                elastic=True, mirror_every=1, faults=walk), ckpt=ckpt,
                tel=tel, **kw)
            rep["worlds"] = wl.finish(pool.size)
        rep["audit"] = audit.found
        tel.close()
        dist.barrier(device)
        events = os.path.join(tel_dir, "events.jsonl")
        if pool.rank == 0:
            rep["spans"] = _remesh_spans(events)
            rep["mirror_bytes"] = [
                (e["it"], e.get("world"), e.get("mirror_bytes"))
                for e in read_events(events) if e["type"] == "memory"]
        return rep

    out = {"rank": pool.rank}
    t0 = time.perf_counter()
    out["a"] = {
        "ref_gradient": train(),
        "elastic_gradient": train(res=ResilienceConfig(elastic=True)),
        "ref_zero1": train(agg="zero1", spd=2),
        "elastic_zero1": train(agg="zero1", spd=2,
                               res=ResilienceConfig(elastic=True))}
    out["a_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = walked("b", "b")
    out["b_fresh"] = restored("b", "b-fresh", out["b"])
    out["b_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hook = SeriesScaleHook(
        [1.0, 1.0] + [0.1] * iters,
        dict(ttft_slo_s=1.2, sustain=2, cooldown=0, step=2,
             min_train_world=2, max_train_world=4, min_serve_engines=1,
             max_serve_engines=3), train_world=4, serve_engines=1)
    with _WorldLaunches(device) as wl, _ReshardAudit() as audit:
        out["c"] = train(res=ResilienceConfig(elastic=True), hook=hook)
        out["c"]["worlds"] = wl.finish(pool.size)
    out["c"]["audit"] = audit.found
    out["c_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring = dict(agg="zero1", wire="int8_ef", overlap_microbatches=2)
    out["d"] = walked("d", "d", **ring)
    out["d_fresh"] = restored("d", "d-fresh", out["d"], **ring)
    out["d_seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------- chip_smoke.py phase 19

PHASE19_WIRES = ("fp32", "bf16", "int8_ef")
PHASE19_CELLS = {                   # (aggregation, wire, M): timed at bf16
    "gradient fp32 M=1": ("gradient", "fp32", 1),
    "zero1 fp32 M=2": ("zero1", "fp32", 2),
    "zero1 int8_ef M=1": ("zero1", "int8_ef", 1),
    "zero1 int8_ef M=2": ("zero1", "int8_ef", 2)}
PHASE19_LR = 0.02                   # SGD, the CPU tests' relaxed-wire lr


def _own_leaf_err(a: dict, b: dict) -> float:
    """Max over the leaves of max |a − b| / max |a| (a stage's own
    leaves, on its process)."""
    return max(float((x.detach().float() - y.detach().float()).abs().max()
                     / x.detach().float().abs().max().clamp_min(1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _row_replicas_equal(params, mesh, device) -> bool:
    """This stage's parameters bitwise equal on every data row."""
    mine = _digest(params, device)
    got = dist.all_gather(mine, group=mesh.data_group)
    return bool(torch.equal(got.reshape(mesh.data, -1),
                            mine.expand(mesh.data, -1)))


def _ring_hop_ms(mesh, length: int, device, reps: int = 5) -> dict:
    """One fp32 ring hop of ``length`` coordinates (a stage's chunk)
    between data rows 0 and 1 of this stage: the round trip's median
    halved, and its device→host and host→device copies alone (row 0's
    medians); the rest of the hop is gloo's."""
    x = torch.randn(length, device=device)
    g = mesh.data_group
    trips, d2h, h2d = [], [], []
    for k in range(reps):
        if mesh.d == 0:
            synchronize(device)
            t0 = time.perf_counter()
            dist.send(x, 1, tag=k, label="pp_ring_hop", group=g)
            y = dist.recv(1, x.shape, x.dtype, tag=k, group=g, device=device)
            synchronize(device)
            trips.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            host = x.to("cpu")
            d2h.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            y = host.to(device)
            synchronize(device)
            h2d.append((time.perf_counter() - t0) * 1e3)
        else:
            y = dist.recv(0, x.shape, x.dtype, tag=k, group=g, device=device)
            dist.send(y, 0, tag=k, label="pp_ring_hop", group=g)
    dist.barrier(device)
    if mesh.d != 0:
        return {}
    hop, a, b = (statistics.median(trips) / 2, statistics.median(d2h),
                 statistics.median(h2d))
    return {"hop_ms": hop, "d2h_ms": a, "h2d_ms": b,
            "gloo_ms": hop - a - b, "bytes": length * 4}


def _phase19_ring(tokens_check, tokens_time, directory: str, device) -> dict:
    """19a on this rank of ``pipeline_mesh(2, 2)`` at the canonical width
    (vocab 32000, 3 layers per stage, GPipe, 2 pipeline microbatches):
    the fp32 check on ``tokens_check`` ``[4, 2·4, T]`` (SGD, lr 0.02, 4
    steps) of the plain step and of every ring cell, {fp32, bf16, int8_ef}
    × {gradient, zero1} × M {1, 2}: each cell's losses, its stage leaves'
    error against the plain step's, its data rows bitwise; the int8_ef
    ZeRO-1 M=1 K=2 window's comm profile and the plain step's; at M = 2,
    K = 2 bitwise two per-step calls and a checkpoint resume bitwise the
    uninterrupted run (fused Adam); the bf16 cells of ``PHASE19_CELLS``
    and the plain step on ``tokens_time`` ``[2·16, T]`` timed in turns
    with launches per step; one fp32 ring hop of this stage's chunk."""
    mesh = dist.pipeline_mesh(2, 2)
    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    whole = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    out = {"stage": mesh.s, "d": mesh.d}
    n, pad, local, total = pp._pp_flat_geometry(mesh, whole)
    out["geometry"] = {"n": n, "pad": pad, "chunk": local,
                       "coordinates": total}
    batches = [pp.shard_batch(mesh, b, device) for b in tokens_check]
    opt = sgd(PHASE19_LR)

    def run(state, step, batches):
        losses = []
        for b in batches:
            state, loss = step(state, b)
            losses.append(float(loss))
        return state, losses

    with fp32_products():
        state = pp.init_state(mesh, whole, opt, device=device)
        step = pp.make_pipeline_step(cfg, opt, mesh, 2, device=device)
        with collecting() as records:
            state, first = step(state, batches[0])
        plain_prof = CommProfile(list(records))
        plain, losses = run(state, step, batches[1:])
        out["plain"] = {"losses": [float(first)] + losses,
                        "comm": plain_prof.as_dict()}
        out["cells"] = {}
        for wire in PHASE19_WIRES:
            for agg in ("gradient", "zero1"):
                for m in (1, 2):
                    state, step = pp.make_pipeline_overlap_step(
                        cfg, opt, mesh, whole, n_microbatches=2,
                        aggregation=agg, wire=wire, overlap_microbatches=m,
                        device=device)
                    state, losses = run(state, step, batches)
                    out["cells"][f"{wire} {agg} M={m}"] = {
                        "losses": losses,
                        "leaf_err": _own_leaf_err(plain.params,
                                                  state.params),
                        "replicas_bitwise": _row_replicas_equal(
                            state.params, mesh, device)}
                    del state, step
        del plain

        # Bytes: the int8_ef ZeRO-1 M=1 window of K = 2.
        adam = make_optimizer("fused", 1e-3)
        state, step = pp.make_pipeline_overlap_multi_step(
            cfg, adam, mesh, whole, n_microbatches=2, aggregation="zero1",
            wire="int8_ef", overlap_microbatches=1, device=device)
        window = torch.stack(batches[:2])
        with collecting() as records:
            step(state, window)
        out["bytes"] = {"K": 2, "M": 1,
                        "profile": CommProfile(list(records)).as_dict(
                            steps_per_dispatch=2)}
        del state, step

        # Replay: K = 2 against two per-step calls (M = 2); a resume.
        state, step = pp.make_pipeline_overlap_multi_step(
            cfg, adam, mesh, whole, n_microbatches=2, aggregation="zero1",
            wire="int8_ef", overlap_microbatches=2, device=device)
        k2, k2_losses = step(state, window)

        state, one = pp.make_pipeline_overlap_step(
            cfg, adam, mesh, whole, n_microbatches=2, aggregation="zero1",
            wire="int8_ef", overlap_microbatches=2, device=device)
        state, per_step = run(state, one, batches[:2])
        out["kstep"] = {
            "losses_bitwise": [float(x) for x in k2_losses] == per_step,
            "state_bitwise": all(
                torch.equal(a, b) for a, b in zip(nested_leaves(k2),
                                                  nested_leaves(state))
                if isinstance(a, torch.Tensor))}
        ck = os.path.join(directory, "pp19")
        Checkpointer(ck).save(2, state, overwrite=True)
        straight, rest = run(state, one, batches[2:])
        template, one = pp.make_pipeline_overlap_step(
            cfg, adam, mesh, whole, n_microbatches=2, aggregation="zero1",
            wire="int8_ef", overlap_microbatches=2, device=device)
        resumed, again = run(Checkpointer(ck).restore(template), one,
                             batches[2:])
        out["resume"] = {
            "losses_bitwise": rest == again,
            "state_bitwise": all(
                torch.equal(a, b) for a, b in zip(nested_leaves(straight),
                                                  nested_leaves(resumed))
                if isinstance(a, torch.Tensor))}
        del k2, state, straight, resumed, template
    del whole

    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True)
    whole = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    popt = make_optimizer("pallas")
    cells = {"plain": (pp.init_state(mesh, whole, popt, device=device),
                       pp.make_pipeline_step(tcfg, popt, mesh, 2,
                                             device=device))}
    for name, (agg, wire, m) in PHASE19_CELLS.items():
        cells[name] = pp.make_pipeline_overlap_step(
            tcfg, popt, mesh, whole, n_microbatches=2, aggregation=agg,
            wire=wire, overlap_microbatches=m, device=device)
    del whole
    batch = pp.shard_batch(mesh, tokens_time, device)
    states, out["timing"] = _time_cells(cells, batch, device,
                                        replicas=False)
    for name, st in states.items():
        out["timing"][name]["replicas_bitwise"] = _row_replicas_equal(
            st.params, mesh, device)
    del states, cells
    out["hop"] = _ring_hop_ms(mesh, local, device)
    return out


def _phase19_trainers(cfg: dict, tcfg: dict, directory: str,
                      device) -> dict:
    """19b and 19c on this rank of the pool: the elastic ``train_llm_pp``
    and ``train_llm_tp`` runs at ``cfg`` (``LlamaConfig`` fields) and
    ``tcfg`` (``TrainConfig`` fields), each a call of ``elastic_calls`` (a
    world below the pool's runs on its first ranks), with the launches of
    each world (``_WorldLaunches``), the re-meshes held against their
    mirrors (``audit``) and each re-mesh's span seconds."""
    from ..telemetry import Telemetry
    pool = dist.pool()
    iters = tcfg.pop("iters")
    ring = dict(aggregation="zero1")
    ring_tc = dict(wire="int8_ef", overlap_microbatches=2)
    loss, trip = "device_loss@2", "device_loss@2,device_return@4:3"

    def call(trainer, d, second, *, name=None, res=None, tel=False,
             kw=None, tc=None):
        kwargs = dict(kw or {}, checkpoint_every=1000,
                      resilience=(ResilienceConfig(**res)
                                  if res is not None else None))
        if name is not None:
            kwargs["checkpoint_dir"] = os.path.join(directory, name)
        if tel:
            kwargs["telemetry"] = Telemetry(
                os.path.join(directory, f"{name}-tel"), step_every=1)
        grid = (dict(stage=second, microbatches=2) if trainer == "pp"
                else dict(model=second))
        return dict(trainer=trainer, cfg=cfg, world=d * second,
                    audit=res is not None and "faults" in res,
                    train_cfg=dict(tcfg, **(tc or {}), iters=iters, data=d,
                                   **grid),
                    kwargs=kwargs)

    def fresh(trainer, src, rep, d, second, remesh, **kw):
        dst = f"{src}-fresh"
        if pool.rank == 0:
            prune_checkpoint(os.path.join(directory, src),
                             os.path.join(directory, dst),
                             rep["remeshes"][remesh]["resume_step"])
        dist.barrier(device)
        return calls(call(trainer, d, second, name=dst, **kw))

    def calls(c):
        t0 = time.perf_counter()
        with _WorldLaunches(device) as wl:
            rep, = elastic_calls([c], device=device)
            final = (rep["remeshes"][-1]["new_world"]
                     if rep.get("remeshes") else c["world"])
            rep["worlds"] = wl.finish(final if pool.rank < c["world"]
                                      else 0)
        rep["seconds"] = time.perf_counter() - t0
        tel = c["kwargs"].get("telemetry")
        if tel is not None:
            tel.close()
            dist.barrier(device)
            if pool.rank == 0:
                rep["spans"] = _remesh_spans(
                    os.path.join(tel.out_dir, "events.jsonl"))
        return rep

    el = dict(elastic=True, mirror_every=1)
    out = {"rank": pool.rank}
    t0 = time.perf_counter()
    out["b_plain"] = calls(call("pp", 2, 2))
    out["b_plain_el"] = calls(call("pp", 2, 2, res=dict(elastic=True)))
    out["b_ring"] = calls(call("pp", 2, 2, kw=ring, tc=ring_tc))
    out["b_ring_el"] = calls(call("pp", 2, 2, kw=ring, tc=ring_tc,
                                  res=dict(elastic=True)))
    out["b_stage"] = calls(call("pp", 1, 3, name="b_stage", tel=True,
                                res=dict(el, faults=loss)))
    out["b_stage_fresh"] = fresh("pp", "b_stage", out["b_stage"], 1, 2, 0)
    out["b_trip"] = calls(call("pp", 1, 3, name="b_trip", tel=True,
                               res=dict(el, faults=trip)))
    out["b_trip_fresh"] = fresh("pp", "b_trip", out["b_trip"], 1, 3, 1)
    out["b_rows"] = calls(call("pp", 2, 2, name="b_rows", tel=True, kw=ring,
                               tc=ring_tc, res=dict(el, faults=loss)))
    out["b_rows_fresh"] = fresh("pp", "b_rows", out["b_rows"], 1, 2, 0,
                                kw=ring, tc=ring_tc)
    out["b_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    psa = dict(psa="int8_ef")
    out["c_rows"] = calls(call("tp", 2, 2, name="c_rows", tel=True, tc=psa,
                               res=dict(el, faults=loss)))
    out["c_rows_fresh"] = fresh("tp", "c_rows", out["c_rows"], 1, 2, 0,
                                tc=psa)
    out["c_fatal"] = calls(call("tp", 1, 2, tc=psa,
                                res=dict(el, faults="device_loss@1")))
    out["c_seconds"] = time.perf_counter() - t0
    return out


def phase19(tokens_check, tokens_time, cfg: dict, tcfg: dict,
            directory: str, *, device) -> dict:
    """``chip_smoke.py`` phase 19 on this rank of a pool of four on one
    card: a. the DP×PP ring drivers at data 2 × stage 2
    (``_phase19_ring``); b. elastic ``train_llm_pp`` and c. elastic
    ``train_llm_tp`` (``_phase19_trainers``). Returns the numbers; the
    caller checks them."""
    t0, wall0 = time.perf_counter(), time.time()
    out = {"a": _phase19_ring(tokens_check, tokens_time, directory, device)}
    out["a_seconds"] = time.perf_counter() - t0
    dist.barrier(device)
    out.update(_phase19_trainers(cfg, dict(tcfg), directory, device))
    out["wall"] = [wall0, time.time()]     # the parent's spawn and exit
    return out


# ------------------------------------------------ chip_smoke.py phase 20

PHASE20_LR = 0.02                   # SGD in the fp32 checks
PHASE20_CELLS = {                   # 20b's ring cells: (aggregation, wire, M)
    "gradient fp32 M=1": ("gradient", "fp32", 1),
    "zero1 int8_ef M=1": ("zero1", "int8_ef", 1)}


def _cell_replicas_equal(params, mesh, device) -> bool:
    """This cell's parameters bitwise equal on every data row, and every
    leaf the model shards hold whole bitwise equal across them."""
    rows = _row_replicas_equal(params, mesh, device)
    shared = [x for x, whole in zip(tree_leaves(params),
                                    pp._replicated(params)) if whole]
    mine = _digest(shared, device)
    got = dist.all_gather(mine, group=mesh.model_group)
    return rows and bool(torch.equal(got.reshape(mesh.model, -1),
                                     mine.expand(mesh.model, -1)))


def _act_sum_ms(group, shape, device, reps: int = 10) -> float:
    """The median ms of one activation sum (``psum_ad``) of a bf16
    ``shape`` over ``group``, staged through the host in fp32."""
    act = torch.randn(*shape, device=device).to(torch.bfloat16)
    ms = []
    for _ in range(reps):
        dist.barrier(device)
        synchronize(device)
        t0 = time.perf_counter()
        dist.psum_ad(act, group)
        synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def phase20_four(tokens_check, tokens_time, *, device) -> dict:
    """``chip_smoke.py`` phase 20a on this rank of ``pipeline_mesh(1, 2,
    2)`` at the canonical width (vocab 32000, 3 layers per stage, 3 heads
    per model shard): the fp32 check of GPipe and 1F1B at M = 2 on
    ``tokens_check`` ``[4, T]`` (this cell's gradient, from
    ``pp.loss_and_grad``, against the world of one's sliced to the cell,
    and the loss); then at bf16, B = 16 (``tokens_time``), the 1 × 2 × 2
    step timed in turns with the plain DP×PP step at 1 × 2 (model shard
    0's ranks) and with TP at 1 × 2 (stage 0's ranks), with launches per
    step, and one activation sum over the model group timed alone."""
    mesh = dist.pipeline_mesh(1, 2, 2)
    out = {"rank": dist.get_rank(), "s": mesh.s, "m": mesh.m}
    t0 = time.perf_counter()
    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    whole = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    tokens = torch.as_tensor(tokens_check, dtype=torch.long, device=device)
    with fp32_products():
        full = _leaf_copies(whole, device)
        ref_loss = llama.forward_loss(full, tokens, cfg)
        ref = tree_unflatten(full, list(torch.autograd.grad(
            ref_loss, tree_leaves(full))))
        ref = pp._cell_tree(ref, mesh)
        out["check"] = {}
        for sched in ("gpipe", "1f1b"):
            state = pp.init_state(mesh, whole, sgd(1.0), device=device)
            loss, grads = pp.loss_and_grad(state, tokens, cfg, mesh, 2,
                                           sched, device=device)
            out["check"][sched] = {
                "loss_err": abs(float(loss.detach())
                                - float(ref_loss.detach())),
                "grad_rel_err": _own_leaf_err(ref, grads)}
        del full, ref, state, grads
    out["check_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True)
    whole = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    popt = make_optimizer("pallas")
    me = (dist.get_rank(),)
    pp_ranks = (0, 2)                    # model shard 0: stages 0 and 1
    tp_ranks = (0, 1)                    # stage 0: model shards 0 and 1
    cells = {"pp x tp 1x2x2": (pp.init_state(mesh, whole, popt,
                                             device=device),
                               pp.make_pipeline_step(tcfg, popt, mesh, 2,
                                                     device=device), False)}
    if dist.get_rank() in pp_ranks:
        pmesh = dataclasses.replace(
            mesh, model=1, m=0, model_group=dist.Group("model", me, 0),
            ring_model_group=dist.Group("model", me, 0))
        cells["pp 1x2"] = (pp.init_state(pmesh, whole, popt, device=device),
                           pp.make_pipeline_step(tcfg, popt, pmesh, 2,
                                                 device=device), pp_ranks)
    else:
        cells["pp 1x2"] = (None, None, pp_ranks)
    if dist.get_rank() in tp_ranks:
        tmesh = dist.TPMesh(1, 2, 0, mesh.m, mesh.model_group,
                            dist.Group("data", me, 0),
                            mesh.ring_model_group)
        cells["tp 1x2"] = tp.make_tp_step(tcfg, popt, tmesh, whole,
                                          device=device) + (tp_ranks,)
    else:
        cells["tp 1x2"] = (None, None, tp_ranks)
    del whole
    batch = torch.as_tensor(tokens_time, dtype=torch.long, device=device)
    states, out["timing"] = _time_cells(cells, batch, device,
                                        replicas=False)
    out["timing"]["pp x tp 1x2x2"]["replicas_bitwise"] = \
        _cell_replicas_equal(states["pp x tp 1x2x2"].params, mesh, device)
    del states, cells
    out["act_sum_ms"] = _act_sum_ms(mesh.model_group,
                                    (16, tcfg.ctx_size, tcfg.dmodel), device)
    out["act_sum_bytes"] = 16 * tcfg.ctx_size * tcfg.dmodel * 2
    out["time_seconds"] = time.perf_counter() - t0
    return out


def _phase20_check(mesh, tokens_check, device) -> dict:
    """20b's fp32 check on this rank: the plain 2 × 2 × 2 step and the
    fp32 gradient ring (M = 1) over ``tokens_check`` ``[3, 2·4, T]`` (SGD
    at ``PHASE20_LR``): both losses, the ring cell's leaves against the
    plain step's (relative to each leaf's max), the data rows and model
    replicas bitwise; the int8_ef ZeRO-1 M = 1 window of K = 2 (fused
    Adam): its comm profile, bitwise two per-step calls, and its replicas."""
    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    whole = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    batches = [pp.shard_batch(mesh, b, device) for b in tokens_check]
    opt = sgd(PHASE20_LR)
    out = {}

    def run(state, step, batches):
        losses = []
        for b in batches:
            state, loss = step(state, b)
            losses.append(float(loss))
        return state, losses

    with fp32_products():
        plain, out["plain_losses"] = run(
            pp.init_state(mesh, whole, opt, device=device),
            pp.make_pipeline_step(cfg, opt, mesh, 2, device=device), batches)
        state, step = pp.make_pipeline_overlap_step(
            cfg, opt, mesh, whole, n_microbatches=2, aggregation="gradient",
            wire="fp32", overlap_microbatches=1, device=device)
        state, out["ring_losses"] = run(state, step, batches)
        out["ring_leaf_err"] = _own_leaf_err(plain.params, state.params)
        out["ring_replicas_bitwise"] = _cell_replicas_equal(
            state.params, mesh, device)
        del plain, state, step

        adam = make_optimizer("fused", 1e-3)
        state, step = pp.make_pipeline_overlap_multi_step(
            cfg, adam, mesh, whole, n_microbatches=2, aggregation="zero1",
            wire="int8_ef", overlap_microbatches=1, device=device)
        window = torch.stack(batches[:2])
        with collecting() as records:
            k2, k2_losses = step(state, window)
        out["bytes"] = {"K": 2, "M": 1,
                        "profile": CommProfile(list(records)).as_dict(
                            steps_per_dispatch=2)}
        state, one = pp.make_pipeline_overlap_step(
            cfg, adam, mesh, whole, n_microbatches=2, aggregation="zero1",
            wire="int8_ef", overlap_microbatches=1, device=device)
        state, per_step = run(state, one, batches[:2])
        out["kstep"] = {
            "losses_bitwise": [float(x) for x in k2_losses] == per_step,
            "state_bitwise": all(
                torch.equal(a, b) for a, b in zip(nested_leaves(k2),
                                                  nested_leaves(state))
                if isinstance(a, torch.Tensor))}
        out["int8_replicas_bitwise"] = _cell_replicas_equal(
            state.params, mesh, device)
    n, pad, local, total = pp._pp_flat_geometry(mesh, whole)
    out["geometry"] = {"n": n, "pad": pad, "chunk": local,
                       "coordinates": total}
    return out


def _phase20_trainer(directory: str, device) -> dict:
    """20b's ``train_llm_pp(mesh={"data": 2, "stage": 2, "model": 2})`` at
    vocab 259 (the byte tokenizer), batch 4 × 256 per row, 3 steps, the
    "pallas" optimizer, with launches per step; then the same steps driven
    by hand through ``pp.make_pipeline_step`` from the same weights and
    this row's stream (``shard_batches``, skip d·5000): both losses."""
    from ..data.tokens import shard_batches
    tcfg = TrainConfig(batch_size=4, seq_len=256, iters=3, data=2, stage=2,
                       microbatches=2, optimizer="pallas")
    cfg = LlamaConfig(attention_impl="pallas", flash_dh_major=True)
    shape = {"data": 2, "stage": 2, "model": 2}
    _zero_counts()
    t0 = time.perf_counter()
    rep = train_llm_pp(cfg, tcfg, mesh=shape, tokenizer=ByteTokenizer(),
                       log_every=0, device=device)
    out = {"losses": rep.losses, "launches": _counts(device, tcfg.iters),
           "seconds": time.perf_counter() - t0}
    mesh = dist.pipeline_mesh(2, 2, 2)
    tok = ByteTokenizer()
    mcfg = cfg.replace(vocab_size=tok.vocab_size)
    whole = llama.init_llama(mcfg, torch.Generator().manual_seed(tcfg.seed),
                             device="cpu").tree()
    opt = make_optimizer(tcfg.optimizer, tcfg.lr)
    state = pp.init_state(mesh, whole, opt, device=device)
    step = pp.make_pipeline_step(mcfg, opt, mesh, tcfg.microbatches,
                                 device=device)
    stream = shard_batches(tok, tcfg.batch_size, tcfg.seq_len, mesh.d,
                           shard_skip=5000, seed=tcfg.seed)
    out["driver_losses"] = []
    for _ in range(tcfg.iters):
        state, loss = step(state, torch.as_tensor(next(stream),
                                                  dtype=torch.long,
                                                  device=device))
        out["driver_losses"].append(float(loss))
    return out


def phase20_eight(tokens_check, tokens_time, directory: str, *,
                  device) -> dict:
    """``chip_smoke.py`` phase 20b on this rank of ``pipeline_mesh(2, 2,
    2)`` at the canonical width: the fp32 checks (``_phase20_check``),
    the bf16 cells of ``PHASE20_CELLS`` and the plain step at B = 16 per
    row (``tokens_time`` ``[2·16, T]``), timed in turns with launches per
    step and the replicas held, and the trainer route
    (``_phase20_trainer``)."""
    mesh = dist.pipeline_mesh(2, 2, 2)
    out = {"rank": dist.get_rank(), "d": mesh.d, "s": mesh.s, "m": mesh.m}
    t0 = time.perf_counter()
    out["check"] = _phase20_check(mesh, tokens_check, device)
    out["check_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tcfg = LlamaConfig(dtype="bfloat16", attention_impl="pallas",
                       flash_dh_major=True)
    whole = llama.init_llama(tcfg, torch.Generator().manual_seed(0),
                             device="cpu").tree()
    popt = make_optimizer("pallas")
    cells = {"plain": (pp.init_state(mesh, whole, popt, device=device),
                       pp.make_pipeline_step(tcfg, popt, mesh, 2,
                                             device=device))}
    for name, (agg, wire, m) in PHASE20_CELLS.items():
        cells[name] = pp.make_pipeline_overlap_step(
            tcfg, popt, mesh, whole, n_microbatches=2, aggregation=agg,
            wire=wire, overlap_microbatches=m, device=device)
    del whole
    batch = pp.shard_batch(mesh, tokens_time, device)
    states, out["timing"] = _time_cells(cells, batch, device,
                                        replicas=False)
    for name, st in states.items():
        out["timing"][name]["replicas_bitwise"] = _cell_replicas_equal(
            st.params, mesh, device)
    del states, cells
    out["time_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["trainer"] = _phase20_trainer(directory, device)
    out["trainer_seconds"] = time.perf_counter() - t0
    return out
