"""The port's elastic data parallelism (``resilience/elastic.py``,
``parallel/mesh.py``, the cross-world ``dp.reshard_state`` and
``train_llm_dp(resilience=ResilienceConfig(elastic=True))``) against the
JAX package's, on ``tests/test_elastic.py``'s tiny config: the byte
tokenizer's vocab 259, dmodel 20 (4-way and 3-way ZeRO-1 pads differ, so
every shrink swaps the pad), 2 heads, 2 layers, ctx 16, batch 2 × 16 per
rank, lr 3e-3, fused Adam.

Pure functions, without a launch: ``survivor_submesh`` and
``rejoin_mesh`` name the same ranks as JAX's do devices (pool order
included, refusals with JAX's texts); ``_resize_ring_residual`` equals
JAX's on the same numpy input; ``reshard_state`` places a JAX 4-way
snapshot (ZeRO-1 moments; bucketed int8 residual tuples) into the port's
3- and 2-way templates exactly where JAX's puts it, with JAX's two
refusals; victims and arrivals are JAX's.

One launch of four CPU ranks for the module (``programs.elastic_calls``,
with a timeout) runs every trainer call; the tests read its results:

- with no fault, the elastic losses are bitwise the non-elastic run's
  (gradient at K = 1, ZeRO-1 at K = 2);
- ``device_loss@3`` shrinks 4 → 3 on the mirror path (nothing replayed)
  and on the checkpoint path (``mirror_every=0``, ``checkpoint_every=4``,
  2 steps replayed), the continued losses bitwise a fresh 3-rank run
  restored from the recovery step;
- 4 → 3 → 2, whose second loss takes pool rank 0 (the writer), completes
  with finite losses, and every rank returns the final world's report;
  4 → 3 → 2 → 4 brings pool rank 0 back as the writer, holding the
  run's whole record;
- JAX's four 4 → 3 → 4 round trips, the int8_ef ring (M = 2) and the
  bucketed int8_ef ring (4 → 2 → 4, ``comm_buckets=5``) are bitwise a
  fresh 4-rank run restored from the grow point, ``returned == lost``;
- a loss without elastic mode is fatal (and at a world of one, with it);
- a stream written across the loss of its writer holds JAX-valid
  ``remesh`` events with JAX's keys, numbered without a gap, and the
  ``remesh`` span tree's five children;
- losses within 1e-5 of JAX's ``train_llm_dp`` under the same fault plan
  (4 → 3 → 2, 4 → 3 → 4 and 4 → 3 → 2 → 4), from the port's seed-0
  init;
- every ``ValueError`` of elastic mode has JAX's type and text."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import ResilienceConfig as JaxResilienceConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import causal_lm_loss as jcausal_lm_loss
from ddl25spring_tpu.parallel import compress as jcompress
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel import mesh as jmesh
from ddl25spring_tpu.resilience import ReplicaLossError as JaxLoss
from ddl25spring_tpu.resilience import ReplicaReturnSignal as JaxReturn
from ddl25spring_tpu.telemetry.events import validate_event
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.config import (LlamaConfig, ResilienceConfig,
                                          TrainConfig)
from ddl25spring_tpu_torch.convert import params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import (compress, distributed, dp,
                                            mesh, programs)
from ddl25spring_tpu_torch.resilience import (ElasticController,
                                              ReplicaLossError,
                                              ReplicaReturnSignal)
from ddl25spring_tpu_torch.resilience.elastic import RemeshRecord
from ddl25spring_tpu_torch.telemetry import Telemetry, read_events
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm
from ddl25spring_tpu_torch.tree import nested_leaves, nested_unflatten

torch.set_num_threads(1)

TINY = dict(vocab_size=259, dmodel=20, num_heads=2, n_layers=2, ctx_size=16)
BASE = dict(batch_size=2, seq_len=16, lr=3e-3, optimizer="fused")
EL = ResilienceConfig(elastic=True)
# 4 -> 3 -> 2 -> 4: pool rank 0 leaves with the second loss and returns.
BACK = "device_loss@1,device_loss@3,device_return@5:2"
# (aggregation, K, mirror_every, checkpoint_every, path, return at, replay):
# JAX's four round trips (tests/test_elastic.py).
ROUND_TRIPS = [("zero1", 2, 1, 1000, "mirror", 5, 0),
               ("zero1", 1, 0, 2, "checkpoint", 6, 1),
               ("gradient", 1, 1, 1000, "mirror", 5, 0),
               ("gradient", 2, 0, 2, "checkpoint", 5, 0)]


def _call(iters, *, agg="zero1", spd=2, res=None, ckpt=None,
          ckpt_every=1000, wire="fp32", ovl=0, cb=1, **extra):
    kwargs = dict(aggregation=agg, resilience=res,
                  checkpoint_every=ckpt_every)
    if ckpt is not None:
        kwargs["checkpoint_dir"] = ckpt
    kwargs.update(extra.pop("kwargs", {}))
    return dict(cfg=TINY, kwargs=kwargs, **extra,
                train_cfg=dict(BASE, iters=iters, data=extra.get(
                    "world", 4), steps_per_dispatch=spd, wire=wire,
                    overlap_microbatches=ovl, comm_buckets=cb))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of four ranks: every trainer call of the module."""
    d = tmp_path_factory.mktemp("elastic")
    ck = lambda name: str(d / name)                      # noqa: E731
    tel = Telemetry(str(d / "tel"))
    calls = {
        "ref_z": _call(6),
        "el_z": _call(6, res=EL),
        "ref_g": _call(6, agg="gradient", spd=1),
        "el_g": _call(6, agg="gradient", spd=1, res=EL),
        "shrink_m": _call(8, ckpt=ck("sm"), res=ResilienceConfig(
            elastic=True, mirror_every=1, faults="device_loss@3")),
        "shrink_c": _call(8, ckpt=ck("sc"), ckpt_every=4,
                          res=ResilienceConfig(elastic=True, mirror_every=0,
                                               faults="device_loss@3")),
        "two": _call(10, res=ResilienceConfig(
            elastic=True, faults="device_loss@1,device_loss@3")),
        "back": _call(12, res=ResilienceConfig(
            elastic=True, faults=BACK)),
        "int8": _call(8, spd=1, wire="int8_ef", ovl=2, ckpt=ck("i8"),
                      res=ResilienceConfig(
                          elastic=True, mirror_every=1,
                          faults="device_loss@2,device_return@5")),
        "int8_b5": _call(8, spd=1, wire="int8_ef", ovl=2, cb=5,
                         ckpt=ck("i8b"), res=ResilienceConfig(
                             elastic=True, mirror_every=1,
                             faults="device_loss@2:2,device_return@5:2")),
        "no_elastic": _call(6, res=ResilienceConfig(
            elastic=False, faults="device_loss@1")),
        "observed": _call(8, res=ResilienceConfig(
            elastic=True, faults="device_loss@1,device_loss@3"),
            kwargs=dict(telemetry=tel)),
    }
    for i, (agg, spd, me, ce, _, ret, _) in enumerate(ROUND_TRIPS):
        calls[f"rt{i}"] = _call(
            12 if spd == 2 else 8, agg=agg, spd=spd, ckpt=ck(f"rt{i}"),
            ckpt_every=ce, res=ResilienceConfig(
                elastic=True, mirror_every=me,
                faults=f"device_loss@2,device_return@{ret}"))
    # The fresh runs restored from each recovery point.
    names = list(calls)
    cmp = {"cmp_m": ("shrink_m", 0, 3, dict(iters=8)),
           "cmp_c": ("shrink_c", 0, 3, dict(iters=8)),
           "cmp_int8": ("int8", 1, 4, dict(iters=8, spd=1, wire="int8_ef",
                                           ovl=2)),
           "cmp_int8_b5": ("int8_b5", 1, 4, dict(iters=8, spd=1,
                                                 wire="int8_ef", ovl=2,
                                                 cb=5))}
    for i, (agg, spd, *_rest) in enumerate(ROUND_TRIPS):
        cmp[f"cmp_rt{i}"] = (f"rt{i}", 1, 4, dict(
            iters=12 if spd == 2 else 8, agg=agg, spd=spd))
    for name, (src, ri, world, kw) in cmp.items():
        iters = kw.pop("iters")
        calls[name] = _call(iters, ckpt=ck(name), world=world,
                            prune=(calls[src]["kwargs"]["checkpoint_dir"],
                                   ck(name), names.index(src), ri),
                            **kw)
        names.append(name)
    results = distributed.run_ranks(programs.elastic_calls, 4,
                                    list(calls.values()), device="cpu",
                                    timeout=600)
    tel.close()
    out = {name: [r[i] for r in results] for i, name in enumerate(calls)}
    out["tel"] = str(d / "tel")
    return out


# ------------------------------------------------------ pure functions

def _jax_ids(m, devices):
    return [devices.index(d) for d in m.devices.flatten()]


def test_survivor_submesh_and_rejoin_mesh_name_jax_ranks(devices):
    pool = list(range(4))
    for lost in ([1], [0], [0, 3], [2, 3]):
        j = jmesh.survivor_submesh(make_mesh({"data": 4},
                                             devices=devices[:4]), lost)
        p = mesh.survivor_submesh(mesh.data_mesh(pool), lost)
        assert list(p.members) == _jax_ids(j, devices)
        back = [pool[i] for i in lost]
        jb = jmesh.rejoin_mesh(j, [devices[i] for i in back],
                               pool=devices[:4])
        pb = mesh.rejoin_mesh(p, back, pool=pool)
        assert list(pb.members) == _jax_ids(jb, devices) == pool
        tail = mesh.rejoin_mesh(p, back)
        assert list(tail.members) == _jax_ids(jmesh.rejoin_mesh(
            j, [devices[i] for i in back]), devices)


@pytest.mark.parametrize("case", ["none", "range", "3-axis", "axis",
                                  "present", "dup", "pool", "empty"])
def test_mesh_refusals_have_jax_texts(devices, case):
    pm = mesh.data_mesh(range(4))
    jm = make_mesh({"data": 4}, devices=devices[:4])
    sub, jsub = mesh.survivor_submesh(pm, [1]), jmesh.survivor_submesh(
        jm, [1])
    calls = {
        "none": (lambda: mesh.survivor_submesh(pm, [0, 1, 2, 3]),
                 lambda: jmesh.survivor_submesh(jm, [0, 1, 2, 3])),
        "range": (lambda: mesh.survivor_submesh(pm, [7]),
                  lambda: jmesh.survivor_submesh(jm, [7])),
        "3-axis": (lambda: mesh.survivor_submesh(mesh.PoolMesh(
            np.arange(8).reshape(2, 2, 2), ("data", "stage", "model")), [0]),
            lambda: jmesh.survivor_submesh(make_mesh(
                {"data": 2, "stage": 2, "model": 2}, devices=devices[:8]),
                [0])),
        "axis": (lambda: mesh.rejoin_mesh(mesh.PoolMesh(
            np.arange(4).reshape(2, 2), ("data", "seq")), [5]),
            lambda: jmesh.rejoin_mesh(make_mesh(
                {"data": 2, "seq": 2}, devices=devices[:4]), [devices[5]])),
        "present": (lambda: mesh.rejoin_mesh(sub, [0], pool=range(4)),
                    lambda: jmesh.rejoin_mesh(jsub, [devices[0]],
                                              pool=devices[:4])),
        "dup": (lambda: mesh.rejoin_mesh(sub, [1, 1], pool=range(4)),
                lambda: jmesh.rejoin_mesh(jsub, [devices[1]] * 2,
                                          pool=devices[:4])),
        "pool": (lambda: mesh.rejoin_mesh(sub, [7], pool=range(4)),
                 lambda: jmesh.rejoin_mesh(jsub, [devices[7]],
                                           pool=devices[:4])),
        "empty": (lambda: mesh.rejoin_mesh(sub, [], pool=range(4)),
                  lambda: jmesh.rejoin_mesh(jsub, [], pool=devices[:4])),
    }
    port, ref = calls[case]
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    # JAX names its devices where the port names pool ranks.
    assert str(got.value) == re.sub(r"TFRT_CPU_(\d+)|CpuDevice\(id=(\d+)\)",
                                    lambda m: m.group(1) or m.group(2),
                                    str(want.value))


@pytest.mark.parametrize("axis", ["stage", "model"])
@pytest.mark.parametrize("fn", ["survivor_submesh", "rejoin_mesh"])
def test_stage_and_model_re_mesh_wait_for_their_trainers(devices, axis, fn):
    """A real stage or model axis re-meshes by JAX's 2-axis rules (the
    elastic PP and TP trainers): a data-row drop keeps the other rows in
    order, a rejoin with the pool rebuilds the original grid; a size-1
    axis re-meshes as JAX's does."""
    for d, s in ((2, 2), (3, 1)):
        grid = mesh.PoolMesh(np.arange(d * s).reshape(d, s), ("data", axis))
        jgrid = make_mesh({"data": d, axis: s}, devices=devices[:d * s])
        p = mesh.survivor_submesh(grid, [d * s - 1], layer_divisor=4)
        j = jmesh.survivor_submesh(jgrid, [d * s - 1], layer_divisor=4)
        if fn == "rejoin_mesh":
            back = [r for r in range(d * s) if r not in p.members]
            p = mesh.rejoin_mesh(p, back, pool=list(range(d * s)),
                                 pool_shape=(d, s), layer_divisor=4)
            j = jmesh.rejoin_mesh(j, [devices[i] for i in back],
                                  pool=devices[:d * s], pool_shape=(d, s),
                                  layer_divisor=4)
        assert list(p.members) == _jax_ids(j, devices)
        assert p.shape == dict(j.shape) and p.axis_names == j.axis_names


def test_victims_and_arrivals_are_jax_choices():
    for seed in range(3):
        for step in range(6):
            for count in (1, 2, 3):
                assert ReplicaLossError(step, count, seed).victims(4) == \
                    JaxLoss(step, count, seed=seed).victims(4)
                for absent in ([1], [0, 3], [0, 2, 3]):
                    assert ReplicaReturnSignal(step, count, seed).arrivals(
                        absent) == JaxReturn(step, count,
                                             seed=seed).arrivals(absent)


def test_resize_ring_residual_matches_jax():
    h = np.arange(1, 33, dtype=np.float32).reshape(4, 8)
    for r in range(4):
        h[r, r * 2:(r + 1) * 2] = 0.0
    for shape in ((3, 9), (4, 8), (2, 8), (5, 10)):
        np.testing.assert_array_equal(dp._resize_ring_residual(h, shape),
                                      jdp._resize_ring_residual(h, shape))
    grown = dp._resize_ring_residual(h, (3, 9))
    np.testing.assert_array_equal(dp._resize_ring_residual(grown, (4, 8)),
                                  jdp._resize_ring_residual(grown, (4, 8)))
    for bad, shape in ((np.ones((2, 8), np.float32), (2, 6)), (h, (3, 8))):
        with pytest.raises(ValueError) as want:
            jdp._resize_ring_residual(bad, shape)
        with pytest.raises(ValueError) as got:
            dp._resize_ring_residual(bad, shape)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jllama.init_llama(jax.random.key(0), JaxLlamaConfig(**TINY))


def _jax_loss(p, batch):
    return jcausal_lm_loss(jllama.forward(p, batch, JaxLlamaConfig(**TINY)),
                           batch)


def _as_world(monkeypatch, n, r):
    monkeypatch.setattr(distributed, "world_size", lambda: n)
    monkeypatch.setattr(distributed, "get_rank", lambda: r)


def _port_host(template4, jax_host):
    """The port's host snapshot of a JAX snapshot: the port state's
    structure (taken at the snapshot's world), JAX's arrays in leaf
    order."""
    leaves = nested_leaves(template4)
    arrays = iter(np.asarray(x) for x in jax.tree.leaves(jax_host))
    filled = [next(arrays) if isinstance(x, torch.Tensor) else x
              for x in leaves]
    assert next(arrays, None) is None
    return nested_unflatten(template4, filled)


def _port_params():
    from ddl25spring_tpu_torch.convert import params_from_jax
    return params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                           LlamaConfig(**TINY), device="cpu").tree()


def test_reshard_zero1_moments_across_worlds_matches_jax(devices,
                                                         monkeypatch):
    mesh4 = make_mesh({"data": 4}, devices=devices[:4])
    state4, step4 = jdp.make_zero1_step(_jax_loss, optax.adam(1e-3), mesh4,
                                        _jax_params())
    batch = jax.random.randint(jax.random.key(1), (8, 16), 0, 259)
    for _ in range(2):
        state4, _ = step4(state4, jdp.shard_batch(mesh4, batch))
    host = jdp.host_snapshot(state4)
    for n in (3, 2, 4):
        m = make_mesh({"data": n}, devices=devices[:n])
        jt, _ = jdp.make_zero1_step(_jax_loss, optax.adam(1e-3), m,
                                    _jax_params())
        want = [np.asarray(x) for x in jax.tree.leaves(
            jdp.reshard_state(host, jt))]
        _as_world(monkeypatch, 4, 0)
        t4, _ = dp.make_zero1_step(llama_loss, fused_adam(1e-3),
                                   _port_params())
        phost = _port_host(t4, host)
        for r in range(n):
            _as_world(monkeypatch, n, r)
            t, _ = dp.make_zero1_step(llama_loss, fused_adam(1e-3),
                                      _port_params())
            got = [x.detach().numpy() for x in nested_leaves(
                dp.reshard_state(phost, t)) if isinstance(x, torch.Tensor)]
            local = t.zero1.local
            for g, w in zip(got, want):
                if w.ndim == 1 and w.shape[0] == n * local:   # a slice
                    w = w[r * local:(r + 1) * local]
                np.testing.assert_array_equal(g, w)


def llama_loss(p, batch):
    return llama.forward_loss(p, batch, LlamaConfig(**TINY))


def test_reshard_bucketed_residual_tuples_matches_jax(devices, monkeypatch):
    def jbuild(n, buckets):
        m = make_mesh({"data": n}, devices=devices[:n])
        st, step = jcompress.make_overlap_step(
            _jax_loss, optax.adam(1e-3), m, _jax_params(), microbatches=2,
            wire="int8_ef", aggregation="gradient", comm_buckets=buckets)
        return m, st, step

    def pbuild(n, r, buckets):
        _as_world(monkeypatch, n, r)
        return compress.make_overlap_step(
            llama_loss, fused_adam(1e-3), _port_params(), microbatches=2,
            wire="int8_ef", aggregation="gradient", comm_buckets=buckets,
            device="cpu")[0]

    mesh4, s4, step4 = jbuild(4, 5)
    batch = jax.random.randint(jax.random.key(1), (8, 16), 0, 259)
    for _ in range(2):
        s4, _ = step4(s4, jdp.shard_batch(mesh4, batch))
    host = jdp.host_snapshot(s4)
    assert any(np.asarray(x).any() for x in host.ring_residual)
    phost = _port_host(pbuild(4, 0, 5), host)
    _, jt2, _ = jbuild(2, 5)
    want = jdp.reshard_state(host, jt2)
    for r in range(2):
        got = dp.reshard_state(phost, pbuild(2, r, 5))
        for g, w in zip(got.ring_residual, want.ring_residual):
            np.testing.assert_array_equal(g.detach().numpy()[0],
                                          np.asarray(w)[r])
        for g, w in zip(got.gather_residual, want.gather_residual):
            sz = g.shape[0]
            np.testing.assert_array_equal(
                g.detach().numpy(), np.asarray(w)[r * sz:(r + 1) * sz])
    # JAX's two refusals, by their texts.
    _, jt1, _ = jbuild(2, 1)
    with pytest.raises(ValueError) as want_e:
        jdp.reshard_state(host, jt1)
    with pytest.raises(ValueError) as got_e:
        dp.reshard_state(phost, pbuild(2, 0, 1))
    assert str(got_e.value) == str(want_e.value)
    mesh4b, s4b, step4b = jbuild(4, 2)
    s4b, _ = step4b(s4b, jdp.shard_batch(mesh4b, batch))
    hostb = jdp.host_snapshot(s4b)
    _, jt2b, _ = jbuild(2, 2)
    with pytest.raises(ValueError) as want_e:
        jdp.reshard_state(hostb, jt2b)
    phostb = _port_host(pbuild(4, 0, 2), hostb)
    with pytest.raises(ValueError) as got_e:
        dp.reshard_state(phostb, pbuild(2, 0, 2))
    assert str(got_e.value) == str(want_e.value)
    assert "indivisible bucket×shard factorization" in str(got_e.value)


@pytest.mark.parametrize("params", ["model", "scalar"])
def test_legacy_int8_residuals_refuse_another_world(monkeypatch, params):
    """The legacy int8 step's residual tree is no leaf the cross-world
    rule covers: its snapshot at world 4 placed at world 3 raises, a 1-D
    stack (``scalar``: a scalar parameter's ``[1]`` slots) included."""
    _as_world(monkeypatch, 3, 0)
    tree = (_port_params() if params == "model"
            else {"s": torch.tensor(0.5), "w": torch.ones(3)})
    t = compress.init_ef_state(tree, fused_adam(1e-3))
    host = nested_unflatten(t, [
        torch.cat([x] * 4) if s else x
        for x, s in zip(nested_leaves(t), dp._slice_mask(t))])
    with pytest.raises(ValueError, match="only the ZeRO-1 moment slices "
                       "and the ring step's error-feedback residuals"):
        dp.reshard_state(host, t)


def _ring_zero1(monkeypatch, n, r):
    _as_world(monkeypatch, n, r)
    return compress.make_overlap_step(
        llama_loss, fused_adam(1e-3), _port_params(), microbatches=2,
        wire="int8_ef", aggregation="zero1", device="cpu")[0]


@pytest.mark.parametrize("fault", ["none", "ring_row", "own_chunk",
                                   "moment", "param"])
def test_reshard_audit_catches_a_misplaced_coordinate(monkeypatch, fault):
    """``programs.reshard_differences``, phase 18's check of every
    re-mesh on the card: the int8 ring's ZeRO-1 state at world 4, random
    in every per-rank block, resharded to world 3 by ``reshard_state`` and
    stacked as ``host_snapshot`` stacks it, departs from its mirror
    nowhere; one misplaced coordinate is found."""
    t4 = _ring_zero1(monkeypatch, 4, 0)
    n_real = sum(x.numel() for x in nested_leaves(t4.params))
    rng = np.random.default_rng(0)
    pre = nested_unflatten(t4, [
        torch.from_numpy(rng.standard_normal(g).astype(np.float32))
        if s else x for x, g, s in zip(nested_leaves(t4),
                                       dp.global_shapes(t4),
                                       dp._slice_mask(t4))])
    flat = [x for x in nested_leaves(pre.opt_state) if x.dim() == 1]
    for x in flat + [pre.gather_residual]:
        x[n_real:] = 0
    ring = pre.ring_residual
    local4 = ring.shape[1] // 4
    ring[:, n_real:] = 0
    for r in range(4):
        ring[r, r * local4:(r + 1) * local4] = 0
    parts = [dp.reshard_state(pre, _ring_zero1(monkeypatch, 3, r))
             for r in range(3)]
    post = nested_unflatten(parts[0], [
        torch.cat(xs) if s else xs[0] for xs, s in zip(
            zip(*(nested_leaves(p) for p in parts)),
            dp._slice_mask(parts[0]))])
    assert post.ring_residual.shape[0] == 3
    local3 = post.ring_residual.shape[1] // 3
    if fault == "ring_row":
        post.ring_residual[[0, 2]] = post.ring_residual[[2, 0]].clone()
    elif fault == "own_chunk":
        post.ring_residual[1, local3] = 1.0
    elif fault == "moment":
        mu = [x for x in nested_leaves(post.opt_state) if x.dim() == 1][0]
        mu[:n_real] = torch.roll(mu[:n_real], 1)
    elif fault == "param":
        with torch.no_grad():
            w = nested_leaves(post.params)[0].view(-1)
            w[0] = torch.nextafter(w[0], torch.tensor(np.inf))
    found = programs.reshard_differences(pre, post)
    if fault == "none":
        assert found == []
    else:
        assert len(found) == 1 and found[0].startswith(
            {"ring_row": "ring_residual", "own_chunk": "ring_residual",
             "moment": "opt_state", "param": "params"}[fault]), found


def test_remesh_record_has_jax_keys():
    from ddl25spring_tpu.resilience.elastic import (
        RemeshRecord as JaxRemeshRecord)
    args = dict(detected_at=6, resume_step=6, dispatch=3, old_world=4,
                new_world=3, lost=[1])
    assert RemeshRecord(**args).as_dict() == JaxRemeshRecord(
        **args).as_dict()


# ------------------------------------------------------------ the trainer

def _same(ranks):
    """Every rank of the pool returns the final world's report."""
    def plan(r):
        return [{k: v for k, v in x.items() if k != "seconds"}
                for x in r["remeshes"]]

    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert plan(r) == plan(ranks[0])
    return ranks[0]


@pytest.mark.parametrize("ref,got", [("ref_z", "el_z"), ("ref_g", "el_g")])
def test_no_fault_elastic_is_bitwise_non_elastic(runs, ref, got):
    for a, b in zip(runs[ref], runs[got]):
        assert len(b["losses"]) == 6 and b["losses"] == a["losses"]
        assert b["remeshes"] == [] and b["resilience"]["remeshes"] == 0


@pytest.mark.parametrize("name,path,replay", [("m", "mirror", 0),
                                              ("c", "checkpoint", 2)])
def test_shrink_4_to_3_is_bitwise_a_fresh_3_rank_run(runs, name, path,
                                                     replay):
    el = _same(runs[f"shrink_{name}"])
    assert len(el["remeshes"]) == 1 and el["resilience"]["remeshes"] == 1
    rec = el["remeshes"][0]
    assert (rec["old_world"], rec["new_world"], rec["lost"]) == (4, 3, [1])
    assert rec["detected_at"] == 6 and rec["path"] == path
    assert rec["steps_replayed"] == replay
    assert rec["resume_step"] == 6 - replay and rec["seconds"] > 0
    assert len(el["losses"]) == 8 and np.isfinite(el["losses"]).all()
    m = rec["resume_step"]
    ref = runs[f"cmp_{name}"][0]
    assert ref["start_step"] == m
    assert el["losses"][m:] == ref["losses"]


def test_two_losses_4_to_3_to_2_lose_the_writer(runs):
    got = _same(runs["two"])
    assert [(r["old_world"], r["new_world"]) for r in got["remeshes"]] == \
        [(4, 3), (3, 2)]
    # The second loss takes index 0 of the 3-rank world: pool rank 0.
    assert [r["lost"] for r in got["remeshes"]] == [[1], [0]]
    assert len(got["losses"]) == 10 and np.isfinite(got["losses"]).all()
    assert got["resilience"]["remeshes"] == 2 and got["steps"] == 10


def test_the_lost_writer_returns_with_the_runs_record(runs):
    got = runs["back"]
    for r in got:       # the full world again: each rank's own report
        assert [(x["old_world"], x["new_world"], x["lost"], x["returned"])
                for x in r["remeshes"]] == [(4, 3, [1], []),
                                            (3, 2, [0], []),
                                            (2, 4, [], [0, 1])]
        assert r["losses"] == got[2]["losses"] and r["steps"] == 12
        assert r["resilience"]["remeshes"] == 3
    assert len(got[0]["losses"]) == 12 and np.isfinite(
        got[0]["losses"]).all()


@pytest.mark.parametrize("i", range(len(ROUND_TRIPS)))
def test_round_trip_4_3_4_is_bitwise_a_fresh_4_rank_run(runs, i):
    agg, spd, me, ce, path, ret, replay = ROUND_TRIPS[i]
    el = _same(runs[f"rt{i}"])
    assert [(r["old_world"], r["new_world"]) for r in el["remeshes"]] == \
        [(4, 3), (3, 4)]
    shrink, grow = el["remeshes"]
    assert [r["direction"] for r in el["remeshes"]] == ["shrink", "grow"]
    assert grow["returned"] == shrink["lost"]
    assert grow["path"] == path and grow["steps_replayed"] == replay
    assert grow["resume_step"] == grow["detected_at"] - replay
    iters = 12 if spd == 2 else 8
    assert len(el["losses"]) == iters and np.isfinite(el["losses"]).all()
    ref = runs[f"cmp_rt{i}"][0]
    assert ref["start_step"] == grow["resume_step"]
    assert el["losses"][grow["resume_step"]:] == ref["losses"]


@pytest.mark.parametrize("name,worlds", [
    ("int8", [(4, 3), (3, 4)]), ("int8_b5", [(4, 2), (2, 4)])])
def test_int8_ring_round_trip_is_bitwise(runs, name, worlds):
    el = _same(runs[name])
    assert [(r["old_world"], r["new_world"]) for r in el["remeshes"]] == \
        worlds
    assert el["remeshes"][1]["returned"] == el["remeshes"][0]["lost"]
    assert len(el["losses"]) == 8 and np.isfinite(el["losses"]).all()
    m = el["remeshes"][1]["resume_step"]
    ref = runs[f"cmp_{name}"][0]
    assert ref["start_step"] == m and el["losses"][m:] == ref["losses"]


def test_device_loss_without_elastic_is_fatal(runs):
    for r in runs["no_elastic"]:
        assert r["error"][0] == "ReplicaLossError"


def test_loss_at_a_world_of_one_is_fatal():
    with pytest.raises(ReplicaLossError):
        llm.train_llm_dp(
            LlamaConfig(**TINY), TrainConfig(**BASE, iters=4, data=1),
            tokenizer=ByteTokenizer(), log_every=0, device="cpu",
            resilience=ResilienceConfig(elastic=True,
                                        faults="device_loss@0"))


def test_stream_across_the_writers_loss(runs):
    got = _same(runs["observed"])
    events = read_events(os.path.join(runs["tel"], "events.jsonl"),
                         strict=True)
    seqs = [e["seq"] for e in events]
    assert seqs == list(range(1, len(seqs) + 1))   # one writer at a time
    remesh = [e for e in events if e["type"] == "remesh"]
    assert [(e["old_world"], e["new_world"]) for e in remesh] == \
        [(4, 3), (3, 2)]
    jax_keys = {"old_world", "new_world", "lost", "path", "it",
                "detected_at", "seconds", "steps_replayed", "direction",
                "returned", "axis", "old_shape", "new_shape"}
    for e in remesh:
        assert validate_event(e) == []
        assert jax_keys <= set(e) and e["steps_replayed"] == 0
    run_end = [e for e in events if e["type"] == "run_end"]
    assert len(run_end) == 1 and run_end[0]["remeshes"] == 2
    assert got["post_remesh_tokens_per_sec"] > 0
    spans = [e for e in events if e["type"] == "span"]
    roots = [s for s in spans if s["name"] == "remesh"]
    assert len(roots) == 2
    for root in roots:
        kids = {s["name"] for s in spans
                if s.get("parent_span_id") == root["span_id"]}
        assert kids == {"drain", "rebuild", "restore", "replay"}
    steps = [e for e in events if e["type"] == "step"]
    assert steps and all(validate_event(e) == [] for e in steps)


def _jax_train(monkeypatch, devices, faults, iters, spd=2):
    tree = params_to_numpy(llama.init_llama(
        LlamaConfig(**TINY), torch.Generator().manual_seed(0), device="cpu"))
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    return jllm.train_llm_dp(
        JaxLlamaConfig(**TINY),
        JaxTrainConfig(**BASE, iters=iters, data=4, steps_per_dispatch=spd),
        mesh=make_mesh({"data": 4}, devices=devices[:4]),
        tokenizer=JaxByteTokenizer(), aggregation="zero1", log_every=0,
        resilience=JaxResilienceConfig(elastic=True, faults=faults))


@pytest.mark.parametrize("name,faults,iters", [
    ("two", "device_loss@1,device_loss@3", 10),
    ("rt0", "device_loss@2,device_return@5", 12),
    ("back", BACK, 12)])
def test_losses_match_jax_under_the_same_fault_plan(runs, monkeypatch,
                                                    devices, name, faults,
                                                    iters):
    want = _jax_train(monkeypatch, devices, faults, iters)
    got = _same(runs[name])
    assert [(r["old_world"], r["new_world"], r["lost"], r["returned"])
            for r in got["remeshes"]] == [
        (r["old_world"], r["new_world"], r["lost"], r["returned"])
        for r in want.remeshes]
    np.testing.assert_allclose(got["losses"], want.losses, atol=1e-5)


REFUSALS = [
    ("weight", {}, ResilienceConfig(elastic=True), None),
    ("gradient", dict(wire="int8_ef"), ResilienceConfig(elastic=True), None),
    ("gradient", dict(wire="bf16"), ResilienceConfig(elastic=True), None),
    ("gradient", {}, ResilienceConfig(elastic=True, guard=False,
                                      injit_guard=True), None),
    ("gradient", {}, ResilienceConfig(), "hook"),
    ("gradient", {}, None, "hook"),
    ("gradient", dict(numerics_every=2), ResilienceConfig(elastic=True),
     None),
]


@pytest.mark.parametrize("agg,extra,res,hook", REFUSALS)
def test_refuses_what_jax_refuses(devices, agg, extra, res, hook):
    hook = (lambda it, world: None) if hook else None
    with pytest.raises(ValueError) as want:
        jllm.train_llm_dp(
            JaxLlamaConfig(**TINY), JaxTrainConfig(**BASE, iters=1, data=2,
                                                   **extra),
            mesh=make_mesh({"data": 2}, devices=devices[:2]),
            tokenizer=JaxByteTokenizer(), aggregation=agg, log_every=0,
            resilience=(None if res is None else JaxResilienceConfig(
                elastic=res.elastic, guard=res.guard,
                injit_guard=res.injit_guard)), scale_hook=hook)
    with pytest.raises(ValueError) as got:
        llm.train_llm_dp(LlamaConfig(**TINY), TrainConfig(
            **BASE, iters=1, data=2, **extra), tokenizer=ByteTokenizer(),
            aggregation=agg, log_every=0, resilience=res, scale_hook=hook,
            device="cpu")
    text = str(want.value).replace("in-jit guard", "in-step guard")
    assert str(got.value) == text


def test_elastic_refuses_a_hierarchical_mesh_with_jax_text(devices):
    from ddl25spring_tpu.parallel.distributed import hier_data_mesh
    kw = dict(iters=1, data=2, dcn=2, overlap_microbatches=1)
    with pytest.raises(ValueError) as want:
        jllm.train_llm_dp(
            JaxLlamaConfig(**TINY), JaxTrainConfig(**BASE, **kw),
            mesh=hier_data_mesh(2, 2), tokenizer=JaxByteTokenizer(),
            log_every=0, resilience=JaxResilienceConfig(elastic=True))
    with pytest.raises(ValueError) as got:
        llm.train_llm_dp(LlamaConfig(**TINY), TrainConfig(**BASE, **kw),
                         tokenizer=ByteTokenizer(), log_every=0,
                         resilience=EL, device="cpu")
    assert str(got.value) == str(want.value)


def test_controller_refuses_a_grow_with_nothing_absent():
    ctl = ElasticController(mesh.data_mesh([0]), build=None, rewrap=None,
                            make_batches=None)
    with pytest.raises(RuntimeError, match="no capacity is absent"):
        ctl.grow(ReplicaReturnSignal(3), failed_at=3, dispatch=3)
    assert ctl.resize(1, state=None, at_step=2, dispatch=1) is None
    with pytest.raises(ValueError, match="exceeds the run's device pool"):
        ctl.resize(2, state=dp.init_state(
            {"w": torch.zeros(2)}, fused_adam(1e-3)), at_step=2,
            dispatch=1)
