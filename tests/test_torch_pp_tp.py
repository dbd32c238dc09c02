"""The port's DP×PP×TP composition (``parallel/pp.py`` on a ``(data, stage,
model)`` mesh: Megatron tensor parallelism inside each pipeline stage)
against the JAX package's on the CPU mesh, at ``tests/test_pp.py``'s sizes:
vocab 64, dmodel 16, 2 heads, 4 layers, ctx 8, a global batch of 8 × 8;
weights through ``convert.params_from_jax``, batches from a numpy seed.

One launch of eight ranks (``pipeline_mesh(2, 2, 2)``; ``programs.
sequence``) runs every step case: the 2 × 2 × 2 grid, each data row on its
own as a 1 × 2 × 2 mesh (``view="row"``), each model shard's ranks on their
own as a 2 × 2 mesh without a model axis (``view="column"``), and the
2 × 2 × 2 trainer calls. ``train_llm_pp(mesh={"data": 1, "stage": 2,
"model": 2})`` starts its own four ranks. Held:

- GPipe, 1F1B and interleaved at M ∈ {2, 4} on 2 × 2 × 2, GPipe and 1F1B
  at M = 2 on 1 × 2 × 2: loss within 1e-5 of JAX's ``make_pipeline_step``
  on the same mesh, every gradient leaf within 1e-4 of its largest entry
  (SGD at lr 1024: update / lr is the gradient, JAX's
  ``test_dp_pp_tp_matches_single_device``);
- each rank's initial ``wq`` and ``wo`` slices bitwise JAX's shards;
- 1F1B under ``remat=True`` bitwise the plain 1F1B step;
- the fp32 ring (gradient, ZeRO-1) within 1e-5 / 1e-4 of JAX's
  ``make_pipeline_overlap_step``, bf16 and int8_ef within 1e-3 / 2e-3;
- each (stage, model) cell's int8 ring, every call, bitwise
  ``ring_spec.agreed_rings`` over the cells of its stage (the int8 scales
  are agreed over the model group);
- ``make_pipeline_overlap_multi_step`` at K = 4 bitwise four per-step
  calls (JAX's ``test_pp_tp_composed_overlap_zero1_int8_scans_bitwise``);
- replicas bitwise under the int8 legs at model 1 and 2: data rows, and
  the model shards' copies of every replicated leaf (JAX's
  ``test_pp_tp_composed_replicas_bitwise_in_sync``);
- per-label communication bytes against the relation between the JAX
  program's static profile and what the cells send;
- the named refusals: ``make_pp_numerics``, ``repartition_stage_state``
  and ``train_llm_pp``'s numerics and elastic modes on a model axis;
- ``train_llm_pp(mesh=...)``: 1 × 2 × 2 plain and 2 × 2 × 2 K-step within
  1e-5 of JAX's losses, the 2 × 2 × 2 int8_ef ZeRO-1 ring within 1e-3;
- a checkpoint of a 3-axis state holds the whole model in the JAX layout,
  and an int8_ef ZeRO-1 run preempted and resumed from its checkpoint is
  bitwise the uninterrupted run;
- ``bench_utils.time_pp_train_step`` runs on the 3-axis mesh (plain and
  the int8_ef ZeRO-1 ring) and gives a finite rate."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel import mesh as jmesh_mod
from ddl25spring_tpu.parallel import pp as jpp
from ddl25spring_tpu.telemetry.comm import measure_comm as jmeasure_comm
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.checkpoint import Checkpointer
from ddl25spring_tpu_torch.config import (LlamaConfig, ResilienceConfig,
                                          TrainConfig)
from ddl25spring_tpu_torch.convert import params_from_jax, params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import (distributed, dp, pp, programs,
                                            ring_spec)
from ddl25spring_tpu_torch.parallel.mesh import PoolMesh, survivor_submesh
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm

torch.set_num_threads(1)

CFG = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=4, ctx_size=8)
GRID = (2, 2, 2)
MESH3 = {"data": 2, "stage": 2, "model": 2}
ROW3 = {"data": 1, "stage": 2, "model": 2}
LR = 1024.0
V = 2                                      # chunks per stage, interleaved
STEPS = [(s, m) for s in ("gpipe", "1f1b", "interleaved") for m in (2, 4)]
ROW_STEPS = [("gpipe", 2), ("1f1b", 2)]
RELAXED = [(w, a) for w in ("bf16", "int8_ef") for a in ("gradient", "zero1")]
LR_RELAXED = 0.02
COL, ROW = {"wq", "wk", "wv", "w_gate", "w_up"}, {"wo", "w_down"}
# The trainer calls: tests/test_torch_pp_overlap.py's configs on a model
# axis.
TR_CFG = dict(dmodel=16, num_heads=2, n_layers=4, ctx_size=16)
TR_BASE = dict(batch_size=4, seq_len=16, lr=3e-3, iters=4, stage=2,
               microbatches=2, data=2, optimizer="fused")
# The int8_ef ZeRO-1 trainer route runs 3 steps, the JAX reference run's
# length: its chunk boundaries differ from JAX's (a port stage rings only
# its own leaves), so the two int8 trajectories part under Adam at a rate
# set by the quantization noise (1.05e-3 at a fourth step).
RING_ITERS = 3
EF_CFG = dict(dmodel=16, num_heads=2, n_layers=2, ctx_size=16)
EF_BASE = dict(batch_size=2, seq_len=16, lr=3e-3, stage=2, microbatches=2,
               data=2, wire="int8_ef", overlap_microbatches=1,
               steps_per_dispatch=2, optimizer="fused")


def _tree():
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.key(0), JaxLlamaConfig(**CFG)))


def _batches(n, seed):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (n, 8, CFG["ctx_size"])).astype(np.int32)


def _step_cases(directory):
    base = dict(cfg=CFG, params=_tree(), data=2, stage=2, model=2,
                batches=_batches(1, 1), merged=True)
    cases = {("grid", s, m): dict(base, schedule=s, microbatches=m,
                                  init=(s, m) == ("gpipe", 2))
             for s, m in STEPS}
    for s, m in ROW_STEPS:
        cases[("row", s, m)] = dict(base, view="row", grid=GRID, data=1,
                                    schedule=s, microbatches=m)
    cases[("remat",)] = dict(base, cfg=dict(CFG, remat=True),
                             schedule="1f1b", microbatches=2)
    cases[("ckpt",)] = dict(base, schedule="gpipe", microbatches=2,
                            optimizer="fused", lr=1e-3,
                            checkpoint=str(directory / "layout"))
    return cases


def _ring(agg, wire, steps=2, lr=1.0, seed=2, **kw):
    return dict(cfg=CFG, params=_tree(), data=2, stage=2, model=2,
                microbatches=2, aggregation=agg, wire=wire, overlap=1,
                batches=list(_batches(steps, seed)), lr=lr, **kw)


def _ring_cases():
    cases = {f"fp32-{a}": _ring(a, "fp32") for a in ("gradient", "zero1")}
    cases.update({f"{w}-{a}": _ring(a, w, steps=4, lr=LR_RELAXED,
                                     spy=w == "int8_ef")
                  for w, a in RELAXED})
    adam = dict(optimizer="fused", lr=1e-3)
    cases["k1"] = _ring("zero1", "int8_ef", steps=4, snapshot=True, **adam)
    cases["k4"] = dict(_ring("zero1", "int8_ef", **adam), window=True,
                       batches=[_batches(4, 2)], snapshot=True)
    cases["rep-m2"] = _ring("zero1", "int8_ef", steps=3, seed=5, **adam)
    cases["rep-m1"] = dict(_ring("zero1", "int8_ef", steps=3, seed=5,
                                 **adam), view="column", grid=GRID)
    return cases


def _trainer_calls(directory):
    ck = str(directory / "ef")
    ef = {"aggregation": "zero1", "mesh": MESH3}
    return {"spd2": (TR_CFG, dict(TR_BASE, steps_per_dispatch=2),
                     {"mesh": MESH3}),
            "ring-int8": (TR_CFG, dict(TR_BASE, overlap_microbatches=1,
                                       wire="int8_ef", iters=RING_ITERS),
                          {"mesh": MESH3, "aggregation": "zero1"}),
            "ef-ref": (EF_CFG, dict(EF_BASE, iters=6), ef),
            "ef-a": (EF_CFG, dict(EF_BASE, iters=4),
                     dict(ef, checkpoint_dir=ck, checkpoint_every=100)),
            "ef-b": (EF_CFG, dict(EF_BASE, iters=6),
                     dict(ef, checkpoint_dir=ck, checkpoint_every=100))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("pp_tp")
    steps, rings = _step_cases(directory), _ring_cases()
    calls = _trainer_calls(directory)
    ranks = distributed.run_ranks(
        programs.sequence, 8,
        [("pp_cases", (list(steps.values()),)),
         ("pp_overlap_cases", (list(rings.values()),)),
         ("pp_trainer_calls", (list(calls.values()),)),
         ("pp_bench_calls", (BENCH,))],
        device="cpu", timeout=600)
    out = {key: [r[0][i] for r in ranks] for i, key in enumerate(steps)}
    out.update({name: [r[1][i] for r in ranks]
                for i, name in enumerate(rings)})
    out.update({name: [r[2][i] for r in ranks]
                for i, name in enumerate(calls)})
    out["bench"] = [r[3] for r in ranks]
    out["directory"] = directory
    return out


# bench_utils.time_pp_train_step on 2 × 2 × 2: the plain step and the
# int8_ef ZeRO-1 ring, 1 warmup and 2 timed steps at B=4 per row.
BENCH = [(GRID, dict(CFG, attention_impl="xla"), 4,
          dict(n_microbatches=2, warmup=1, timed_steps=2)),
         (GRID, dict(CFG, attention_impl="xla"), 4,
          dict(n_microbatches=2, warmup=1, timed_steps=2, wire="int8_ef",
               aggregation="zero1", overlap_microbatches=1))]


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return make_mesh(shape, devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_step(view, schedule, m):
    """JAX's pipeline step (SGD at ``LR``) on the 2 × 2 × 2 or 1 × 2 × 2
    mesh over the first batch: ``(params before, params after, loss, wq
    and wo shards before the step by device index)``."""
    mesh = _jax_mesh(MESH3 if view == "grid" else ROW3)
    params = jax.tree.map(jnp.asarray, _tree())
    if schedule == "interleaved":
        params = jpp.interleave_params(params, 2, V)
    before = jax.tree.map(np.asarray, params)
    opt = optax.sgd(LR)
    state = jpp.init_state(mesh, params, opt)
    devices = jax.devices()
    shards = {name: {devices.index(sh.device): np.asarray(sh.data)
                     for sh in state.params["blocks"][name].addressable_shards}
              for name in ("wq", "wo")}
    step = jpp.make_pipeline_step(JaxLlamaConfig(**CFG), opt, mesh, m,
                                  schedule, n_chunks=V)
    state, loss = step(state, jpp.shard_batch(mesh,
                                              jnp.asarray(_batches(1, 1)[0])))
    return before, jax.tree.map(np.asarray, state.params), float(loss), shards


def _grads(before, after):
    return jax.tree.map(lambda a, b: (np.asarray(a, np.float64)
                                      - np.asarray(b, np.float64)) / LR,
                        before, after)


def _leaf_errs(want, got):
    """Per leaf: max |difference| over the leaf's max |value| (0 where
    both are 0)."""
    out = []
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        diff = float(np.abs(np.asarray(w, np.float64) - g).max())
        scale = float(np.abs(w).max())
        out.append(diff / scale if scale else diff)
    return out


def _record(record_property, losses, want_losses, leaf_err=None):
    record_property("loss_abs_err", float(np.max(np.abs(
        np.asarray(losses) - np.asarray(want_losses)))))
    if leaf_err is not None:
        record_property("leaf_rel_err", leaf_err)


STEP_KEYS = ([("grid", s, m) for s, m in STEPS]
             + [("row", s, m) for s, m in ROW_STEPS])


@pytest.mark.parametrize("key", STEP_KEYS, ids=lambda k: "-".join(map(str, k)))
def test_pipeline_step_matches_jax(runs, record_property, key):
    before, after, loss, _ = _jax_step(*key)
    want = _grads(before, after)
    worst = 0.0
    for r in runs[key]:
        np.testing.assert_allclose(r["losses"], [loss], atol=1e-5, rtol=0)
        errs = _leaf_errs(want, _grads(before, r["merged"]))
        worst = max(worst, max(errs))
        assert max(errs) <= 1e-4, (r["rank"], errs)
    _record(record_property, runs[key][0]["losses"], [loss], worst)


def test_remat_inside_a_stage_is_bitwise_the_plain_step(runs):
    """1F1B at M = 2 on 2 × 2 × 2 with ``remat=True``: each stage's blocks
    recompute their forward, model-axis sums included, in the backward;
    losses and every cell's parameters bitwise the plain run's."""
    for p, r in zip(runs[("grid", "1f1b", 2)], runs[("remat",)]):
        assert r["losses"] == p["losses"]
        for a, b in zip(jax.tree.leaves(r["params"]),
                        jax.tree.leaves(p["params"])):
            np.testing.assert_array_equal(a, b)


def test_cell_slices_are_jax_shards(runs):
    _, _, _, shards = _jax_step("grid", "gpipe", 2)
    ranks = runs[("grid", "gpipe", 2)]
    assert [(r["d"], r["s"], r["m"]) for r in ranks] == [
        (d, s, m) for d in range(2) for s in range(2) for m in range(2)]
    for r in ranks:
        for name in ("wq", "wo"):
            np.testing.assert_array_equal(r["init"]["blocks"][name],
                                          shards[name][r["rank"]])
        held = set(r["init"]) - {"blocks"}
        assert held == ({"embed"} if r["s"] == 0
                        else {"final_norm", "lm_head"})


@functools.lru_cache(maxsize=None)
def _jax_ring(agg, wire, steps=2, lr=1.0):
    mesh = _jax_mesh(MESH3)
    state, step = jpp.make_pipeline_overlap_step(
        JaxLlamaConfig(**CFG), optax.sgd(lr), mesh,
        jax.tree.map(jnp.asarray, _tree()), n_microbatches=2,
        aggregation=agg, wire=wire, overlap_microbatches=1)
    losses = []
    for b in _batches(steps, 2):
        state, loss = step(state, jpp.shard_batch(mesh, jnp.asarray(b)))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("agg", ["gradient", "zero1"])
def test_fp32_ring_matches_jax(runs, record_property, agg):
    want_losses, want = _jax_ring(agg, "fp32")
    for r in runs[f"fp32-{agg}"]:
        np.testing.assert_allclose(r["losses"], want_losses, atol=1e-5,
                                   rtol=0)
        assert max(_leaf_errs(want, r["params"])) < 1e-4
    _record(record_property, r["losses"], want_losses,
            max(_leaf_errs(want, r["params"])))


@pytest.mark.parametrize("wire,agg", RELAXED)
def test_compressed_wires_converge_with_jax(runs, record_property, wire,
                                            agg):
    want_losses, want = _jax_ring(agg, wire, steps=4, lr=LR_RELAXED)
    got = runs[f"{wire}-{agg}"][0]
    _record(record_property, got["losses"], want_losses,
            max(_leaf_errs(want, got["params"])))
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want_losses, atol=1e-3,
                               rtol=0)
    assert max(_leaf_errs(want, got["params"])) < 2e-3


@pytest.mark.parametrize("agg", ["gradient", "zero1"])
def test_each_cell_int8_ring_is_bitwise_its_spec(runs, agg):
    ranks = runs[f"int8_ef-{agg}"]
    for s in (0, 1):
        # cells[m][d]: the ring calls of data row d at model shard m.
        cells = [[next(r["ring"] for r in ranks if (r["d"], r["s"], r["m"])
                       == (d, s, m)) for d in (0, 1)] for m in (0, 1)]
        assert all(len(c) == 4 for rows in cells for c in rows)
        for call in range(4):
            xss = [[rows[d][call]["x"] for d in (0, 1)] for rows in cells]
            res = [[rows[d][call]["res_in"] for d in (0, 1)]
                   for rows in cells]
            want, want_res = ring_spec.agreed_rings(xss, "int8_ef", res)
            for m, rows in enumerate(cells):
                for d in (0, 1):
                    np.testing.assert_array_equal(rows[d][call]["owned"],
                                                  want[m][d])
                    np.testing.assert_array_equal(rows[d][call]["res_out"],
                                                  want_res[m][d])


def test_k4_window_is_bitwise_four_steps(runs):
    for one, four in zip(runs["k1"], runs["k4"]):
        assert one["losses"] == four["losses"]
        assert one["step"] == four["step"] == 4
        for a, b in zip(one["snapshot"], four["snapshot"]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (k,))]
    return [(path, tree)]


def _replicated_paths(local):
    """The leaves a cell holds whole: not a column or row block leaf."""
    return [p for p, _ in _leaves_with_paths(local)
            if not (p[0] == "blocks" and p[1] in COL | ROW)]


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("name", ["rep-m1", "rep-m2", "int8_ef-zero1",
                                  "int8_ef-gradient", "k4"])
def test_replicas_stay_bitwise_equal(runs, name):
    ranks = runs[name]
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    by_cell = {}
    for r in ranks:
        by_cell.setdefault((r["s"], r["m"]), []).append(r["local"])
    for rows in by_cell.values():          # data rows
        for other in rows[1:]:
            for a, b in zip(jax.tree.leaves(rows[0]),
                            jax.tree.leaves(other)):
                np.testing.assert_array_equal(a, b)
    if name == "rep-m1":
        return
    for s in (0, 1):                       # model replicas
        shard0, shard1 = by_cell[(s, 0)][0], by_cell[(s, 1)][0]
        paths = _replicated_paths(shard0)
        assert ("blocks", "attn_norm", "scale") in paths
        for path in paths:
            np.testing.assert_array_equal(_at(shard0, path),
                                          _at(shard1, path))


@functools.lru_cache(maxsize=None)
def _jax_profile():
    mesh = _jax_mesh(MESH3)
    opt = optax.sgd(LR)
    state = jpp.init_state(mesh, jax.tree.map(jnp.asarray, _tree()), opt)
    step = jpp.make_pipeline_step(JaxLlamaConfig(**CFG), opt, mesh, 2)
    tokens = jpp.shard_batch(mesh, jnp.asarray(_batches(1, 1)[0]))
    return jmeasure_comm(step, state, tokens).as_dict()


def test_comm_bytes_per_label_follow_the_jax_profile(runs):
    """GPipe at M = 2 on 2 × 2 × 2. The hops and the data sync as in
    ``tests/test_torch_pp.py``'s relation (a cell sends only real
    activations and cotangents; its gradient mean carries its own leaves);
    ``tp_replicated_grads``: one psum over ``model`` per leaf the cell
    holds whole, where JAX's cell also holds (and sums) the
    stage-replicated ``embed``, ``final_norm`` and ``lm_head`` on every
    stage; ``pp_replicated_grads`` has no counterpart."""
    jprof = _jax_profile()
    coll = jprof["collectives"]
    hop = coll["pp_activation_hop"]
    per_hop = hop["payload_bytes"] // hop["calls"]
    assert hop["calls"] == 2 + 2 - 1 and "pp_replicated_grads" in coll
    whole = _tree()
    top = sum(np.asarray(x).nbytes for k in ("embed", "final_norm",
                                             "lm_head")
              for x in jax.tree.leaves(whole[k]))
    jtp = coll["tp_replicated_grads"]
    for r in runs[("grid", "gpipe", 2)]:
        local = r["params"]
        first, last = r["s"] == 0, r["s"] == 1
        want = {}
        for label, calls in (("pp_activation_hop", 0 if last else 2),
                             ("pp_cotangent_hop", 0 if first else 2)):
            if calls:
                want[label] = ("ppermute", "stage", 2, calls,
                               calls * per_hop)
        for label in ("pp_loss_allreduce", "loss_allreduce"):
            c = coll[label]
            want[label] = (c["op"], c["axis"], c["axis_size"], c["calls"],
                           c["payload_bytes"])
        c = coll["grad_allreduce"]
        want["grad_allreduce"] = (c["op"], c["axis"], c["axis_size"], 1,
                                  sum(np.asarray(x).nbytes
                                      for x in jax.tree.leaves(local)))
        rep = [np.asarray(_at(local, p)) for p in _replicated_paths(local)]
        want["tp_replicated_grads"] = (jtp["op"], jtp["axis"],
                                       jtp["axis_size"], len(rep),
                                       sum(x.nbytes for x in rep))
        block_rep = sum(np.asarray(_at(local, p)).nbytes
                        for p in _replicated_paths(local) if p[0] == "blocks")
        assert (jtp["op"], jtp["axis"], jtp["axis_size"]) == ("psum",
                                                              "model", 2)
        assert jtp["payload_bytes"] == block_rep + top
        got = {label: (c["op"], c["axis"], c["axis_size"], c["calls"],
                       c["payload_bytes"])
               for label, c in r["comm"]["collectives"].items()}
        assert got == want, r["rank"]


def test_named_refusals_on_a_model_axis():
    mesh = distributed.PipelineMesh(2, 2, 0, 0, None, None, 2, 0)
    assert mesh.shape == MESH3
    jm = _jax_mesh(MESH3)
    with pytest.raises(ValueError) as want:
        jpp.make_pp_numerics(jax.tree.map(jnp.asarray, _tree()), jm)
    with pytest.raises(ValueError) as got:
        pp.make_pp_numerics(_tree(), mesh)
    assert str(got.value) == str(want.value)
    assert "tp.make_tp_numerics" in str(got.value)
    flat = pp.PPFlat(2, 0, 1, 2, True)
    template = dp.TrainState({}, (), torch.zeros((), dtype=torch.int32),
                             pp=pp.StageGeometry(mesh, {}, flat))
    with pytest.raises(ValueError, match=re.escape(
            "elastic re-mesh of the DP×PP×TP overlap state is unsupported")):
        pp.repartition_stage_state(template, template)
    pool = PoolMesh(np.arange(8).reshape(2, 2, 2),
                    ("data", "stage", "model"))
    with pytest.raises(ValueError) as want:
        jmesh_mod.survivor_submesh(jm, [0], layer_divisor=4)
    with pytest.raises(ValueError) as got:
        survivor_submesh(pool, [0], layer_divisor=4)
    assert str(got.value) == str(want.value)
    tcfg = LlamaConfig(**TR_CFG)
    with pytest.raises(ValueError) as got:
        llm.train_llm_pp(tcfg, TrainConfig(iters=1, stage=2,
                                           numerics_every=1),
                         mesh=ROW3, tokenizer=ByteTokenizer(), device="cpu")
    assert "tp.make_tp_numerics" in str(got.value)
    with pytest.raises(ValueError) as jgot:
        jllm.train_llm_pp(JaxLlamaConfig(**TR_CFG),
                          JaxTrainConfig(iters=1, stage=2, numerics_every=1),
                          mesh=_jax_mesh(ROW3), tokenizer=JaxByteTokenizer(),
                          log_every=0)
    assert str(got.value) == str(jgot.value)
    with pytest.raises(ValueError, match="3-axis") as got:
        llm.train_llm_pp(tcfg, TrainConfig(iters=1, stage=2), mesh=ROW3,
                         tokenizer=ByteTokenizer(),
                         resilience=ResilienceConfig(elastic=True),
                         device="cpu")
    assert str(got.value) == str(want.value)


def _jax_trainer(monkeypatch, mcfg, tcfg, shape, **kw):
    cfg = LlamaConfig(**mcfg, vocab_size=259)
    tree = params_to_numpy(llama.init_llama(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, c: jax.tree.map(jnp.asarray, tree))
    return jllm.train_llm_pp(JaxLlamaConfig(**mcfg), JaxTrainConfig(**tcfg),
                             mesh=_jax_mesh(shape),
                             tokenizer=JaxByteTokenizer(), log_every=0,
                             **kw).losses


def test_trainer_on_one_row_matches_jax(monkeypatch, record_property):
    tcfg = dict(TR_BASE, data=1)
    rep = llm.train_llm_pp(LlamaConfig(**TR_CFG), TrainConfig(**tcfg),
                           mesh=ROW3, tokenizer=ByteTokenizer(), log_every=0,
                           device="cpu")
    want = _jax_trainer(monkeypatch, TR_CFG, tcfg, ROW3)
    _record(record_property, rep.losses, want)
    assert len(rep.losses) == TR_BASE["iters"]
    np.testing.assert_allclose(rep.losses, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,kw,tol", [
    ("spd2", {}, 1e-5),
    ("ring-int8", dict(overlap_microbatches=1, wire="int8_ef",
                       iters=RING_ITERS), 1e-3)])
def test_trainer_routes_match_jax(runs, monkeypatch, record_property, name,
                                  kw, tol):
    agg = "zero1" if kw else "gradient"
    want = _jax_trainer(monkeypatch, TR_CFG, dict(TR_BASE, **kw), MESH3,
                        aggregation=agg)
    got = runs[name]
    _record(record_property, got[0]["losses"], want)
    for r in got:
        assert r["losses"] == got[0]["losses"]
        np.testing.assert_allclose(r["losses"], want, atol=tol, rtol=0)


def test_checkpoint_holds_the_jax_global_layout(runs):
    """A 3-axis state's checkpoint restores into a world of one's
    data-parallel state of the same model: the whole tree in the JAX
    layout, bitwise the merged cells."""
    ranks = runs[("ckpt",)]
    merged = ranks[0]["merged"]
    for r in ranks[1:]:
        for a, b in zip(jax.tree.leaves(merged),
                        jax.tree.leaves(r["merged"])):
            np.testing.assert_array_equal(a, b)
    cfg = LlamaConfig(**CFG)
    opt = fused_adam(1e-3)
    template = dp.init_state(params_from_jax(_tree(), cfg,
                                             device="cpu").tree(), opt)
    host = Checkpointer(str(runs["directory"] / "layout")).restore(template)
    assert int(host.step) == 1
    jax_shapes = [np.shape(x) for x in jax.tree.leaves(_tree())]
    got = params_to_numpy(host.params)
    assert [np.shape(x) for x in jax.tree.leaves(got)] == jax_shapes
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_ef_residuals_exact_through_preempt_resume(runs):
    ref, a, b = (runs[n][0] for n in ("ef-ref", "ef-a", "ef-b"))
    assert b["start_step"] == 4
    assert a["losses"] + b["losses"] == ref["losses"]
    assert np.isfinite(ref["losses"]).all()


def test_time_pp_train_step_runs_on_the_3_axis_mesh(runs):
    for rates in runs["bench"]:
        assert len(rates) == len(BENCH)
        assert all(np.isfinite(x) and x > 0 for x in rates)
