"""The port's elastic pipeline and tensor parallelism (the 2-axis rules of
``parallel/mesh.py``, ``pp.repartition_stage_state``,
``dp._resize_act_residual`` and ``train_llm_pp`` / ``train_llm_tp`` with
``ResilienceConfig(elastic=True)``) against the JAX package's, on
``tests/test_elastic.py``'s ``TINY4``: the byte tokenizer's vocab 259,
dmodel 20, 2 heads, 4 layers, ctx 16, batch 2 × 16 per data row, lr 3e-3,
fused Adam; the pipeline at 2 microbatches and K = 2, the TP trainer at
``psa="int8_ef"``.

Without a launch: ``survivor_submesh`` and ``rejoin_mesh`` on ``(data,
stage)`` and ``(data, model)`` grids name JAX's ranks and raise JAX's
texts; ``repartition_stage_state`` of a JAX 1×4 and 2×2 int8_ef ZeRO-1
snapshot (two Adam steps) into the port's 1×2 templates equals JAX's on
every global coordinate of the parameters and moments, and its residuals
follow the port's rule; ``_resize_act_residual`` is JAX's; the
interleaved refusal has JAX's text.

One launch of four ranks (``programs.elastic_calls``) runs every trainer
call, JAX's ``tests/test_elastic.py`` elastic PP and TP tests restated
within the port, each bitwise:

- no fault: elastic equals non-elastic (2×2 plain, 1×4 ZeRO-1 ring);
- ``device_loss@3`` on 1×4 re-partitions to 1×2 (mirror and checkpoint
  paths; 1F1B on the mirror path too), on 2×2 drops a data row (plain, and the int8_ef ZeRO-1 ring),
  the continued losses bitwise a fresh 1×2 run restored from the recovery
  point, every new world's state held against its mirror
  (``programs.reshard_differences``);
- the round trips 2×2 → 1×2 → 2×2 (data) and 1×4 → 1×2 → 1×4 (stage),
  bitwise a fresh run from the grow point;
- one compile per topology (``-d1s4`` and ``-d1s2``), no retrace;
- ``nan_grad`` then a stage loss in one run: skipped, re-partitioned,
  finite; a ``scale_hook`` resizing 2×2 → 1×2 → 2×2, nothing replayed;
- TP: no fault bitwise; 2×2 → 1×2 preempted and resumed bitwise the run
  without the preemption; a model-axis loss on 1×2 ends with
  ``ReplicaLossError``.

Losses within 1e-5 of JAX's trainers under the same fault plans (the 1×4
re-partition, the 2×2 row drop, the 1×4 round trip, the TP row drop), from
the port's seed-0 init."""

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
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.parallel import mesh as jmesh
from ddl25spring_tpu.parallel import pp as jpp
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.bench_utils import make_optimizer
from ddl25spring_tpu_torch.config import (LlamaConfig, ResilienceConfig,
                                          TrainConfig)
from ddl25spring_tpu_torch.convert import params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import distributed, dp, mesh, pp, programs
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

TINY4 = dict(vocab_size=259, dmodel=20, num_heads=2, n_layers=4, ctx_size=16)
PP_BASE = dict(batch_size=2, seq_len=16, lr=3e-3, microbatches=2,
               optimizer="fused")
TP_BASE = dict(batch_size=2, seq_len=16, lr=3e-3, model=2, psa="int8_ef",
               optimizer="fused")
LOSS = "device_loss@3"
TRIP = "device_loss@2,device_return@5:3"


def _pp(d, s, iters, *, name=None, res=None, agg="gradient", ovl=0,
        wire="fp32", ckpt_every=1000, prune=None, audit=False, tmp=None,
        tel=None, schedule="gpipe"):
    kwargs = dict(aggregation=agg, resilience=res, schedule=schedule,
                  checkpoint_every=ckpt_every, telemetry=tel)
    if name is not None:
        kwargs["checkpoint_dir"] = str(tmp / name)
    return dict(trainer="pp", cfg=TINY4, world=d * s, audit=audit,
                prune=prune, kwargs=kwargs,
                train_cfg=dict(PP_BASE, iters=iters, data=d, stage=s,
                               steps_per_dispatch=2, wire=wire,
                               overlap_microbatches=ovl))


def _tp(d, iters, *, name=None, res=None, ckpt_every=1000, tmp=None):
    kwargs = dict(resilience=res, checkpoint_every=ckpt_every)
    if name is not None:
        kwargs["checkpoint_dir"] = str(tmp / name)
    return dict(trainer="tp", cfg=TINY4, world=2 * d, audit=True,
                kwargs=kwargs, train_cfg=dict(TP_BASE, iters=iters, data=d))


def _el(faults="", **kw):
    return ResilienceConfig(elastic=True, faults=faults, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ddl25spring_tpu_torch.telemetry import Telemetry
    tmp = tmp_path_factory.mktemp("elastic_pp")
    tel = Telemetry(str(tmp / "tel"))
    names, calls = [], []

    def add(name, call):
        names.append(name)
        calls.append(call)

    def fresh(name, src, d, s, iters, remesh=0, **kw):
        add(name, _pp(d, s, iters, name=name, tmp=tmp,
                      prune=(str(tmp / src), str(tmp / name),
                             names.index(src), remesh), **kw))

    add("nf_ref", _pp(2, 2, 6))
    add("nf_el", _pp(2, 2, 6, res=_el()))
    add("nf_ref_z", _pp(1, 4, 6, agg="zero1", ovl=1))
    add("nf_el_z", _pp(1, 4, 6, agg="zero1", ovl=1, res=_el()))
    add("rp_m", _pp(1, 4, 8, name="rp_m", tmp=tmp, audit=True,
                    res=_el(LOSS, mirror_every=1)))
    fresh("rp_m_fresh", "rp_m", 1, 2, 8)
    add("rp_c", _pp(1, 4, 8, name="rp_c", tmp=tmp, ckpt_every=4,
                    res=_el(LOSS, mirror_every=0)))
    fresh("rp_c_fresh", "rp_c", 1, 2, 8)
    add("rp_1f1b", _pp(1, 4, 8, name="rp_1f1b", tmp=tmp, audit=True,
                       schedule="1f1b", res=_el(LOSS, mirror_every=1)))
    fresh("rp_1f1b_fresh", "rp_1f1b", 1, 2, 8, schedule="1f1b")
    add("rows", _pp(2, 2, 8, name="rows", tmp=tmp, audit=True,
                    res=_el(LOSS)))
    fresh("rows_fresh", "rows", 1, 2, 8)
    ring = dict(agg="zero1", ovl=1, wire="int8_ef")
    add("rows_int8", _pp(2, 2, 8, name="rows_int8", tmp=tmp, audit=True,
                         res=_el(LOSS), **ring))
    fresh("rows_int8_fresh", "rows_int8", 1, 2, 8, **ring)
    add("trip_data", _pp(2, 2, 12, name="trip_data", tmp=tmp, audit=True,
                         res=_el(TRIP, mirror_every=1)))
    fresh("trip_data_fresh", "trip_data", 2, 2, 12, remesh=1)
    add("trip_stage", _pp(1, 4, 12, name="trip_stage", tmp=tmp, audit=True,
                          res=_el(TRIP, mirror_every=1)))
    fresh("trip_stage_fresh", "trip_stage", 1, 4, 12, remesh=1)
    add("retrace", _pp(1, 4, 8, res=_el(LOSS), tel=tel))
    add("chaos", _pp(1, 4, 10, res=_el("nan_grad@1,device_loss@3",
                                       guard=True)))
    hooked = _pp(2, 2, 8, res=_el(mirror_every=1))
    hooked["kwargs"]["scale_hook"] = programs.PlanScaleHook({2: 1, 4: 2})
    add("hook", hooked)
    add("tp_ref", _tp(2, 4))
    add("tp_el", _tp(2, 4, res=_el()))
    add("tp_rows", _tp(2, 8, res=_el("device_loss@2", mirror_every=1)))
    add("tp_pre", _tp(2, 8, name="tp", tmp=tmp, ckpt_every=2,
                      res=_el("device_loss@2,preempt@5", mirror_every=1)))
    add("tp_resume", _tp(1, 8, name="tp", tmp=tmp, ckpt_every=2))
    add("tp_fatal", _tp(1, 4, res=_el("device_loss@1")))
    ranks = distributed.run_ranks(programs.elastic_calls, 4, calls,
                                  device="cpu", timeout=300)
    tel.close()
    out = {name: [r[i] for r in ranks] for i, name in enumerate(names)}
    out["tel"] = str(tmp / "tel")
    return out


def _ok(ranks):
    """The report every rank of the call's world returns, with no error."""
    for r in ranks:
        assert "error" not in r, r.get("error")
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
    return ranks[0]


def _audits(ranks):
    """Every re-mesh each rank took part in, held against its mirror."""
    found = [a for r in ranks for a in r.get("audit", [])]
    assert found
    for a in found:
        assert a["path"] != "mirror" or a["differences"] == [], a
    return found


# ------------------------------------------------------------ mesh rules

def _grid(d, s, axis="stage"):
    return mesh.PoolMesh(np.arange(d * s).reshape(d, s), ("data", axis))


def _jgrid(devices, d, s, axis="stage"):
    return make_mesh({"data": d, axis: s}, devices=devices[:d * s])


def _ids(m, devices):
    return [devices.index(x) for x in m.devices.flatten()]


@pytest.mark.parametrize("d,s,axis,lost", [
    (2, 2, "stage", [1]), (2, 2, "stage", [0, 3]), (1, 4, "stage", [2]),
    (1, 4, "stage", [0, 1, 3]), (2, 3, "stage", [0, 4]),
    (2, 2, "model", [3]), (3, 2, "model", [0, 5])])
def test_two_axis_survivors_and_rejoin_name_jax_ranks(devices, d, s, axis,
                                                      lost):
    j = jmesh.survivor_submesh(_jgrid(devices, d, s, axis), lost,
                               layer_divisor=4)
    p = mesh.survivor_submesh(_grid(d, s, axis), lost, layer_divisor=4)
    assert list(p.members) == _ids(j, devices)
    assert p.shape == dict(j.shape) and p.axis_names == j.axis_names
    back = [i for i in range(d * s) if i not in p.members]
    jb = jmesh.rejoin_mesh(j, [devices[i] for i in back],
                           pool=devices[:d * s], pool_shape=(d, s),
                           layer_divisor=4)
    pb = mesh.rejoin_mesh(p, back, pool=list(range(d * s)),
                          pool_shape=(d, s), layer_divisor=4)
    assert list(pb.members) == _ids(jb, devices) == list(range(d * s))
    assert pb.shape == dict(jb.shape)
    part = back[:1]
    jp = jmesh.rejoin_mesh(j, [devices[i] for i in part],
                           pool=devices[:d * s], pool_shape=(d, s),
                           layer_divisor=4)
    pp_ = mesh.rejoin_mesh(p, part, pool=list(range(d * s)),
                           pool_shape=(d, s), layer_divisor=4)
    assert list(pp_.members) == _ids(jp, devices)
    assert pp_.shape == dict(jp.shape)


@pytest.mark.parametrize("case", ["model-loss", "no-divisor",
                                  "partial-no-divisor", "range"])
def test_two_axis_refusals_have_jax_texts(devices, case):
    calls = {
        "model-loss": (lambda: jmesh.survivor_submesh(
            _jgrid(devices, 1, 2, "model"), [0]),
            lambda: mesh.survivor_submesh(_grid(1, 2, "model"), [0])),
        "no-divisor": (lambda: jmesh.survivor_submesh(
            _jgrid(devices, 1, 4), [1]),
            lambda: mesh.survivor_submesh(_grid(1, 4), [1])),
        "partial-no-divisor": (lambda: jmesh.rejoin_mesh(
            jmesh.survivor_submesh(_jgrid(devices, 1, 4), [1],
                                   layer_divisor=4), [devices[3]]),
            lambda: mesh.rejoin_mesh(mesh.survivor_submesh(
                _grid(1, 4), [1], layer_divisor=4), [3])),
        "range": (lambda: jmesh.survivor_submesh(
            _jgrid(devices, 2, 2), [4], layer_divisor=4),
            lambda: mesh.survivor_submesh(_grid(2, 2), [4],
                                          layer_divisor=4)),
    }
    ref, port = calls[case]
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == re.sub(
        r"TFRT_CPU_(\d+)|CpuDevice\(id=(\d+)\)",
        lambda m: m.group(1) or m.group(2), str(want.value))


# ---------------------------------------------------------- re-partition

JCFG = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=4, ctx_size=8)


def _jax_ring_state(devices, d, s, steps, host=True):
    params = jllama.init_llama(jax.random.key(0), JaxLlamaConfig(**JCFG))
    m = make_mesh({"data": d, "stage": s}, devices=devices[:d * s])
    state, step = jpp.make_pipeline_overlap_step(
        JaxLlamaConfig(**JCFG), optax.adam(1e-2), m, params,
        n_microbatches=2, aggregation="zero1", wire="int8_ef")
    rng = np.random.default_rng(7)
    for _ in range(steps):
        b = rng.integers(0, 64, (4 * d, 8)).astype(np.int32)
        state, _ = step(state, jpp.shard_batch(m, b))
    return (jax.tree.map(np.asarray, state) if host else state), params


def _jax_global(stack, params, n, s):
    """A JAX ``[n, S, n_slots]`` stack in global coordinates, row by row
    (``[n, total]``); later stages overwrite the replicated leaves."""
    ids, _, total = jpp._stage_coord_ids(params, n, s, 1)
    out = np.zeros((stack.shape[0], total), np.float32)
    for r in range(stack.shape[0]):
        for st in range(s):
            keep = ids[st][0] >= 0
            out[r, ids[st][0][keep]] = stack[r, st][keep]
    return out, ids, total


def _flat_stack_global(stack, params, n, s):
    """A JAX ``[n, S, local]`` moment or gather stack as one global
    vector: row r holds slots [r·local, (r+1)·local) of each stage's
    vector."""
    ids, _, total = jpp._stage_coord_ids(params, n, s, 1)
    g = np.zeros(total, np.float32)
    for st in range(s):
        full = stack[:, st].reshape(-1)
        keep = ids[st][0] >= 0
        g[ids[st][0][keep]] = full[keep]
    return g


def _template(params, s, stages, opt):
    m = distributed.PipelineMesh(
        1, stages, 0, s, distributed.Group("stage", tuple(range(stages)), s),
        distributed.Group("data", (s,), 0))
    return pp._pp_overlap_setup(opt, m, params, "int8_ef", "zero1", "gpipe",
                                2, 1, "cpu")


@pytest.mark.parametrize("d,s", [(1, 4), (2, 2)])
def test_repartition_matches_jax_on_every_coordinate(devices, d, s):
    jhost, jparams = _jax_ring_state(devices, d, s, 2)
    jtemplate, _ = _jax_ring_state(devices, 1, 2, 0, host=False)
    jnew = jax.tree.map(np.asarray,
                        jpp.repartition_stage_state(jhost, jtemplate))
    jadam = jhost.opt_state[0]
    opt = make_optimizer("fused", 1e-2)
    port_params = jax.tree.map(np.asarray, jhost.params)
    whole = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                         port_params)
    temps = [_template(whole, st, 2, opt) for st in range(2)]
    merged = pp.merged_template(temps[0])
    total = sum(x.numel() for x in tree_leaves(merged.params))

    def tree_of(g):
        return pp._global_to_tree(g, temps[0].pp.skeleton)

    mu = _flat_stack_global(jadam.mu, jparams, d, s)
    nu = _flat_stack_global(jadam.nu, jparams, d, s)
    ring, _, _ = _jax_global(jhost.ring_residual, jparams, d, s)
    gather = _flat_stack_global(jhost.gather_residual, jparams, d, s)
    host = pp.PPOverlapEFState(
        whole, merged.opt_state._replace(
            count=torch.tensor(int(jadam.count)), mu=tree_of(mu),
            nu=tree_of(nu)),
        torch.tensor(int(jhost.step)), torch.from_numpy(ring),
        torch.from_numpy(gather), None)
    want_mu = _flat_stack_global(jnew.opt_state[0].mu, jparams, 1, 2)
    want_nu = _flat_stack_global(jnew.opt_state[0].nu, jparams, 1, 2)
    want_p = np.concatenate([np.asarray(x).reshape(-1)
                             for x in jax.tree.leaves(jnew.params)])
    got_mu, got_nu = np.zeros(total, np.float32), np.zeros(total, np.float32)
    for st, t in enumerate(temps):
        new = pp.repartition_stage_state(host, t)
        ids, owned, sizes, _ = pp._stage_coord_ids(t.pp.skeleton, 1, 2, st)
        keep = ids[0] >= 0
        got_mu[ids[0][keep]] = new.opt_state.mu.numpy()[keep]
        got_nu[ids[0][keep]] = new.opt_state.nu.numpy()[keep]
        got_p = np.concatenate([x.detach().numpy().reshape(-1)
                                for x in tree_leaves(new.params)])
        np.testing.assert_array_equal(got_p, want_p[ids[0][keep]])
        # The residuals, by the port's rule: the host's global rows
        # gathered by id, row 0's own chunk (here the whole vector at one
        # data row) zero, the gather residual by id.
        np.testing.assert_array_equal(new.ring_residual.numpy(),
                                      np.zeros(sizes[0], np.float32))
        np.testing.assert_array_equal(
            new.gather_residual.numpy()[keep], gather[ids[0][keep]])
    np.testing.assert_array_equal(got_mu, want_mu)
    np.testing.assert_array_equal(got_nu, want_nu)
    assert int(new.step) == int(jnew.step)


def test_repartition_refuses_what_jax_refuses(devices):
    whole = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                         jax.tree.map(np.asarray, jllama.init_llama(
                             jax.random.key(0), JaxLlamaConfig(**JCFG))))
    opt = make_optimizer("fused", 1e-2)
    t = _template(whole, 0, 2, opt)
    snap = pp.merged_template(t)
    bucketed = snap._replace(ring_residual=(snap.ring_residual,) * 2)
    with pytest.raises(ValueError, match="comm_buckets mismatch"):
        pp.repartition_stage_state(bucketed, t)
    inter = pp.interleave_params(whole, 4, 1)
    with pytest.raises(ValueError, match="interleaved layout is unsupported"):
        pp.repartition_stage_state(snap._replace(params=inter), t)


def test_resize_act_residual_matches_jax():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 2, 3, 2, 1, 4, 5)).astype(np.float32)
    for n in (1, 2, 3):
        shape = (n,) + h.shape[1:]
        np.testing.assert_array_equal(dp._resize_act_residual(h, shape),
                                      jdp._resize_act_residual(h, shape))
    with pytest.raises(ValueError) as want:
        jdp._resize_act_residual(h, (1, 2, 3, 2, 2, 4, 5))
    with pytest.raises(ValueError) as got:
        dp._resize_act_residual(h, (1, 2, 3, 2, 2, 4, 5))
    assert str(got.value) == str(want.value)


def test_interleaved_elastic_refusal_has_jax_text(devices):
    with pytest.raises(ValueError) as want:
        jllm.train_llm_pp(
            JaxLlamaConfig(**TINY4),
            JaxTrainConfig(**PP_BASE, iters=2, data=1, stage=2,
                           steps_per_dispatch=2),
            mesh=make_mesh({"data": 1, "stage": 2}, devices=devices[:2]),
            tokenizer=JaxByteTokenizer(), schedule="interleaved",
            log_every=0, resilience=JaxResilienceConfig(elastic=True))
    with pytest.raises(ValueError) as got:
        llm.train_llm_pp(LlamaConfig(**TINY4),
                         TrainConfig(**PP_BASE, iters=2, data=1, stage=2,
                                     steps_per_dispatch=2),
                         tokenizer=ByteTokenizer(), schedule="interleaved",
                         log_every=0,
                         resilience=ResilienceConfig(elastic=True),
                         device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- the elastic runs

@pytest.mark.parametrize("ref,got", [("nf_ref", "nf_el"),
                                     ("nf_ref_z", "nf_el_z")])
def test_no_fault_elastic_pp_is_bitwise_non_elastic(runs, ref, got):
    a, b = _ok(runs[ref]), _ok(runs[got])
    assert len(b["losses"]) == 6 and b["losses"] == a["losses"]
    assert b["remeshes"] == [] and b["resilience"]["remeshes"] == 0


@pytest.mark.parametrize("name,path,replay", [("rp_m", "mirror", 0),
                                              ("rp_c", "checkpoint", 2),
                                              ("rp_1f1b", "mirror", 0)])
def test_stage_repartition_is_bitwise_a_fresh_1x2_run(runs, name, path,
                                                      replay):
    el = _ok(runs[name][:2])
    rec, = el["remeshes"]
    assert rec["axis"] == "stage"
    assert rec["old_shape"] == [1, 4] and rec["new_shape"] == [1, 2]
    assert rec["old_world"] == 4 and rec["new_world"] == 2
    assert rec["detected_at"] == 6 and rec["path"] == path
    assert rec["steps_replayed"] == replay
    assert len(el["losses"]) == 8 and np.isfinite(el["losses"]).all()
    fresh = _ok(runs[f"{name}_fresh"][:2])
    m = rec["resume_step"]
    assert fresh["start_step"] == m
    assert el["losses"][m:] == fresh["losses"]
    if path == "mirror":
        assert len(_audits(runs[name])) == 2


@pytest.mark.parametrize("name", ["rows", "rows_int8"])
def test_data_row_drop_is_bitwise_a_fresh_1x2_run(runs, name):
    el = _ok(runs[name][:2])
    rec, = el["remeshes"]
    assert rec["axis"] == "data"
    assert rec["old_shape"] == [2, 2] and rec["new_shape"] == [1, 2]
    fresh = _ok(runs[f"{name}_fresh"][:2])
    m = rec["resume_step"]
    assert fresh["start_step"] == m and el["losses"][m:] == fresh["losses"]
    assert len(_audits(runs[name])) == 2


@pytest.mark.parametrize("name,axis", [("trip_data", "data"),
                                       ("trip_stage", "stage")])
def test_round_trip_restores_the_grid_bitwise(runs, name, axis):
    el = _ok(runs[name])
    shrink, grow = el["remeshes"]
    assert [shrink["direction"], grow["direction"]] == ["shrink", "grow"]
    assert grow["axis"] == axis and shrink["new_shape"] == [1, 2]
    assert grow["new_shape"] == shrink["old_shape"]
    assert grow["old_world"] == 2 and grow["new_world"] == 4
    fresh = _ok(runs[f"{name}_fresh"])
    m = grow["resume_step"]
    assert fresh["start_step"] == m and el["losses"][m:] == fresh["losses"]
    assert len(_audits(runs[name])) == 6        # 2 + 4 new-world members


def test_one_compile_per_topology(runs):
    from ddl25spring_tpu_torch.telemetry import read_events
    _ok(runs["retrace"][:2])
    events = read_events(runs["tel"] + "/events.jsonl")
    compiles = {}
    for e in events:
        if e.get("type") == "compile":
            row = compiles.setdefault(e["name"], [0, 0])
            row[0] += 1
            row[1] += int(bool(e.get("retrace")))
    assert {"train/pp-gpipe-elastic-d1s4",
            "train/pp-gpipe-elastic-d1s2"} <= set(compiles)
    assert all(r == 0 for _, r in compiles.values())
    remesh, = [e for e in events if e.get("type") == "remesh"]
    assert (remesh["axis"], remesh["old_shape"], remesh["new_shape"]) == (
        "stage", [1, 4], [1, 2])


def test_nan_grad_then_stage_loss_completes(runs):
    got = _ok(runs["chaos"][:2])
    assert got["resilience"]["skipped_steps"] >= 1
    assert got["resilience"]["remeshes"] == 1
    assert got["remeshes"][0]["axis"] == "stage"
    assert len(got["losses"]) == 10 and np.isfinite(got["losses"][4:]).all()


def test_scale_hook_resizes_the_pipeline_rows(runs):
    """A ``scale_hook`` asking for one data row at step 2 and two at step
    4: 2×2 → 1×2 → 2×2 at the chunk edges, nothing replayed."""
    got = _ok(runs["hook"])
    assert [(r["axis"], r["old_shape"], r["new_shape"], r["steps_replayed"])
            for r in got["remeshes"]] == [("data", [2, 2], [1, 2], 0),
                                          ("data", [1, 2], [2, 2], 0)]
    assert len(got["losses"]) == 8 and np.isfinite(got["losses"]).all()


def test_no_fault_elastic_tp_is_bitwise(runs):
    assert _ok(runs["tp_el"])["losses"] == _ok(runs["tp_ref"])["losses"]


def test_tp_row_drop_preempt_resume_is_bitwise(runs):
    ref = _ok(runs["tp_rows"][:2])
    rec, = ref["remeshes"]
    assert (rec["axis"], rec["old_shape"], rec["new_shape"]) == (
        "data", [2, 2], [1, 2])
    assert len(ref["losses"]) == 8
    r1, r2 = _ok(runs["tp_pre"][:2]), _ok(runs["tp_resume"][:2])
    assert r1["preempted"] and len(r1["losses"]) < 8
    assert len(r1["remeshes"]) == 1 and not r2["preempted"]
    assert ref["losses"][r2["start_step"]:] == r2["losses"]
    assert ref["losses"][:r2["start_step"]] == r1["losses"][:r2["start_step"]]
    assert len(_audits(runs["tp_rows"])) == 2


def test_tp_model_axis_loss_is_fatal(runs):
    for r in runs["tp_fatal"][:2]:
        assert r["error"][0] == "ReplicaLossError"


def _jax_init(monkeypatch):
    tree = params_to_numpy(llama.init_llama(
        LlamaConfig(**TINY4), torch.Generator().manual_seed(0),
        device="cpu"))
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("name,d,s,faults,iters", [
    ("rp_m", 1, 4, LOSS, 8), ("rows", 2, 2, LOSS, 8),
    ("trip_stage", 1, 4, TRIP, 12)])
def test_pp_losses_match_jax_under_the_same_fault_plan(runs, monkeypatch,
                                                       record_property,
                                                       devices, name, d, s,
                                                       faults, iters):
    _jax_init(monkeypatch)
    want = jllm.train_llm_pp(
        JaxLlamaConfig(**TINY4),
        JaxTrainConfig(**PP_BASE, iters=iters, data=d, stage=s,
                       steps_per_dispatch=2),
        mesh=make_mesh({"data": d, "stage": s}, devices=devices[:d * s]),
        tokenizer=JaxByteTokenizer(), log_every=0,
        resilience=JaxResilienceConfig(elastic=True, mirror_every=1,
                                       faults=faults))
    got = runs[name][0]
    assert [(r["axis"], r["old_shape"], r["new_shape"])
            for r in got["remeshes"]] == [
        (r["axis"], r["old_shape"], r["new_shape"]) for r in want.remeshes]
    record_property("loss_abs_err", float(np.max(np.abs(
        np.asarray(got["losses"]) - np.asarray(want.losses)))))
    np.testing.assert_allclose(got["losses"], want.losses, atol=1e-5, rtol=0)


def test_tp_losses_match_jax_under_the_same_fault_plan(runs, monkeypatch,
                                                       record_property,
                                                       devices):
    _jax_init(monkeypatch)
    want = jllm.train_llm_tp(
        JaxLlamaConfig(**TINY4), JaxTrainConfig(**TP_BASE, iters=8, data=2),
        mesh=make_mesh({"data": 2, "model": 2}, devices=devices[:4]),
        tokenizer=JaxByteTokenizer(), log_every=0,
        resilience=JaxResilienceConfig(elastic=True, mirror_every=1,
                                       faults="device_loss@2"))
    got = np.asarray(runs["tp_rows"][0]["losses"])
    record_property("loss_abs_err", float(np.max(np.abs(
        got - np.asarray(want.losses)))))
    np.testing.assert_allclose(got, want.losses, atol=1e-5, rtol=0)
