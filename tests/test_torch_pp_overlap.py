"""The port's DP×PP ring drivers (``pp.make_pipeline_overlap_step`` /
``make_pipeline_overlap_multi_step`` and ``train_llm_pp``'s ring route)
against the JAX package's on the CPU mesh, at ``tests/test_pp.py``'s
config: vocab 64, dmodel 16, 2 heads, 4 layers, ctx 8, a global batch of
8 × 8 over data 2 × stage 2 (GPipe, 2 pipeline microbatches), plain SGD so
an update is linear in the gradient; weights through
``convert.params_from_jax``, batches from a numpy seed.

One launch of four ranks (data 2 × stage 2) for the module
(``programs.pp_overlap_cases`` and ``programs.pp_trainer_calls``). Held:

- the fp32 wire × {gradient, zero1} × M {1, 2} × ``comm_buckets`` {1, 2}:
  losses within 1e-5 of JAX's ``make_pipeline_overlap_step``, merged
  leaves within 1e-4 of their max, over 2 steps;
- bf16 and int8_ef × {gradient, zero1} (lr 0.02, 4 steps): losses within
  1e-3 and leaves within 2e-3 of their max. The chunk boundaries differ
  from JAX's (each port stage rings only its own leaves), so these two
  wires are held to this relaxed bar against JAX and bitwise to the
  port's own ring spec;
- each stage's int8 ring, every call of a step, bitwise
  ``ring_spec.ring`` on the inputs its data row gave it;
- ``make_pipeline_overlap_multi_step`` at K = 4 bitwise four per-step
  calls (int8_ef, ZeRO-1, fused Adam), snapshot included;
- ZeRO-1's data-axis wire equals gradient aggregation's, byte for byte;
- the data rows' parameters bitwise equal under the int8 legs;
- an int8_ef ZeRO-1 run preempted at a chunk edge and resumed from its
  checkpoint bitwise the uninterrupted run (JAX's
  ``test_pp_overlap_ef_residual_exact_through_preempt_resume``);
- ``train_llm_pp`` with M >= 1 (fp32, gradient M = 1 and ZeRO-1 M = 2)
  within 1e-5 of JAX's losses from the same init, the bf16 wire within
  1e-3."""

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
from ddl25spring_tpu.parallel import pp as jpp
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import distributed, programs, ring_spec

torch.set_num_threads(1)

CFG = dict(vocab_size=64, dmodel=16, num_heads=2, n_layers=4, ctx_size=8)
GRID = dict(data=2, stage=2, microbatches=2)
FP32 = [(agg, m, cb) for agg in ("gradient", "zero1") for m in (1, 2)
        for cb in (1, 2)]
RELAXED = [(wire, agg) for wire in ("bf16", "int8_ef")
           for agg in ("gradient", "zero1")]
LR_RELAXED = 0.02
# train_llm_pp calls: JAX's preempt/resume config, then two fp32 ring runs.
EF_CFG = dict(dmodel=16, num_heads=2, n_layers=2, ctx_size=16)
EF_BASE = dict(batch_size=2, seq_len=16, lr=3e-3, stage=2, microbatches=2,
               data=2, wire="int8_ef", overlap_microbatches=1,
               steps_per_dispatch=2, optimizer="fused")
TR_CFG = dict(dmodel=16, num_heads=2, n_layers=4, ctx_size=16)
TR_BASE = dict(batch_size=4, seq_len=16, lr=3e-3, iters=4, stage=2,
               microbatches=2, data=2, optimizer="fused")
# name: (aggregation, M, wire, loss tolerance against JAX)
TRAINER = {"gradient-m1": ("gradient", 1, "fp32", 1e-5),
           "zero1-m2": ("zero1", 2, "fp32", 1e-5),
           "bf16-gradient-m1": ("gradient", 1, "bf16", 1e-3)}


def _params():
    return jax.tree.map(np.asarray,
                        jllama.init_llama(jax.random.key(0),
                                          JaxLlamaConfig(**CFG)))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (8, CFG["ctx_size"]))
            .astype(np.int32) for _ in range(n)]


def _case(agg, wire, m=1, cb=1, steps=2, **kw):
    return dict(cfg=CFG, params=_params(), **GRID, aggregation=agg,
                wire=wire, overlap=m, comm_buckets=cb,
                batches=_batches(steps), **kw)


def _cases():
    cases = {f"fp32-{agg}-m{m}-b{cb}": _case(agg, "fp32", m, cb)
             for agg, m, cb in FP32}
    cases.update({f"{wire}-{agg}": _case(agg, wire, steps=4, lr=LR_RELAXED,
                                         spy=wire == "int8_ef")
                  for wire, agg in RELAXED})
    adam = dict(optimizer="fused", lr=1e-3)
    cases["k1"] = _case("zero1", "int8_ef", steps=4, snapshot=True, **adam)
    window = np.stack(_batches(4))
    cases["k4"] = dict(_case("zero1", "int8_ef", **adam), window=True,
                       batches=[window], snapshot=True)
    return cases


def _trainer_calls(directory):
    ck = str(directory / "ef")
    calls = {"ef-ref": (EF_CFG, dict(EF_BASE, iters=6),
                        {"aggregation": "zero1"}),
             "ef-a": (EF_CFG, dict(EF_BASE, iters=4),
                      {"aggregation": "zero1", "checkpoint_dir": ck,
                       "checkpoint_every": 100}),
             "ef-b": (EF_CFG, dict(EF_BASE, iters=6),
                      {"aggregation": "zero1", "checkpoint_dir": ck,
                       "checkpoint_every": 100})}
    for name, (agg, m, wire, _) in TRAINER.items():
        calls[name] = (TR_CFG, dict(TR_BASE, overlap_microbatches=m,
                                    wire=wire), {"aggregation": agg})
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    calls = _trainer_calls(tmp_path_factory.mktemp("pp_overlap"))
    ranks = distributed.run_ranks(
        programs.sequence, 4,
        [("pp_overlap_cases", (list(cases.values()),)),
         ("pp_trainer_calls", (list(calls.values()),))],
        device="cpu", timeout=300)
    out = {name: [r[0][i] for r in ranks] for i, name in enumerate(cases)}
    out.update({name: [r[1][i] for r in ranks]
                for i, name in enumerate(calls)})
    return out


def _jax_run(agg, wire, m=1, cb=1, steps=2, lr=1.0):
    mesh = make_mesh({"data": 2, "stage": 2}, devices=jax.devices()[:4])
    state, step = jpp.make_pipeline_overlap_step(
        JaxLlamaConfig(**CFG), optax.sgd(lr), mesh,
        jax.tree.map(jnp.asarray, _params()), n_microbatches=2,
        aggregation=agg, wire=wire, overlap_microbatches=m,
        comm_buckets=cb)
    losses = []
    for b in _batches(steps):
        state, loss = step(state, jpp.shard_batch(mesh, b))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _leaf_errs(want, got):
    """Per leaf: max |difference| over the leaf's max |value|."""
    return [float(np.abs(w - g).max() / np.abs(w).max())
            for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got))]


def _record(record_property, losses, want_losses, leaf_err=None):
    """The measured errors, as junit properties of the test."""
    record_property("loss_abs_err", float(np.max(np.abs(
        np.asarray(losses) - np.asarray(want_losses)))))
    if leaf_err is not None:
        record_property("leaf_rel_err", leaf_err)


@pytest.mark.parametrize("agg,m,cb", FP32)
def test_fp32_ring_matches_jax(runs, record_property, agg, m, cb):
    want_losses, want = _jax_run(agg, "fp32", m, cb)
    for r in runs[f"fp32-{agg}-m{m}-b{cb}"]:
        np.testing.assert_allclose(r["losses"], want_losses, atol=1e-5,
                                   rtol=0)
        assert max(_leaf_errs(want, r["params"])) < 1e-4
    _record(record_property, r["losses"], want_losses,
            max(_leaf_errs(want, r["params"])))


@pytest.mark.parametrize("wire,agg", RELAXED)
def test_compressed_wires_converge_with_jax(runs, record_property, wire,
                                            agg):
    want_losses, want = _jax_run(agg, wire, steps=4, lr=LR_RELAXED)
    got = runs[f"{wire}-{agg}"][0]
    _record(record_property, got["losses"], want_losses,
            max(_leaf_errs(want, got["params"])))
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want_losses, atol=1e-3,
                               rtol=0)
    assert max(_leaf_errs(want, got["params"])) < 2e-3


@pytest.mark.parametrize("agg", ["gradient", "zero1"])
def test_each_stage_int8_ring_is_bitwise_its_spec(runs, agg):
    ranks = runs[f"int8_ef-{agg}"]
    for s in (0, 1):
        rows = sorted((r for r in ranks if r["s"] == s), key=lambda r: r["d"])
        calls = [r["ring"] for r in rows]
        assert len(calls[0]) == len(calls[1]) == 4      # one ring per step
        for c0, c1 in zip(*calls):
            want, res = ring_spec.ring([c0["x"], c1["x"]], "int8_ef",
                                       [c0["res_in"], c1["res_in"]])
            for r, c in enumerate((c0, c1)):
                np.testing.assert_array_equal(c["owned"], want[r])
                np.testing.assert_array_equal(c["res_out"], res[r])


def test_k4_window_is_bitwise_four_steps(runs):
    for one, four in zip(runs["k1"], runs["k4"]):
        assert one["losses"] == four["losses"]
        assert one["step"] == four["step"] == 4
        for a, b in zip(one["snapshot"], four["snapshot"]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)


def test_zero1_wire_equals_gradient_wire(runs):
    def data_bytes(name):
        return [r["comm"]["axes"]["data"]["wire_bytes_per_device"]
                for r in runs[name]]

    assert data_bytes("int8_ef-zero1") == data_bytes("int8_ef-gradient")
    np.testing.assert_allclose(runs["int8_ef-zero1"][0]["losses"][0],
                               runs["int8_ef-gradient"][0]["losses"][0],
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["int8_ef-gradient", "int8_ef-zero1",
                                  "k4"])
def test_data_replicas_stay_bitwise_equal(runs, name):
    rows = runs[name]
    for r in rows[1:]:
        for a, b in zip(jax.tree.leaves(rows[0]["params"]),
                        jax.tree.leaves(r["params"])):
            np.testing.assert_array_equal(a, b)


def test_ef_residuals_exact_through_preempt_resume(runs):
    ref, a, b = (runs[n][0] for n in ("ef-ref", "ef-a", "ef-b"))
    assert b["start_step"] == 4
    assert a["losses"] + b["losses"] == ref["losses"]
    assert np.isfinite(ref["losses"]).all()


@pytest.mark.parametrize("name", list(TRAINER))
def test_trainer_ring_route_matches_jax(runs, monkeypatch, record_property,
                                        name):
    agg, m, wire, tol = TRAINER[name]
    cfg = LlamaConfig(**TR_CFG, vocab_size=259)
    tree = params_to_numpy(llama.init_llama(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, c: jax.tree.map(jnp.asarray, tree))
    want = jllm.train_llm_pp(
        JaxLlamaConfig(**TR_CFG),
        JaxTrainConfig(**TR_BASE, overlap_microbatches=m, wire=wire),
        mesh=make_mesh({"data": 2, "stage": 2}, devices=jax.devices()[:4]),
        tokenizer=JaxByteTokenizer(), log_every=0, aggregation=agg)
    _record(record_property, runs[name][0]["losses"], want.losses)
    for r in runs[name]:
        np.testing.assert_allclose(r["losses"], want.losses, atol=tol,
                                   rtol=0)
