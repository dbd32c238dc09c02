"""The port's multi-process data parallelism against the JAX package's
``data=2`` mesh (``tests/conftest.py`` gives 8 virtual CPU devices): the
collectives and the rank launcher, gradient aggregation (with and without
accumulation, with the fused apply), the K-step loop, weight aggregation
and ``train_llm_dp(data=2)`` end to end. The port's two ranks are two
processes on the CPU joined by gloo (``distributed.run_ranks``); one launch
runs every step case (``programs.dp_cases``), started once per module.

Tolerances: losses within 1e-5 (the frameworks sum products in different
orders); the all-reduced gradient within 1e-5 of each leaf's largest
entry; parameters after Adam steps within lr, all but a stated share
within 1e-6 (ROADMAP.md § C: Adam's slope lr/ε where a gradient is near
ε); the port's K-step loop bitwise its per-step calls, and weight
aggregation's ranks bitwise one another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import pallas_adam as jpadam
from ddl25spring_tpu.ops.adam import fused_adam as jfused_adam
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
from ddl25spring_tpu_torch.convert import params_to_numpy
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.parallel import distributed, programs
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
LR = 8e-4
N, B, T = 2, 2, 16            # ranks, batch per rank, sequence
MISMATCH_SHARE = 1e-4         # of parameters past 1e-6 after the steps


def _tree(seed=0):
    return jax.tree.map(np.asarray, jllama.init_llama(
        jax.random.PRNGKey(seed), JaxLlamaConfig(**SMALL)))


def _batches(n_steps, seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (n_steps, N * B, T) if k is None else (n_steps, k, N * B, T)
    return rng.integers(0, SMALL["vocab_size"], shape)


TREE = _tree()
CASES = {
    "gradient": dict(mode="gradient", batches=_batches(3, 1), grads=True),
    "accum": dict(mode="gradient", batches=_batches(3, 2), accum_steps=2),
    "pallas": dict(mode="gradient", batches=_batches(3, 3),
                   optimizer="pallas"),
    "per_step": dict(mode="gradient", batches=_batches(4, 4)),
    "multi_k1": dict(mode="multi", batches=_batches(4, 4)[:, None]),
    "multi_k4": dict(mode="multi", batches=_batches(4, 4)[None]),
    "weight": dict(mode="weight", batches=_batches(2, 5)),
}


@pytest.fixture(scope="module")
def port():
    """One launch of two ranks: every step case, then the collectives and
    the child's module list. ``port[name]`` is the two ranks' results."""
    cases = [dict(cfg=SMALL, params=TREE, lr=LR, **c) for c in CASES.values()]
    ranks = distributed.run_ranks(
        programs.sequence, N, [("dp_cases", (cases,)),
                               ("collectives", (8,)),
                               ("loaded_modules", ())], device="cpu")
    out = {name: [r[0][i] for r in ranks] for i, name in enumerate(CASES)}
    out["collectives"] = [r[1] for r in ranks]
    out["modules"] = [r[2] for r in ranks]
    return out


MESH = None


def _mesh():
    global MESH
    if MESH is None:
        MESH = make_mesh({"data": N})
    return MESH


def _jax_loss(cfg):
    return lambda p, b: jllama.forward_loss(p, b, cfg)


def _jax_run(case, make_step, opt):
    """The JAX step over the case's global batches: (losses, state)."""
    mesh = _mesh()
    jcfg = JaxLlamaConfig(**SMALL)
    step = make_step(_jax_loss(jcfg), opt, mesh)
    state = jdp.replicate(mesh, jdp.init_state(
        jax.tree.map(jnp.asarray, TREE), opt))
    losses = []
    for b in case["batches"]:
        if b.ndim == 3:
            state, ls = step(state, jdp.shard_batch_window(mesh,
                                                           jnp.asarray(b)))
            losses += np.asarray(ls).tolist()
        else:
            state, loss = step(state, jdp.shard_batch(mesh, jnp.asarray(b)))
            losses.append(float(loss))
    return losses, state


def _hold_params(got: dict, want) -> None:
    diff = np.concatenate([
        np.abs(a - np.asarray(b)).ravel() for a, b in
        zip(jax.tree.leaves(got), jax.tree.leaves(want))])
    assert diff.max() <= LR
    assert (diff > 1e-6).mean() <= MISMATCH_SHARE


def test_collectives_sum_exactly(port):
    x = [np.arange(8, dtype=np.float32) + r for r in range(N)]
    total = x[0] + x[1]
    for r, got in enumerate(port["collectives"]):
        np.testing.assert_array_equal(got["psum"], total)
        np.testing.assert_array_equal(got["pmean"], total / N)
        np.testing.assert_array_equal(got["psum_scatter"],
                                      total[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(got["all_gather"],
                                      [0, 1, 11, 12])
        np.testing.assert_array_equal(got["broadcast"], x[1])
        np.testing.assert_array_equal(got["pmean_tree"][0], total[:2] / N)
        np.testing.assert_array_equal(got["pmean_tree"][1], total / N)
        assert got["info"] == {"process_id": r, "num_processes": N,
                               "local_devices": 1, "global_devices": N}


def test_run_ranks_children_never_import_jax(port):
    for mods in port["modules"]:
        assert "jax" not in mods and "ddl25spring_tpu" not in mods
        assert "ddl25spring_tpu_torch.parallel.programs" in mods


def test_run_ranks_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised:(.|\n)*"
                                           "rank 1 raises on purpose"):
        distributed.run_ranks(programs.raise_on, 2, 1, device="cpu",
                              timeout=120)


@pytest.mark.parametrize("name,opt", [
    ("gradient", lambda: jfused_adam(LR)),
    ("pallas", lambda: jpadam.FusedApplyAdam(LR, interpret=True))])
def test_grad_aggregation_matches_jax_data2(port, name, opt):
    losses, state = _jax_run(CASES[name], jdp.make_grad_aggregation_step,
                             opt())
    for rank in port[name]:
        np.testing.assert_allclose(rank["losses"], losses, atol=1e-5)
        assert rank["step"] == int(state.step) == 3
        _hold_params(rank["params"], state.params)
    # Replicated: the ranks hold the same parameters, bitwise.
    for a, b in zip(jax.tree.leaves(port[name][0]["params"]),
                    jax.tree.leaves(port[name][1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_all_reduced_gradient_of_step_one_matches_jax(port):
    jcfg = JaxLlamaConfig(**SMALL)
    b = CASES["gradient"]["batches"][0]
    params = jax.tree.map(jnp.asarray, TREE)
    shard_grads = [jax.jit(jax.grad(_jax_loss(jcfg)))(params, jnp.asarray(
        b[r * B:(r + 1) * B])) for r in range(N)]
    want = jax.tree.map(lambda *g: np.mean(np.stack(g), 0), *shard_grads)
    for rank in port["gradient"]:
        for g, w in zip(rank["grads"], jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max())


def test_grad_aggregation_with_accum_matches_jax_data2(port):
    losses, state = _jax_run(
        CASES["accum"], lambda f, o, m: jdp.make_grad_aggregation_step(
            f, o, m, accum_steps=2), jfused_adam(LR))
    for rank in port["accum"]:
        np.testing.assert_allclose(rank["losses"], losses, atol=1e-5)
        _hold_params(rank["params"], state.params)


@pytest.mark.parametrize("k", [1, 4])
def test_multi_step_bitwise_matches_per_step(port, k):
    multi, per = port[f"multi_k{k}"], port["per_step"]
    for m, p in zip(multi, per):
        assert m["losses"] == p["losses"] and m["step"] == p["step"] == 4
        for a, b in zip(jax.tree.leaves(m["params"]),
                        jax.tree.leaves(p["params"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(m["opt_state"]),
                        jax.tree.leaves(p["opt_state"])):
            np.testing.assert_array_equal(a, b)


def test_multi_step_matches_jax_multi_step(port):
    losses, _ = _jax_run(CASES["multi_k4"], jdp.make_multi_step,
                         jfused_adam(LR))
    assert len(losses) == 4
    np.testing.assert_allclose(port["multi_k4"][0]["losses"], losses,
                               atol=1e-5)


def test_weight_aggregation_matches_jax_and_stays_replicated(port):
    losses, state = _jax_run(
        CASES["weight"], lambda f, o, m: jdp.make_weight_aggregation_step(
            f, o, m), jfused_adam(LR))
    r0, r1 = port["weight"]
    for field in ("params", "opt_state"):
        for a, b in zip(jax.tree.leaves(r0[field]),
                        jax.tree.leaves(r1[field])):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r0["losses"], losses, atol=1e-5)
    _hold_params(r0["params"], state.params)
    for a, b in zip(jax.tree.leaves(r0["opt_state"].mu),
                    jax.tree.leaves(state.opt_state.mu)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    assert int(r0["opt_state"].count) == int(np.asarray(
        state.opt_state.count)) == 2


def _port_init(mcfg):
    """The port's seed-0 init at the trainer's vocab, as numpy."""
    cfg = LlamaConfig(**mcfg, vocab_size=259)
    return params_to_numpy(llama.init_llama(
        cfg, torch.Generator().manual_seed(0), device="cpu"))


@pytest.mark.parametrize("aggregation", ["gradient", "zero1"])
def test_train_llm_dp_data2_matches_jax(monkeypatch, aggregation):
    """Both trainers from the port's init (the JAX init patched to return
    it), the byte tokenizer's corpus, two ranks each reading its shard:
    three losses within 1e-4. The port's call starts its own ranks."""
    mcfg = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
    tcfg = dict(batch_size=2, seq_len=16, iters=3, data=2, optimizer="fused")
    tree = _port_init(mcfg)
    monkeypatch.setattr(jllm.llama, "init_llama",
                        lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    jrep = jllm.train_llm_dp(JaxLlamaConfig(**mcfg), JaxTrainConfig(**tcfg),
                             tokenizer=JaxByteTokenizer(), log_every=0,
                             aggregation=aggregation)
    rep = llm.train_llm_dp(LlamaConfig(**mcfg), TrainConfig(**tcfg),
                           tokenizer=ByteTokenizer(), log_every=0,
                           aggregation=aggregation, device="cpu")
    assert rep.steps == 3 and len(rep.losses) == 3
    np.testing.assert_allclose(rep.losses, jrep.losses, atol=1e-4)
    assert rep.tokens_per_sec > 0


@pytest.mark.parametrize("aggregation,tcfg,match", [
    ("weight", dict(accum_steps=2), "accum_steps"),
    ("weight", dict(steps_per_dispatch=4), "steps_per_dispatch"),
    ("zero1", dict(accum_steps=2), "accum_steps"),
    ("mean", {}, "unknown aggregation")])
def test_train_llm_dp_refuses_what_jax_refuses(aggregation, tcfg, match):
    with pytest.raises(ValueError, match=match):
        llm.train_llm_dp(LlamaConfig(**SMALL), TrainConfig(data=2, **tcfg),
                         aggregation=aggregation, device="cpu")
