"""The port's training path against the JAX package's on the same weights
(the JAX init through ``convert.params_from_jax``) and the same tokens:
``forward_loss`` and every parameter gradient, three steps of the
gradient-aggregation step with the fused Adam apply and gradient
accumulation, and three steps of ``train_llm_dp``. The attention runs its
plain version on both sides here (the CPU); the flash backward is held
against JAX's Pallas kernels in ``test_torch_flash_attention.py`` and the
CUDA kernels against their plain versions by ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import TrainConfig as JaxTrainConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import pallas_adam as jpadam
from ddl25spring_tpu.parallel import dp as jdp
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.tokenizers import ByteTokenizer as JaxByteTokenizer
from ddl25spring_tpu.train import llm as jllm
from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops import pallas_adam
from ddl25spring_tpu_torch.parallel import dp
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=32)
LR = 8e-4


def _jax_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jllama.init_llama(jax.random.PRNGKey(seed), jcfg))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# fp32: the frameworks sum matmuls and reductions in different orders.
# bf16: every matmul output and activation is rounded to bf16 (2^-8
# relative) on both sides, at places that differ slightly.
@pytest.mark.parametrize("dtype,loss_tol,grad_rel", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 2e-2, 1e-1)])
def test_forward_loss_and_every_grad_match_jax(dtype, loss_tol, grad_rel):
    jcfg = JaxLlamaConfig(**SMALL, dtype=dtype)
    tree = _jax_tree(jcfg)
    tokens = _tokens((2, 24), SMALL["vocab_size"], seed=1)
    jloss, jgrads = jax.value_and_grad(jllama.forward_loss)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jcfg)
    cfg = LlamaConfig(**SMALL, dtype=dtype)
    model = params_from_jax(tree, cfg, device="cpu")
    loss = llama.forward_loss(model, torch.from_numpy(tokens), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(model.tree()))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), atol=loss_tol)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=grad_rel * np.abs(w).max())
    assert llama.param_count(model) == jllama.param_count(tree)


def test_grad_step_with_fused_apply_and_accum_matches_jax():
    """Three steps of the gradient-aggregation step, ``accum_steps=2``, with
    the fused Adam apply (the JAX side runs its Pallas kernel in interpret
    mode). The widths put embed, lm_head and the gate/up/down stacks on the
    kernel's routing (≥ 65,536 elements, a multiple of 512). Losses within
    1e-5. Parameters: every one within lr, and all but 1e-4 of them within
    1e-6, after three steps. An Adam step moves a weight by about
    −lr·g/(|g|+ε), whose slope at g ≈ 0 is lr/ε = 8e4, so where a gradient
    is as small as ε the frameworks' ~1e-10 differences in it can move that
    weight by up to lr; everywhere else they move it by far less."""
    shape = dict(vocab_size=512, dmodel=128, num_heads=2, n_layers=2,
                 ctx_size=32)
    jcfg = JaxLlamaConfig(**shape)
    tree = _jax_tree(jcfg, seed=3)
    batches = [_tokens((4, 16), 512, seed=10 + i) for i in range(3)]

    mesh = make_mesh({"data": 1})
    jopt = jpadam.FusedApplyAdam(LR, interpret=True)
    jstep = jdp.make_grad_aggregation_step(
        lambda p, b: jllama.forward_loss(p, b, jcfg), jopt, mesh,
        accum_steps=2)
    jstate = jdp.replicate(mesh, jdp.init_state(
        jax.tree.map(jnp.asarray, tree), jopt))

    cfg = LlamaConfig(**shape)
    model = params_from_jax(tree, cfg, device="cpu")
    opt = pallas_adam.FusedApplyAdam(LR)
    step = dp.make_grad_aggregation_step(
        lambda p, b: llama.forward_loss(p, b, cfg), opt, accum_steps=2)
    state = dp.init_state(model.tree(), opt)
    assert sum(pallas_adam._pallas_eligible(p, p)
               for p in tree_leaves(state.params)) == 5
    for b in batches:
        jstate, jloss = jstep(jstate, jdp.shard_batch(mesh, jnp.asarray(b)))
        state, loss = step(state, torch.from_numpy(b))
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    assert int(state.step) == int(jstate.step) == 3
    diff = np.concatenate([
        np.abs(p.detach().numpy() - np.asarray(w)).ravel() for p, w in
        zip(tree_leaves(state.params), jax.tree.leaves(jstate.params))])
    assert diff.max() <= LR
    assert (diff > 1e-6).mean() <= 1e-4
    # The model the caller holds is the trained one.
    assert tree_leaves(model.tree())[0] is tree_leaves(state.params)[0]


def test_train_llm_dp_matches_jax_for_three_steps(monkeypatch):
    """Both trainers from the same weights (the port's init patched to
    return the JAX init), the byte tokenizer's synthetic corpus, the
    default optimizer ("adam"): the three losses agree."""
    mcfg = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
    tcfg = dict(batch_size=2, seq_len=16, iters=3)
    jcfg = JaxLlamaConfig(**mcfg, vocab_size=259)
    tree = _jax_tree(jcfg, seed=0)
    jrep = jllm.train_llm_dp(JaxLlamaConfig(**mcfg), JaxTrainConfig(**tcfg),
                             tokenizer=JaxByteTokenizer(), log_every=0)
    monkeypatch.setattr(llm.llama, "init_llama",
                        lambda cfg, gen, device=None:
                        params_from_jax(tree, cfg, device))
    sunk = []
    rep = llm.train_llm_dp(LlamaConfig(**mcfg), TrainConfig(**tcfg),
                           tokenizer=ByteTokenizer(), log_every=0,
                           loss_sink=lambda i, v: sunk.append(i),
                           sink_every=2, device="cpu")
    assert rep.steps == 3 and len(rep.losses) == 3
    np.testing.assert_allclose(rep.losses, jrep.losses, atol=1e-5)
    assert sunk == [0, 2]
    assert rep.tokens_per_sec > 0


def test_guard_nonfinite_skips_the_step():
    cfg = LlamaConfig(**SMALL)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    opt = pallas_adam.FusedApplyAdam(LR)
    calls = []

    def loss_fn(p, b):
        loss = llama.forward_loss(p, b, cfg)
        calls.append(1)
        return loss * (float("nan") if len(calls) == 2 else 1.0)

    step = dp.make_grad_aggregation_step(loss_fn, opt, guard_nonfinite=True)
    state = dp.init_state(model.tree(), opt)
    tokens = torch.from_numpy(_tokens((2, 8), 64, seed=2))
    state, _ = step(state, tokens)
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    state, loss = step(state, tokens)
    assert not torch.isfinite(loss) and int(state.step) == 1
    assert int(state.opt_state.count) == 1
    for p, q in zip(tree_leaves(state.params), before):
        assert torch.equal(p, q)
    state, loss = step(state, tokens)
    assert torch.isfinite(loss) and int(state.step) == 2


@pytest.mark.parametrize("field,value", [("seq", 2)])
def test_train_llm_dp_names_roadmap_for_what_it_does_not_run(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llm.train_llm_dp(LlamaConfig(**SMALL),
                         TrainConfig(**{field: value}), device="cpu")


@functools.lru_cache(maxsize=None)
def _dp_run(field=None, value=None):
    cfg = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
    extra = {} if field is None else {field: value}
    return llm.train_llm_dp(LlamaConfig(**cfg),
                            TrainConfig(iters=2, batch_size=2, seq_len=16,
                                        **extra),
                            tokenizer=ByteTokenizer(), log_every=0,
                            device="cpu").losses


@pytest.mark.parametrize("field,value", [
    ("stage", 2), ("model", 2), ("psa", "ag")])
def test_train_llm_dp_ignores_stage_as_the_jax_trainer_does(field, value):
    """The JAX DP trainer builds a ``data``-only mesh and reads ``stage``,
    ``model`` and ``psa`` nowhere (``train_llm_pp`` runs pipelines,
    ``train_llm_tp`` tensor parallelism): so does the port's."""
    runs = [_dp_run(), _dp_run(field, value)]
    assert runs[0] == runs[1] and len(runs[0]) == 2


def test_eval_llm_reports_a_finite_loss():
    cfg = LlamaConfig(dmodel=32, num_heads=2, n_layers=1, ctx_size=16,
                      vocab_size=259)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    out = llm.eval_llm(model, cfg, n_batches=2, batch_size=2,
                       tokenizer=ByteTokenizer())
    assert np.isfinite(out["loss"]) and out["n_tokens"] == 2 * 2 * 15
