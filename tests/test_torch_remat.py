"""Activation rematerialization (``LlamaConfig.remat`` / ``TrainConfig.remat``:
each block under ``torch.utils.checkpoint``) on the CPU at a small size.

The recomputed forward repeats the same operations on the same inputs, so
the loss and every gradient leaf equal the plain path's within 1e-6 (and
are in fact bitwise equal here); against the JAX package's
``jax.checkpoint`` path at the tolerances of ``test_torch_train.py``
(fp32: loss 1e-5, gradients 1e-4 of each leaf's largest entry). The
backward runs each block's forward a second time: on the card that is the
flash forward kernel twice per layer (``chip_smoke.py`` phase 12f)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu_torch import bench_utils
from ddl25spring_tpu_torch.config import LlamaConfig, TrainConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=32)
TREE = jax.tree.map(np.asarray, jllama.init_llama(
    jax.random.PRNGKey(0), JaxLlamaConfig(**SMALL)))
TOKENS = np.random.default_rng(1).integers(0, 64, (2, 24))


def _loss_and_grads(cfg):
    model = params_from_jax(TREE, cfg, "cpu")
    leaves = tree_leaves(model.tree())
    loss = llama.forward_loss(model, torch.from_numpy(TOKENS), cfg)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_equal_the_plain_path(dtype):
    cfg = LlamaConfig(**SMALL, dtype=dtype)
    l0, g0 = _loss_and_grads(cfg)
    l1, g1 = _loss_and_grads(cfg.replace(remat=True))
    assert abs(l0.item() - l1.item()) <= 1e-6
    for a, b in zip(g0, g1):
        assert float((a.float() - b.float()).abs().max()) <= 1e-6
    assert l0.item() == l1.item() and all(torch.equal(a, b)
                                          for a, b in zip(g0, g1))


def test_remat_matches_the_jax_checkpoint_path():
    jcfg = JaxLlamaConfig(**SMALL, remat=True)
    jloss, jgrads = jax.value_and_grad(jllama.forward_loss)(
        jax.tree.map(jnp.asarray, TREE), jnp.asarray(TOKENS), jcfg)
    loss, grads = _loss_and_grads(LlamaConfig(**SMALL, remat=True))
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for a, b in zip(grads, jax.tree.leaves(jgrads)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * float(
            np.abs(b).max())


def test_remat_runs_each_block_forward_twice(monkeypatch):
    calls = []
    real = llama.block_apply

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(llama, "block_apply", counting)
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        _loss_and_grads(LlamaConfig(**SMALL, remat=remat))
        assert len(calls) == want, remat
    calls.clear()
    with torch.no_grad():
        llama.forward_loss(params_from_jax(TREE, LlamaConfig(**SMALL),
                                           "cpu"),
                           torch.from_numpy(TOKENS),
                           LlamaConfig(**SMALL, remat=True))
    assert len(calls) == 2          # nothing to recompute without autograd


@pytest.mark.parametrize("field", ["train_cfg", "model_cfg"])
def test_trainer_remat_keeps_the_losses(field):
    mcfg = dict(dmodel=32, num_heads=2, n_layers=2, ctx_size=16)
    tcfg = dict(iters=3, batch_size=2, seq_len=16)
    plain = llm.train_llm_dp(LlamaConfig(**mcfg), TrainConfig(**tcfg),
                             tokenizer=ByteTokenizer(), log_every=0,
                             device="cpu")
    if field == "train_cfg":
        m, t = LlamaConfig(**mcfg), TrainConfig(**tcfg, remat=True)
    else:
        m, t = LlamaConfig(**mcfg, remat=True), TrainConfig(**tcfg)
    remat = llm.train_llm_dp(m, t, tokenizer=ByteTokenizer(), log_every=0,
                             device="cpu")
    np.testing.assert_allclose(remat.losses, plain.losses, rtol=0, atol=1e-6)


def test_build_train_step_takes_remat():
    cfg = LlamaConfig(**SMALL)
    out = []
    for c in (cfg, cfg.replace(remat=True)):
        state, step, tokens = bench_utils.build_train_step(c, 2,
                                                           device="cpu")
        state, loss = step(state, tokens)
        out.append((loss.item(), [p.clone() for p in
                                  tree_leaves(state.params)]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
