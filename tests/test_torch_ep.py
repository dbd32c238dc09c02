"""The port's expert parallelism (``parallel/ep.py``) against the JAX
package's on the CPU mesh, at ``tests/test_moe_ep.py``'s sizes (vocab 128,
dmodel 32, 4 heads, 2 layers, ctx 32, 4 experts, top-2, capacity factor
2), on the same weights (a JAX ``init_moe_llama`` tree) and the same numpy
tokens.

The port's ranks are four processes joined by gloo, one launch for the
module (``programs.ep_cases``): ``expert_mesh(1, 4)``, each data row of
``expert_mesh(2, 2)`` on its own (expert 2), and ``data=2 × expert=2``.
Held: ``ep_forward`` at expert 2 and 4 within 1e-5 of JAX's logits and
aux (JAX's own bar is 2e-4 against the unsharded forward); one SGD step
at expert 4 and at data 2 × expert 2 against JAX's on the same mesh:
loss within 1e-5, every merged leaf
within JAX's bars (atol 2e-5, rtol 2e-4), the replicated leaves bitwise
across the ranks, and the comm profile by label JAX's to the byte (one
``ep_replicated_grads`` psum per replicated leaf; the combine's in-model
sum unrecorded); the expert-4 step under ``remat=True`` bitwise the plain
step (losses, parameters, comm by label; one thread)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import MoEConfig as JaxMoEConfig
from ddl25spring_tpu.models import moe as jmoe
from ddl25spring_tpu.parallel import ep as jep
from ddl25spring_tpu.parallel import make_mesh
from ddl25spring_tpu.telemetry.comm import measure_comm as jmeasure_comm
from ddl25spring_tpu_torch.parallel import distributed, ep, programs
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

BASE = dict(vocab_size=128, dmodel=32, num_heads=4, n_layers=2, ctx_size=32)
MOE = dict(n_experts=4, top_k=2, capacity_factor=2.0)
B = 4                                         # batch per data row
LR = 0.1
# name -> (data, expert, each data row on its own)
MESHES = {"e4": (1, 4, False), "e2": (2, 2, True), "d2e2": (2, 2, False)}


def _jcfg():
    return JaxMoEConfig(base=JaxLlamaConfig(**BASE), **MOE)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jmoe.init_moe_llama(jax.random.key(0),
                                                        _jcfg()))


def _tokens(data, seed=1):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], (1, data * B, BASE["ctx_size"]))


def _base(name):
    d, n, row = MESHES[name]
    return dict(axis="expert", data=d, size=n, row=row,
                cfg=dict(BASE, attention_impl="xla"), moe=MOE,
                params=_params())


@functools.lru_cache(maxsize=None)
def _cases():
    cases = {}
    for name in ("e4", "e2"):
        cases[("forward", name)] = dict(_base(name), run="forward",
                                        batches=_tokens(1))
    for name in ("e4", "d2e2"):
        cases[("step", name)] = dict(_base(name), run="step",
                                     optimizer="sgd", lr=LR,
                                     batches=_tokens(MESHES[name][0]))
    cases[("step-remat", "e4")] = dict(
        cases[("step", "e4")], cfg=dict(BASE, attention_impl="xla",
                                        remat=True))
    return cases


_LAUNCHED = {}


def _results():
    """The module's one launch, made on first use: ``{case key: every
    rank's result}``."""
    if not _LAUNCHED:
        cases = _cases()
        ranks = distributed.run_ranks(programs.ep_cases, 4,
                                      list(cases.values()), device="cpu",
                                      timeout=300)
        _LAUNCHED.update({key: [r[i] for r in ranks]
                          for i, key in enumerate(cases)})
    return _LAUNCHED


def _jmesh(name):
    d, n, row = MESHES[name]
    if row or d == 1:
        return make_mesh({"expert": n}, devices=jax.devices()[:n])
    return make_mesh({"data": d, "expert": n}, devices=jax.devices()[:d * n])


@pytest.mark.parametrize("name", ["e4", "e2"])
def test_ep_forward_matches_jax(name):
    mesh = _jmesh(name)
    toks = _tokens(1)[0]
    logits, aux = jep.ep_forward(jep.shard_params(mesh, _params()), toks,
                                 _jcfg(), mesh)
    for r in _results()[("forward", name)]:
        np.testing.assert_allclose(r["logits"], np.asarray(logits),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["aux"], float(aux), atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """JAX's one SGD step: (loss, params leaves, comm by label)."""
    mesh = _jmesh(name)
    opt = optax.sgd(LR)
    step = jep.make_ep_train_step(_jcfg(), opt, mesh)
    d = MESHES[name][0]
    comm = jmeasure_comm(step, jep.init_state(mesh, _params(), opt),
                         jax.ShapeDtypeStruct((d * B, BASE["ctx_size"]),
                                              jnp.int32)).by_label()
    state, loss = step(jep.init_state(mesh, _params(), opt),
                       jep.shard_batch(mesh, _tokens(d)[0]))
    return (float(loss), jax.tree.leaves(jax.device_get(state.params)),
            comm)


def _merged(ranks):
    """The whole tree of data row 0: the expert leaves concatenated over
    the expert shards in order, the rest rank 0's."""
    row = sorted((r for r in ranks if r["d"] == 0), key=lambda r: r["i"])
    specs = tree_leaves(ep.param_specs(row[0]["params"]))
    per = [tree_leaves(r["params"]) for r in row]
    return [np.concatenate([p[j] for p in per], axis=1) if s is not None
            else per[0][j] for j, s in enumerate(specs)]


def _by_label(comm):
    return {k: (v["calls"], v["payload_bytes"]) for k, v in comm.items()}


@pytest.mark.parametrize("name", ["e4", "d2e2"])
def test_ep_step_matches_jax(name):
    loss, leaves, comm = _jax_step(name)
    ranks = _results()[("step", name)]
    specs = tree_leaves(ep.param_specs(ranks[0]["params"]))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], [loss], atol=1e-5, rtol=0)
        assert _by_label(r["comm"]) == _by_label(comm)
        for a, b, s in zip(tree_leaves(r["params"]),
                           tree_leaves(ranks[0]["params"]), specs):
            if s is None:
                np.testing.assert_array_equal(a, b)
    assert "ep_replicated_grads" in comm
    for a, b in zip(_merged(ranks), leaves):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-4)


def test_ep_step_under_remat_is_bitwise_the_plain_step():
    """The expert-4 step under ``remat=True``: losses, parameters and comm
    by label bitwise the plain step's (one thread)."""
    plain = _results()[("step", "e4")]
    remat = _results()[("step-remat", "e4")]
    for p, r in zip(plain, remat):
        assert r["losses"] == p["losses"]
        assert _by_label(r["comm"]) == _by_label(p["comm"])
        for a, b in zip(tree_leaves(r["params"]), tree_leaves(p["params"])):
            np.testing.assert_array_equal(a, b)
