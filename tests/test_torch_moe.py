"""The port's MoE model (``models/moe.py``) against the JAX package's on
the CPU, at ``tests/test_moe_ep.py``'s sizes (vocab 128, dmodel 32, 4
heads, 2 layers, ctx 32, 4 experts), on the same weights (a JAX
``init_moe_llama`` tree through ``convert.moe_params_from_jax``) and the
same numpy inputs. Held: ``route`` against JAX's (dispatch exactly,
combine within 1e-7, aux within 1e-6 relative) on random logits, on
constructed ties (``lax.top_k`` breaks them by the lowest index), on
bf16-rounded logits (where ties are common) and on a batch that overflows
the capacity; ``moe_mlp`` and ``forward`` (logits and aux) within 1e-5;
the weight bridge's shape check and round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.config import MoEConfig as JaxMoEConfig
from ddl25spring_tpu.models import moe as jmoe
from ddl25spring_tpu_torch import convert
from ddl25spring_tpu_torch.config import LlamaConfig, MoEConfig
from ddl25spring_tpu_torch.models import llama, moe
from ddl25spring_tpu_torch.tree import tree_leaves

torch.set_num_threads(1)

BASE = dict(vocab_size=128, dmodel=32, num_heads=4, n_layers=2, ctx_size=32)


def _cfgs(**kw):
    kw = dict(dict(n_experts=4, top_k=2, capacity_factor=2.0), **kw)
    return (MoEConfig(base=LlamaConfig(attention_impl="xla", **BASE), **kw),
            JaxMoEConfig(base=JaxLlamaConfig(**BASE), **kw))


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jmoe.init_moe_llama(
        jax.random.key(0), _cfgs()[1]))


def _ties(n, e):
    """Rows whose largest entries tie: the top two of four equal (row
    kinds cycle), so the choice rests on the tie-break alone."""
    base = np.array([[1.0, 1.0, 0.0, 1.0], [0.5, 2.0, 2.0, 2.0],
                     [3.0, 3.0, 3.0, 3.0], [0.0, -1.0, 0.0, -1.0]],
                    np.float32)
    return base[np.arange(n) % 4][:, :e]


def _bf16_logits(n, e):
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((n, e)) * 0.05, dtype=torch.float32)
    return x.to(torch.bfloat16).float().numpy()


LOGITS = {
    "random": lambda n, e: np.random.default_rng(2).standard_normal(
        (n, e)).astype(np.float32),
    "ties": _ties,
    "bf16": _bf16_logits,
    "overflow": lambda n, e: np.tile(np.array([[5.0, 0.0, 1.0, 0.0]],
                                              np.float32)[:, :e], (n, 1)),
}


@pytest.mark.parametrize("kind", sorted(LOGITS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_jax(kind, top_k):
    cfg, jcfg = _cfgs(top_k=top_k, capacity_factor=1.0)
    n, e = 64, cfg.n_experts
    logits = LOGITS[kind](n, e)
    cap = moe.capacity(n, cfg)
    assert cap == jmoe.capacity(n, jcfg)
    disp, comb, aux = moe.route(torch.from_numpy(logits), cfg, cap)
    jd, jc, ja = jmoe.route(jnp.asarray(logits), jcfg, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    if kind == "overflow":              # every token's first choice is 0
        assert disp.numpy()[:, 0].sum() == cap < n


def test_top_k_breaks_ties_by_the_lowest_index():
    vals, idx = moe.top_k(torch.tensor([[1.0, 3.0, 3.0, 1.0, 3.0]]), 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


def test_moe_mlp_matches_jax():
    cfg, jcfg = _cfgs()
    params = _params()
    block = jax.tree.map(lambda x: x[0], params["blocks"])
    x = np.random.default_rng(4).standard_normal(
        (2, 8, BASE["dmodel"])).astype(np.float32)
    ours = llama.layer(convert.moe_params_from_jax(
        params, cfg, device="cpu")["blocks"], 0)
    y, aux = moe.moe_mlp(ours, torch.from_numpy(x), cfg)
    jy, jaux = jmoe.moe_mlp(block, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_matches_jax(remat):
    cfg, jcfg = _cfgs()
    cfg = cfg.replace(base=cfg.base.replace(remat=remat))
    params = convert.moe_params_from_jax(_params(), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, BASE["vocab_size"], (2, 32))
    logits, aux = moe.forward(params, torch.from_numpy(toks), cfg)
    jl, ja = jmoe.forward(_params(), jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    assert moe.param_count(params) == jmoe.param_count(_params())


def test_weight_bridge_checks_shapes_and_round_trips():
    cfg, _ = _cfgs()
    params = convert.moe_params_from_jax(_params(), cfg, device="cpu")
    back = convert.moe_params_to_numpy(params, cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(_params())):
        np.testing.assert_array_equal(a, b)
    shard = convert.moe_params_from_jax(_params(), cfg, device="cpu",
                                        expert_shard=(2, 1))
    np.testing.assert_array_equal(shard["blocks"]["w_up"].numpy(),
                                  _params()["blocks"]["w_up"][:, 2:4])
    with pytest.raises(ValueError, match="w_gate: shape"):
        convert.moe_params_from_jax(_params(), cfg.replace(n_experts=8),
                                    device="cpu")
    own = moe.init_moe_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [x.shape for x in tree_leaves(_params())]
    assert llama.as_tree(own) is own
