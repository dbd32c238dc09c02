"""The port's parameter bridge: the JAX ``init_llama`` tree crosses into
``ddl25spring_tpu_torch`` name for name and comes back bitwise."""

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax, params_to_numpy
from ddl25spring_tpu_torch.models import llama

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, dmodel=96, num_heads=2, n_layers=2, ctx_size=64)


def _jax_tree(**kw):
    cfg = JaxLlamaConfig(**{**SMALL, **kw})
    return jax.tree.map(np.asarray, jllama.init_llama(jax.random.PRNGKey(0),
                                                      cfg))


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_jax_tree_round_trips_bitwise(param_dtype):
    tree = _jax_tree(param_dtype=param_dtype)
    cfg = LlamaConfig(**SMALL, param_dtype=param_dtype)
    model = params_from_jax(tree, cfg, device="cpu")
    back = _paths(params_to_numpy(model))
    want = _paths(tree)
    assert back.keys() == want.keys()
    params = dict(model.named_parameters())
    for name, x in want.items():
        # numpy has no bf16: those leaves come back as their exact fp32 value.
        np.testing.assert_array_equal(back[name], x.astype(back[name].dtype),
                                      err_msg=name)
        assert params[name].dtype == getattr(torch, param_dtype), name


def test_module_names_are_the_jax_paths():
    tree = _jax_tree()
    model = params_from_jax(tree, LlamaConfig(**SMALL), device="cpu")
    assert set(model.state_dict()) == set(_paths(tree))
    # tree() is a view of the module's own parameters, not a copy.
    params = dict(model.named_parameters())
    for name, leaf in _paths(model.tree()).items():
        assert leaf is params[name]


def test_params_from_jax_rejects_a_tree_of_another_config():
    tree = _jax_tree()
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, LlamaConfig(**{**SMALL, "n_layers": 3}),
                        device="cpu")
    broken = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(broken, LlamaConfig(**SMALL), device="cpu")


def test_init_llama_has_the_jax_layout_and_is_seeded():
    cfg = LlamaConfig(**SMALL, padding_idx=3)
    a = llama.init_llama(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = llama.init_llama(cfg, torch.Generator().manual_seed(5), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in _paths(_jax_tree()).items()}
    got = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert got == shapes
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    sd = a.state_dict()
    assert float(sd["embed"][3].abs().max()) == 0.0      # padding row
    assert abs(float(sd["blocks.wq"].std()) - 0.02) < 2e-3
    assert float(sd["final_norm.scale"].min()) == 1.0
