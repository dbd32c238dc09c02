"""The port's bridge: the JAX ``init_llama`` tree crosses into
``ddl25spring_tpu_torch`` name for name and comes back bitwise, and so do
the Adam optimizer states (JAX's ``FusedAdamState`` and optax's), from
which both packages resume to the same next step."""

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


def _adam_states(steps=2):
    """JAX Adam states after ``steps`` updates on seeded gradients: the
    fused rule's ``FusedAdamState`` and optax adam's chain state."""
    import optax
    from ddl25spring_tpu.ops.adam import fused_adam
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 6)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    out = {}
    for name, opt in (("fused", fused_adam(1e-3)), ("optax", optax.adam(1e-3))):
        p, s = params, opt.init(params)
        for i in range(steps):
            g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
                np.float32), params)
            u, s = opt.update(g, s, p)
            p = optax.apply_updates(p, u)
        out[name] = (jax.tree.map(np.asarray, p), s)
    return out


@pytest.mark.parametrize("kind", ["fused", "optax"])
def test_adam_state_round_trips_name_for_name(kind):
    from ddl25spring_tpu_torch.convert import (opt_state_from_jax,
                                               opt_state_to_numpy)
    _, jstate = _adam_states()[kind]
    fields = jstate if kind == "fused" else jstate[0]
    state = opt_state_from_jax(jstate, device="cpu")
    assert state.count.dtype == torch.int32 and int(state.count) == 2
    back = opt_state_to_numpy(state)
    assert back.count.dtype == np.int32 and int(back.count) == 2
    for name in ("mu", "nu"):
        want, got = _paths(getattr(fields, name)), _paths(getattr(back, name))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_resume_from_the_same_jax_state_gives_the_same_next_step():
    """Both packages continue from one JAX (params, FusedAdamState) on the
    same gradient: the third update agrees to float re-association."""
    from ddl25spring_tpu.ops.adam import fused_adam as jfused_adam
    from ddl25spring_tpu_torch.convert import opt_state_from_jax
    from ddl25spring_tpu_torch.ops.adam import apply_optimizer, fused_adam
    import optax
    params, jstate = _adam_states()["fused"]
    g = jax.tree.map(lambda x: np.full(x.shape, 0.3, np.float32), params)
    u, jnext = jfused_adam(1e-3).update(g, jstate, params)
    want = optax.apply_updates(params, u)
    tparams = {"a": torch.from_numpy(params["a"].copy()),
               "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    tg = {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(g["b"]["c"])}}
    got, state = apply_optimizer(fused_adam(1e-3), tg,
                                 opt_state_from_jax(jstate, device="cpu"),
                                 tparams)
    assert int(state.count) == int(jnext.count) == 3
    for k, x in _paths(want).items():
        np.testing.assert_allclose(_paths(got)[k].numpy(), np.asarray(x),
                                   atol=1e-7, rtol=1e-6)
