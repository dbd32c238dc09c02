"""The port's tiny-Llama forward against the JAX package's, on the JAX
init's weights: full logits with the plain attention on both sides, with
the JAX Pallas flash kernel (interpret mode) in either layout, with
``padding_idx``, and the building blocks one by one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu import nn as jnn
from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu_torch import nn
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, dmodel=96, num_heads=2, n_layers=2, ctx_size=64)
# fp32 on both sides; matmul and softmax summation orders differ between
# XLA and PyTorch's CPU kernels.
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(**kw):
    jcfg = JaxLlamaConfig(**SMALL, **kw)
    cfg = LlamaConfig(**SMALL, **kw)
    jp = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, model


def _tokens(b=2, t=64, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _port_logits(model, toks, cfg):
    with torch.inference_mode():
        return llama.forward(model, torch.from_numpy(toks), cfg).numpy()


@pytest.mark.parametrize("jax_impl,dh_major", [("xla", True),
                                               ("pallas", False),
                                               ("pallas", True)])
def test_forward_matches_jax(jax_impl, dh_major):
    jcfg, jp, cfg, model = _pair(attention_impl="xla")
    toks = _tokens()
    want = np.asarray(jllama.forward(
        jp, jnp.asarray(toks),
        jcfg.replace(attention_impl=jax_impl, flash_dh_major=dh_major)))
    got = _port_logits(model, toks, cfg)
    assert got.dtype == np.float32 and got.shape == (2, 64, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_auto_on_cpu_takes_the_plain_path():
    """``auto`` picks the kernel only for CUDA tensors: on the CPU, even
    past ``flash_min_seq``, it is the plain attention, bit for bit."""
    _, _, cfg, model = _pair()
    toks = _tokens(t=32)
    auto = _port_logits(model, toks, cfg.replace(attention_impl="auto",
                                                 flash_min_seq=16))
    plain = _port_logits(model, toks, cfg.replace(attention_impl="xla"))
    np.testing.assert_array_equal(auto, plain)


def test_padding_idx_matches_jax_and_zeroes_pad_rows():
    jcfg, jp, cfg, model = _pair(padding_idx=0, attention_impl="xla")
    toks = _tokens(seed=4)
    toks[:, ::5] = 0
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(_port_logits(model, toks, cfg), want, **TOL)
    with torch.inference_mode():
        h = llama.embed(model.tree(), torch.from_numpy(toks), cfg)
    assert float(h[:, ::5].abs().max()) == 0.0


def test_module_call_is_forward():
    _, _, cfg, model = _pair(attention_impl="xla")
    toks = torch.from_numpy(_tokens(t=16))
    with torch.inference_mode():
        assert torch.equal(model(toks), llama.forward(model, toks, cfg))


def test_positions_offset_matches_jax():
    """Absolute positions (the sequence-parallel hook) move RoPE the same
    way on both sides."""
    jcfg, jp, cfg, model = _pair(attention_impl="xla")
    toks = _tokens(t=16, seed=2)
    pos = np.arange(16) + 7
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg,
                                     positions=jnp.asarray(pos)))
    with torch.inference_mode():
        got = llama.forward(model, torch.from_numpy(toks), cfg,
                            positions=torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _piece(name, rng):
    """(port output, JAX output) of one building block on random input."""
    x = rng.standard_normal((2, 8, 96)).astype(np.float32)
    if name == "rmsnorm":
        scale = rng.standard_normal(96).astype(np.float32)
        return (nn.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)).numpy(),
                jnn.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    if name == "rope":
        xh = x.reshape(2, 8, 2, 48)
        pos = np.arange(3, 11)
        c, s = llama.rope_angles(torch.from_numpy(pos), 48, 10000.0)
        jc, js = jllama.rope_angles(jnp.asarray(pos), 48, 10000.0)
        return (llama.apply_rope(torch.from_numpy(xh), c, s).numpy(),
                jllama.apply_rope(jnp.asarray(xh), jc, js))
    jcfg, jp, cfg, model = _pair()
    block = llama.layer(model.tree()["blocks"], 1)
    jblock = jax.tree.map(lambda a: a[1], jp["blocks"])
    with torch.inference_mode():
        if name == "mlp":
            return (llama.mlp(block, torch.from_numpy(x)).numpy(),
                    jllama.mlp(jblock, jnp.asarray(x)))
        q, k, v = (rng.standard_normal((2, 8, 2, 48)).astype(np.float32)
                   for _ in range(3))
        return (llama._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=True).numpy(),
                jllama._xla_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=True))


@pytest.mark.parametrize("name", ["rmsnorm", "rope", "mlp", "attention"])
def test_building_blocks_match_jax(name):
    got, want = _piece(name, np.random.default_rng(11))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
