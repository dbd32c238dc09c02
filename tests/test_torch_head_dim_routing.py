"""Heads wider than the CUDA flash kernels take: the port's routing by head
dim. ``"auto"`` takes the kernels only where they accept the shape
(``1 <= Dh <= flash_attention.MAX_HEAD_DIM``), so a Dh=144 model runs the
plain attention there, as the JAX package's ``"auto"`` runs its plain path
off a TPU; ``"pallas"`` raises, naming the limit. The CPU runs no kernel:
the rule is checked with a CUDA flag, and the Dh=144 forward against JAX's
on the CPU (``chip_smoke.py`` runs it on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# dmodel 288 over 2 heads: Dh = 144, past the kernels' 128.
WIDE = dict(vocab_size=128, dmodel=288, num_heads=2, n_layers=2, ctx_size=64)
# fp32 on both sides; matmul and softmax summation orders differ between
# XLA and PyTorch's CPU kernels (tests/test_torch_llama.py's limit).
TOL = dict(atol=1e-4, rtol=1e-4)


def test_the_limit_is_128():
    assert fa.MAX_HEAD_DIM == 128
    assert [fa.kernel_takes(d) for d in (0, 1, 48, 128, 129, 144)] == [
        False, True, True, True, False, False]


@pytest.mark.parametrize("dmodel,heads,takes", [
    (96, 2, True),      # Dh 48, the canonical head
    (256, 2, True),     # Dh 128, the widest the kernels take
    (258, 2, False),    # Dh 129
    (288, 2, False),    # Dh 144
])
def test_auto_takes_the_kernels_only_for_heads_they_take(dmodel, heads,
                                                         takes):
    cfg = LlamaConfig(dmodel=dmodel, num_heads=heads, attention_impl="auto")
    assert llama.use_flash(cfg, True, cfg.flash_min_seq) is takes
    # Below flash_min_seq, and off CUDA, "auto" is the plain path at any head.
    assert llama.use_flash(cfg, True, cfg.flash_min_seq - 1) is False
    assert llama.use_flash(cfg, False, cfg.flash_min_seq) is False
    # "xla" never takes the kernels.
    assert llama.use_flash(cfg.replace(attention_impl="xla"), True,
                           cfg.flash_min_seq) is False


def test_pallas_takes_the_kernels_for_heads_they_take():
    cfg = LlamaConfig(attention_impl="pallas")
    assert llama.use_flash(cfg, True, 8) is True
    assert llama.use_flash(cfg.replace(dmodel=256, num_heads=2), True, 8)


def test_pallas_raises_for_a_wide_head_naming_the_limit():
    cfg = LlamaConfig(**WIDE, attention_impl="pallas")
    with pytest.raises(ValueError, match=r"head dims 1\.\.128.* 144"):
        llama.use_flash(cfg, True, 256)
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with torch.inference_mode(), pytest.raises(ValueError, match="128"):
        llama.forward(model, torch.zeros(1, 8, dtype=torch.long), cfg)


def test_kernel_wrappers_refuse_a_wide_head_by_the_limit():
    q = torch.zeros(1, 8, 2, 144)
    with pytest.raises(ValueError, match=r"1\.\.128 \(MAX_HEAD_DIM\), got 144"):
        fa.flash_attention_fwd(q, q, q)
    q4 = q.permute(0, 2, 1, 3)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match=r"1\.\.128 \(MAX_HEAD_DIM\), got 144"):
        fa._launch_bwd("ddl_flash_bwd_dq", (q4, q4, q4, q4), (q4,), lse, lse,
                       causal=True)


@pytest.mark.parametrize("jax_impl", ["auto", "xla"])
def test_wide_head_auto_forward_matches_jax(jax_impl):
    """The Dh=144 model under "auto" (the plain path, on the CPU as on the
    card) against the JAX package's forward under "auto" and "xla" on the
    JAX init's weights."""
    jcfg = JaxLlamaConfig(**WIDE, attention_impl=jax_impl)
    cfg = LlamaConfig(**WIDE, attention_impl="auto", flash_min_seq=16)
    assert cfg.head_dim == 144
    jp = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, 128, (2, 64))
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg))
    before = fa.launches
    with torch.inference_mode():
        got = llama.forward(model, torch.from_numpy(toks), cfg).numpy()
    assert fa.launches == before
    assert got.shape == (2, 64, 128) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
