"""The port's losses (``ops/losses.py``) against the JAX package's on the
same numpy inputs: the fused linear cross-entropy's value and gradients
with a row count that is not a multiple of the 512-row chunk, with and
without a mask, fused against unfused, and one bf16 case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.ops import losses as jlosses
from ddl25spring_tpu_torch.ops import losses

torch.set_num_threads(1)

# fp32: the two sides reduce the [chunk, V] tiles in different orders.
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(n=700, d=32, v=50, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, v))).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    mask = (rng.random(n) > 0.3).astype(np.float32) if masked else None
    return h, w, labels, mask


@pytest.mark.parametrize("masked", [False, True])
def test_fused_linear_ce_value_and_grads_match_jax(masked):
    h, w, labels, mask = _inputs(masked=masked)
    jmask = None if mask is None else jnp.asarray(mask)
    want, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jlosses.fused_linear_cross_entropy(
            h, w, jnp.asarray(labels), jmask), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    got = losses.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("ignore_index", [None, 3])
def test_fused_equals_unfused_causal_lm_loss(ignore_index):
    """Fused head (chunked, no logits) vs logits → ``causal_lm_loss``, in
    the port, and the unfused loss vs JAX's ``causal_lm_loss``."""
    rng = np.random.default_rng(1)
    b, t, d, v = 3, 37, 16, 11
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    tokens = rng.integers(0, v, (b, t))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tt = torch.from_numpy(tokens)
    unfused = losses.causal_lm_loss(th @ tw, tt, ignore_index=ignore_index)
    g_unfused = torch.autograd.grad(unfused, (th, tw))
    labels = tt[:, 1:].reshape(-1)
    mask = None if ignore_index is None else (labels != ignore_index)
    fused = losses.fused_linear_cross_entropy(
        th[:, :-1].reshape(-1, d), tw, labels, mask, chunk_size=16)
    g_fused = torch.autograd.grad(fused, (th, tw))
    np.testing.assert_allclose(fused.item(), unfused.item(), **TOL)
    for a, c in zip(g_fused, g_unfused):
        np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)
    want = jlosses.causal_lm_loss(jnp.asarray(h @ w), jnp.asarray(tokens),
                                  ignore_index=ignore_index)
    np.testing.assert_allclose(unfused.item(), float(want), **TOL)


def test_fused_linear_ce_bf16_matches_jax_loosely():
    """bf16 activations and weights: logits in fp32 from the bf16 values
    on both sides; the gradients come back in bf16 before the weight's is
    upcast, so they agree to a few bf16 roundings (2^-8 relative each)."""
    h, w, labels, _ = _inputs(n=600, seed=2)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    want, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jlosses.fused_linear_cross_entropy(
            h, w, jnp.asarray(labels)), argnums=(0, 1))(jh, jnp.asarray(w))
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = losses.fused_linear_cross_entropy(th, tw,
                                            torch.from_numpy(labels))
    got.backward()
    assert th.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    scale_h = float(np.abs(np.asarray(jdh, np.float32)).max())
    scale_w = float(np.abs(np.asarray(jdw)).max())
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(jdh, np.float32),
                               atol=2e-2 * scale_h)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               atol=2e-2 * scale_w)
