"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas flash attention in interpret mode: outputs and the per-row
log-sum-exp the forward keeps, and the gradients of q, k and v, in both
operand layouts, at ragged lengths, causal or not. The plain version of
the backward kernels is held against autograd. The CUDA kernels themselves
are held against their plain versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.ops import flash_attention as jfa
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# fp32 throughout; the two sides sum in different orders (blocked online
# softmax vs one dense softmax), which moves the last few bits.
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(t: int, dh: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, t, 3, dh)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dh", [48, 32])
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("dh_major", [False, True])
def test_matches_jax_pallas_out_and_lse(dh_major, t, dh):
    q, k, v = _qkv(t, dh, seed=t + dh)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(jfa.flash_attention(jq, jk, jv, causal=True,
                                          interpret=True, dh_major=dh_major))
    # The JAX forward's residual lse: [BH, T_pad, 1] row-major or
    # [BH, 1, T_pad] dh-major, padded to the block size.
    if dh_major:
        _, res = jfa._flash_t_fwd(jq, jk, jv, True, 128, 128, True)
        want_lse = np.asarray(res[4])[:, 0, :t]
    else:
        _, res = jfa._flash_fwd(jq, jk, jv, True, 128, 128, True)
        want_lse = np.asarray(res[4])[:, :t, 0]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True, dh_major=dh_major)
    _, lse = fa.flash_attention_reference(tq, tk, tv, causal=True)
    assert got.shape == (2, t, 3, dh)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


def test_non_causal_matches_jax_pallas():
    q, k, v = _qkv(100, 48, seed=7)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=False, interpret=True))
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(64, 48, seed=1))
    before = fa.launches
    got = fa.flash_attention(q, k, v, dh_major=True)
    assert torch.equal(got, fa.flash_attention_reference(q, k, v)[0])
    assert fa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """No silent fallback: the kernel path raises for tensors off CUDA."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(64, 48, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)


# Gradients: the JAX side runs the Pallas dQ and dK/dV kernels in interpret
# mode (blocked, padded to 128) and the port autograd through one dense
# softmax, both fp32; the sums differ in order.
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("dh_major", [False, True])
def test_grads_match_jax_pallas_backward(dh_major, t, causal):
    q, k, v = _qkv(t, 48, seed=3 * t + causal)
    cot = np.random.default_rng(t).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                  dh_major=dh_major)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, dh_major=dh_major)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_reference_matches_autograd(causal, dtype):
    """The backward kernels' plain version (P from the saved lse, Δ, dS)
    equals autograd through the plain forward: 1e-5 in fp32; in bf16 both
    round the same fp32 gradients once, so one bf16 step (2^-8 relative)."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in _qkv(100, 48, seed=11))
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        out.shape).astype(np.float32)).to(dtype)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = fa.flash_attention_bwd_reference(q.detach(), k.detach(),
                                           v.detach(), out.detach(), lse,
                                           do, causal=causal)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=1e-2))
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """No silent fallback: the dQ and dK/dV launch raises off CUDA."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(64, 48, seed=4))
    out, lse = fa.flash_attention_reference(q, k, v)
    q4, k4, v4, _ = fa.kernel_operands(q, k, v, dh_major=True)
    before = (fa.dq_launches, fa.dkv_launches)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q4, k4, v4, out, lse, torch.ones_like(out))
    assert (fa.dq_launches, fa.dkv_launches) == before


def test_rejects_mismatched_operands():
    q, k, _ = (torch.from_numpy(x) for x in _qkv(64, 48, seed=3))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, k, k[:, :32])
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, k.double(), k)


def test_pallas_attention_impl_raises_on_cpu_tensors():
    cfg = LlamaConfig(vocab_size=32, dmodel=96, num_heads=2, n_layers=1,
                      attention_impl="pallas")
    model = llama.init_llama(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with torch.inference_mode(), pytest.raises(RuntimeError, match="CUDA"):
        llama.forward(model, torch.zeros(1, 8, dtype=torch.long), cfg)
