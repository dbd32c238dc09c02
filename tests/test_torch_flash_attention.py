"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas flash attention in interpret mode: outputs and the per-row
log-sum-exp the forward keeps, and the gradients of q, k and v, in both
operand layouts, at ragged lengths, causal or not. The plain version of
the backward kernels is held against autograd, and an emulation of the
bf16 tensor-core kernels' rounding against the Pallas kernels on bf16
inputs. The CUDA kernels themselves are held against their plain versions
on the card by ``chip_smoke.py``."""

import math

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


# The bf16 forward, dQ and dK/dV kernels round P (and dS) to bf16 before
# the tensor-core products that take them, accumulating in fp32; the plain
# versions stay fp32. The card holds the kernels to 2e-2 (out, and dq, dk,
# dv relative to the largest reference gradient) and lse to 1e-4.
BF16_TOL_OUT, BF16_TOL_LSE, BF16_TOL_GRAD = 2e-2, 1e-4, 2e-2


def _bf16_kernels_emulation(q, k, v, do, causal):
    """The bf16 kernels' arithmetic in plain PyTorch on [B, T, H, Dh] bf16
    tensors: the forward's online softmax over 64-key tiles in the log2
    domain with P rounded to bf16 before P·V, and the backward kernels' P
    (from lse) and dS rounded to bf16 before dQ = dS·K, dK = dSᵀ·Q and
    dV = Pᵀ·dO; fp32 scores, statistics and accumulators. Returns out
    (bf16), lse, dq, dk, dv (bf16)."""
    b, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    c = scale * math.log2(math.e)
    qf, kf, vf, dof = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, do))
    pos = torch.arange(t)
    m = torch.full((b, h, t), -1e30)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, dh)
    for k0 in range(0, t, 64):
        kpos = pos[k0:k0 + 64]
        vis = (kpos[None, :] <= pos[:, None]) if causal else \
            torch.ones(t, len(kpos), dtype=torch.bool)
        s = torch.where(vis, qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2) * c,
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + \
            p.bfloat16().float() @ vf[:, :, k0:k0 + 64]
        m = m_new
    out = (acc / l[..., None]).bfloat16()                   # [B, H, T, Dh]
    lse = m * math.log(2.0) + torch.log(l)                  # [B, H, T]
    delta = (dof * out.float()).sum(-1, keepdim=True)
    vis = (pos[None, :] <= pos[:, None]) if causal else \
        torch.ones(t, t, dtype=torch.bool)
    p = torch.where(vis, torch.exp2(qf @ kf.transpose(-1, -2) * c
                                    - lse[..., None] * math.log2(math.e)),
                    0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    dq = ds.bfloat16().float() @ kf
    dk = ds.bfloat16().float().transpose(-1, -2) @ qf
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    back = lambda x: x.bfloat16().permute(0, 2, 1, 3)
    return back(out), lse.reshape(b * h, t), back(dq), back(dk), back(dv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh_major", [False, True])
def test_bf16_kernel_rounding_fits_the_card_limits(dh_major, causal):
    """The tensor-core kernels' one new rounding point (P, and dS, to bf16
    before their products) against the Pallas kernels in interpret mode on
    the same bf16 inputs: out, lse, dq, dk and dv within the limits the
    card enforces."""
    rng = np.random.default_rng(17 + dh_major + 2 * causal)
    q, k, v, do = (rng.standard_normal((2, 100, 3, 48)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, interpret=True, dh_major=dh_major),
        jq, jk, jv)
    want_grads = [np.asarray(x.astype(jnp.float32)) for x in vjp(jdo)]
    fwd = jfa._flash_t_fwd if dh_major else jfa._flash_fwd
    lse_res = np.asarray(fwd(jq, jk, jv, causal, 128, 128, True)[1][4])
    want_lse = lse_res[:, 0, :100] if dh_major else lse_res[:, :100, 0]
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    got_out, got_lse, dq, dk, dv = _bf16_kernels_emulation(tq, tk, tv, tdo,
                                                           causal)
    out_err = np.abs(got_out.float().numpy()
                     - np.asarray(out.astype(jnp.float32))).max()
    assert out_err <= BF16_TOL_OUT
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=0,
                               atol=BF16_TOL_LSE)
    limit = BF16_TOL_GRAD * max(np.abs(g).max() for g in want_grads)
    for name, got, want in (("dq", dq, want_grads[0]),
                            ("dk", dk, want_grads[1]),
                            ("dv", dv, want_grads[2])):
        err = np.abs(got.float().numpy() - want).max()
        assert err <= limit, f"{name}: max|d|={err:.3g} > {limit:.3g}"
