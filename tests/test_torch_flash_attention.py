"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas flash attention in interpret mode: outputs and the per-row
log-sum-exp the forward keeps, in both operand layouts, at ragged lengths
and two head dims. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``."""

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


def test_backward_is_not_ported_and_says_where_it_is_queued():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa._FlashAttnFwd.backward(None, torch.zeros(1))


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
