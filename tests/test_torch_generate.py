"""The port's KV-cache decoding against the JAX package's on the JAX init's
weights: cached logits within tolerance, greedy ``generate`` token for
token; plus the port's own bars (cached decoding agrees with the full
forward at every position; sampling is reproducible from the generator)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import generate as jgen
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import generate, llama

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, dmodel=96, num_heads=2, n_layers=2, ctx_size=64)
TOL = dict(atol=1e-4, rtol=1e-4)     # fp32; XLA vs PyTorch summation order


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxLlamaConfig(**SMALL)
    cfg = LlamaConfig(**SMALL)
    jp = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, model


def test_forward_cached_matches_jax(pair):
    jcfg, jp, cfg, model = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 128, (2, 9))
    nxt = rng.integers(0, 128, (2, 1))
    jcache = jgen.init_cache(jcfg, 2, 16)
    jl1, jcache = jgen.forward_cached(jp, jnp.asarray(prompt), jcache, 0, jcfg)
    jl2, jcache = jgen.forward_cached(jp, jnp.asarray(nxt), jcache, 9, jcfg)
    with torch.inference_mode():
        cache = generate.init_cache(cfg, 2, 16, device="cpu")
        l1, cache = generate.forward_cached(model, torch.from_numpy(prompt),
                                            cache, 0, cfg)
        l2, cache = generate.forward_cached(model, torch.from_numpy(nxt),
                                            cache, 9, cfg)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **TOL)
    np.testing.assert_allclose(cache["k"][:, :, :10].numpy(),
                               np.asarray(jcache["k"][:, :, :10]), **TOL)


def test_greedy_generate_matches_jax_token_for_token(pair):
    jcfg, jp, cfg, model = pair
    prompt = np.random.default_rng(5).integers(0, 128, (2, 7))
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), jcfg, 12))
    # Precondition for a token-for-token bar across frameworks: no step of
    # the greedy path may be a near-tie (top-2 logit gap < 1e-5), where a
    # last-bit difference could legitimately flip the argmax. This seed's
    # path has none; if a change of weights or prompts lands on one, pick
    # another seed and say so here.
    full = np.concatenate([prompt, want], axis=1)
    logits = np.asarray(jllama.forward(jp, jnp.asarray(full), jcfg))
    steps = logits[:, prompt.shape[1] - 1:-1]
    top2 = np.sort(steps, axis=-1)[..., -2:]
    assert float((top2[..., 1] - top2[..., 0]).min()) > 1e-5
    got = generate.generate(model, prompt, cfg, 12, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_forward_cached_agrees_with_forward_at_every_position(pair):
    _, _, cfg, model = pair
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (1, 12)))
    with torch.inference_mode():
        full = llama.forward(model, toks, cfg)[0]
        cache = generate.init_cache(cfg, 1, 12, device="cpu")
        for i in range(12):
            logits, cache = generate.forward_cached(model, toks[:, i:i + 1],
                                                    cache, i, cfg)
            torch.testing.assert_close(logits[0], full[i], atol=1e-5,
                                       rtol=1e-5)


def test_sampling_is_reproducible_and_top_k_1_is_greedy(pair):
    _, _, cfg, model = pair
    prompt = np.arange(5)[None]

    def sample(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return generate.generate(model, prompt, cfg, 10, generator=gen,
                                 temperature=0.9, device="cpu", **kw)

    assert torch.equal(sample(3), sample(3))
    assert not torch.equal(sample(3), sample(4))
    greedy = generate.generate(model, prompt, cfg, 10, device="cpu")
    assert torch.equal(sample(3, top_k=1), greedy)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (8, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(9).standard_normal((3, 64)).astype(
        np.float32)
    want = np.asarray(jgen.filter_logits(jnp.asarray(logits), top_k, top_p))
    got = generate.filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_array_equal(got.numpy()[~np.isinf(want)],
                                  want[~np.isinf(want)])


def test_generate_validates_its_arguments(pair):
    _, _, cfg, model = pair
    prompt = np.zeros((1, 6), np.int64)
    with pytest.raises(ValueError, match="exceeds max_len=8"):
        generate.generate(model, prompt, cfg, 4, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="requires a generator"):
        generate.generate(model, prompt, cfg, 4, temperature=0.5,
                          device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate.generate(model, prompt, cfg, 0, device="cpu")


# -------------------------------------------- speculative decoding, decode rate

SPEC_PROMPT = [3, 5, 7, 2]


@pytest.fixture(scope="module")
def drafts(pair):
    """(JAX draft, port draft): a second init, JAX's
    ``tests/test_generate.py`` disagreeing draft."""
    jcfg, _, cfg, _ = pair
    jd = jllama.init_llama(jax.random.PRNGKey(9), jcfg)
    return jd, params_from_jax(jax.tree.map(np.asarray, jd), cfg,
                               device="cpu")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("draft", ["same", "other"])
def test_speculative_stream_is_greedy_generate_and_jax(pair, drafts, k,
                                                       draft):
    """Tokens bitwise the port's greedy ``generate`` for a same-weights and
    a disagreeing draft; tokens and stats equal JAX's
    ``speculative_stream``."""
    jcfg, jp, cfg, model = pair
    jd, pd = drafts if draft == "other" else (jp, model)
    want = generate.generate(model, np.asarray([SPEC_PROMPT]), cfg, 7,
                             device="cpu")[0].tolist()
    got, stats = generate.speculative_stream(model, pd, SPEC_PROMPT, cfg, 7,
                                             k=k, device="cpu")
    assert got == want
    assert 0 <= stats["accepted"] <= stats["proposed"] and stats["rounds"]
    jgot, jstats = jgen.speculative_stream(jp, jd, SPEC_PROMPT, jcfg, 7, k=k)
    assert got == jgot
    assert stats == jstats
    if draft == "same":
        assert stats["accepted"] == stats["proposed"] > 0


@pytest.mark.parametrize("max_new", [7, 6])
def test_speculative_horizon_never_reads_as_rejection(pair, max_new):
    _, _, cfg, model = pair
    _, stats = generate.speculative_stream(model, model, SPEC_PROMPT, cfg,
                                           max_new, k=3, device="cpu")
    assert stats["accepted"] == stats["proposed"] > 0


def test_time_decode_gives_a_finite_rate_on_the_cpu():
    from ddl25spring_tpu_torch.bench_utils import time_decode
    cfg = LlamaConfig(vocab_size=64, dmodel=32, num_heads=2, n_layers=1,
                      ctx_size=32)
    for bf16, kv in ((False, None), (True, "bfloat16")):
        rate = time_decode(cfg, 2, prompt_len=4, new_tokens=4,
                           bf16_params=bf16, kv_dtype=kv, reps=1,
                           device="cpu")
        assert np.isfinite(rate) and rate > 0
