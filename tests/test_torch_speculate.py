"""The port's speculative decoding (``serving/speculate.py``) against the JAX
package's: rejection sampling against the analytic acceptance and, for
JAX's own uniforms, JAX's accepted count exactly; greedy speculative
streams token for token the port's ``generate()`` and the JAX engine's
served streams, with prefix sharing and gather narrowing on; EOS inside a
window, hot swaps at verify boundaries, and the fixed number of draws per
verify dispatch. Stochastic streams cannot match JAX's (its categorical is
Gumbel-max over ``jax.random``), so those are held by distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.serving import SpecConfig as JaxSpecConfig
from ddl25spring_tpu.serving import run_serving as jax_run_serving
from ddl25spring_tpu.serving import synthetic_workload as jax_workload
from ddl25spring_tpu.serving.speculate import \
    rejection_accept as jax_rejection_accept
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.models import llama
from ddl25spring_tpu_torch.serving import (Engine, PagedKVConfig, Request,
                                           Scheduler, SpecConfig,
                                           reference_stream, run_serving,
                                           synthetic_workload)
from ddl25spring_tpu_torch.serving.engine import (inverse_cdf,
                                                  make_decode_step)
from ddl25spring_tpu_torch.serving.speculate import (rejection_accept,
                                                     rejection_decide)
from ddl25spring_tpu_torch.tree import tree_map

torch.set_num_threads(1)

SMALL = dict(vocab_size=97, dmodel=32, num_heads=4, n_layers=2, ctx_size=32)
CFG = LlamaConfig(**SMALL)
PAGED = PagedKVConfig(num_blocks=24, block_len=4, max_blocks_per_seq=8)


def _pair(seed):
    jp = jllama.init_llama(jax.random.PRNGKey(seed), JaxLlamaConfig(**SMALL))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    """Another init of the same architecture: an adversarial draft."""
    return _pair(7)


def _ref(model, req):
    return reference_stream(model, CFG, PAGED, req, device="cpu")


# ------------------------------------------------------- rejection sampling

def test_rejection_acceptance_matches_analytic():
    """Proposals d ~ q accepted with probability min(1, p/q): the rate is
    Σ min(p, q) and the emitted token (accepted proposal or residual
    draw) is distributed as p, each within 0.03 over 4,000 trials."""
    p0 = torch.tensor([0.5, 0.3, 0.15, 0.05])
    q0 = torch.tensor([0.2, 0.5, 0.2, 0.1])
    analytic = float(torch.minimum(p0, q0).sum())
    n = 4000
    rng = np.random.default_rng(0)
    drafts = torch.as_tensor(rng.choice(4, size=(n, 1), p=q0.numpy()))
    u = torch.rand(n, 4, generator=torch.Generator().manual_seed(1))
    p = p0.expand(n, 2, 4)
    q = q0.expand(n, 1, 4)
    a, corr = rejection_accept(u, p, q, drafts)
    assert abs(float(a.float().mean()) - analytic) < 0.03
    emitted = torch.where(a > 0, drafts[:, 0], corr)
    emp = torch.bincount(emitted, minlength=4).float() / n
    assert float((emp - p0).abs().max()) < 0.03, emp


def test_acceptance_count_equals_jax_for_its_own_uniforms():
    """JAX's accept decision for proposal i draws
    ``uniform(fold_in(sub, 2i))``; fed those uniforms, the port accepts
    exactly JAX's count for every window (k=3, random p, q and drafts)."""
    k, v, n = 3, 6, 400
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.full(v, 0.7), size=(n, k + 1)).astype(np.float32)
    q = rng.dirichlet(np.full(v, 0.7), size=(n, k)).astype(np.float32)
    drafts = np.stack([[rng.choice(v, p=q[i, j] / q[i, j].sum())
                        for j in range(k)] for i in range(n)]).astype(np.int32)
    subs = jax.vmap(jax.random.PRNGKey)(jnp.arange(n))
    want, _ = jax.vmap(jax_rejection_accept)(subs, jnp.asarray(p),
                                             jnp.asarray(q),
                                             jnp.asarray(drafts))
    u = jax.vmap(lambda s: jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(s, 2 * i)))(jnp.arange(k)))(subs)
    u = np.array(u)
    got = rejection_decide(torch.as_tensor(u),
                           torch.as_tensor(p), torch.as_tensor(q),
                           torch.as_tensor(drafts))
    assert got.tolist() == np.asarray(want).tolist()
    assert 0 < np.mean(np.asarray(want) == k) < 1     # both outcomes occur
    # The same count through the full rule, JAX's uniforms at 2i.
    full = torch.zeros(n, 2 * k + 2)
    full[:, 0:2 * k:2] = torch.as_tensor(u)
    assert rejection_accept(full, torch.as_tensor(p), torch.as_tensor(q),
                            torch.as_tensor(drafts))[0].tolist() == \
        np.asarray(want).tolist()


def test_identical_distributions_always_accept():
    p0 = torch.tensor([0.4, 0.4, 0.2])
    for seed in range(20):
        u = torch.rand(6, generator=torch.Generator().manual_seed(seed))
        a, _ = rejection_accept(u, p0.expand(3, 3), p0.expand(2, 3),
                                torch.tensor([0, 2]))
        assert int(a) == 2, seed


def test_inverse_cdf_never_draws_a_zero_probability_token():
    probs = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.0]] * 5)
    u = torch.tensor([0.0, 0.25, 0.5, 0.999999, 1.0 - 2 ** -24])
    assert inverse_cdf(probs, u).tolist() == [1, 1, 3, 3, 3]


def test_draft_token_is_drawn_from_its_returned_q(target):
    """The draft decode variant returns q and draws each sampling slot's
    token from that tensor: one uniform, inverse CDF."""
    _, model = target
    params = llama.as_tree(model)
    from ddl25spring_tpu_torch.models import generate
    from ddl25spring_tpu_torch.serving import init_pool
    step = make_decode_step(CFG, PAGED, None, None, return_probs=True)
    gens = [torch.Generator().manual_seed(5), None]
    clone = torch.Generator()
    clone.set_state(gens[0].get_state())
    tables = torch.tensor([[1, 2] + [0] * 6, [3, 4] + [0] * 6])
    _, toks, q = step(init_pool(CFG, PAGED, "cpu"), params,
                      generate._fuse_blocks(params["blocks"]), tables,
                      torch.tensor([5, 9]), torch.tensor([0, 0]), gens,
                      np.array([0.8, 0.0]), np.array([True, True]))
    u = torch.rand((), generator=clone)
    assert int(toks[0]) == int(inverse_cdf(q[0], u))
    assert gens[0].get_state().equal(clone.get_state())
    assert torch.allclose(q.sum(-1), torch.ones(2))


# ------------------------------------------------------------ greedy parity

@pytest.mark.parametrize("k", [1, 3])
def test_greedy_streams_equal_generate_and_the_jax_engine(target, draft, k):
    """Speculation with prefix sharing and gather narrowing on, a draft of
    other weights: every greedy stream equals the port's generate() and
    the JAX engine's served stream under the same options."""
    jp, model = target
    jd, dmodel = draft
    kw = dict(seed=3, n_requests=8, rate_rps=500.0, vocab_size=97,
              prompt_lens=(2, 5, 9), max_news=(3, 5, 8), temperatures=(0.0,))
    wl = synthetic_workload(**kw)
    rep = run_serving(model, CFG, PAGED, wl, num_slots=3, prefill_chunk=4,
                      speculate=SpecConfig(k=k, draft_params=dmodel),
                      prefix_share=True, gather_buckets=True, device="cpu")
    jrep = jax_run_serving(jp, JaxLlamaConfig(**SMALL), PAGED,
                           jax_workload(**kw), num_slots=3, prefill_chunk=4,
                           speculate=JaxSpecConfig(k=k, draft_params=jd),
                           prefix_share=True, gather_buckets=True)
    for r in wl:
        got = rep.records[r.rid].tokens
        assert got == _ref(model, r), r.rid
        assert got == jrep.records[r.rid].tokens, r.rid
    assert rep.acceptance_rate < 1.0 and rep.gather_bytes_saved > 0
    assert rep.draft_dispatches > rep.decode_dispatches * k


def test_same_weights_stochastic_draft_accepts_everything(target):
    _, model = target
    wl = [Request(rid="s0", prompt=(3, 5, 7), max_new=8, temperature=0.8,
                  seed=11),
          Request(rid="s1", prompt=(2, 9, 4, 1, 6), max_new=6,
                  temperature=0.6, seed=5)]
    rep = run_serving(model, CFG, PAGED, wl, num_slots=2, prefill_chunk=4,
                      speculate=SpecConfig(k=3, draft_params=model),
                      device="cpu")
    assert rep.acceptance_rate == 1.0
    assert all(len(rep.records[r.rid].tokens) == r.max_new for r in wl)


def test_same_weights_draft_lands_k_plus_1_tokens_per_dispatch(target):
    _, model = target
    wl = [Request(rid="one", prompt=(2, 9, 4, 1), max_new=9)]
    plain = run_serving(model, CFG, PAGED, wl, num_slots=1, prefill_chunk=8,
                        device="cpu")
    spec = run_serving(model, CFG, PAGED, wl, num_slots=1, prefill_chunk=8,
                       speculate=SpecConfig(k=3, draft_params=model),
                       device="cpu")
    assert plain.records["one"].tokens == spec.records["one"].tokens
    assert plain.tokens_per_dispatch == 1.0
    assert spec.tokens_per_dispatch == 4.0 and spec.acceptance_rate == 1.0


# ------------------------------------------------------------ EOS, swaps

@pytest.mark.parametrize("max_new", [12, 4])
def test_eos_mid_window_retires_once_at_the_right_token(target, max_new):
    """An EOS inside an accepted window retires the request at that token;
    at max_new 4 the same window also reaches the horizon, and the slot
    must be retired once only. Delivered tokens, not the window, count."""
    _, model = target
    prompt = tuple(range(2, 8))
    full = _ref(model, Request(rid="p", prompt=prompt, max_new=max_new))
    eos = full[2]
    assert full.index(eos) == 2
    cut = full[:3]
    eng = Engine(model, CFG, PAGED, 1, prefill_chunk=8,
                 speculate=SpecConfig(k=3, draft_params=model), device="cpu")
    sched = Scheduler(eng)
    sched.submit(Request(rid="r", prompt=prompt, max_new=max_new,
                         eos_id=eos), now=0.0)
    while sched.outstanding:
        sched.tick()
    assert sched.records["r"].tokens == cut
    assert eng.allocator.in_use == 0
    assert sum(r["emitted"] for r in sched.spec_rounds) == len(cut) - 1
    assert eng.decode_tokens == len(cut) - 1


def _swap_run(model, draft_model, new_params, swap_tick):
    eng = Engine(model, CFG, PAGED, 1, prefill_chunk=8,
                 speculate=SpecConfig(k=3, draft_params=draft_model),
                 device="cpu")
    sched = Scheduler(eng)
    sched.submit(Request(rid="r", prompt=tuple(range(2, 8)), max_new=10),
                 now=0.0)
    ticks, before = 0, None
    while sched.outstanding:
        if ticks == swap_tick:
            before = list(sched.records["r"].tokens)
            sched.swap_weights(new_params, version=1)
        sched.tick()
        ticks += 1
    return sched.records["r"].tokens, before


def test_hot_swap_lands_at_a_verify_boundary(target, draft):
    """A swap between ticks is a verify boundary: a same-weights swap
    changes nothing, a new-weights swap leaves every token before it."""
    _, model = target
    _, dmodel = draft
    want = _ref(model, Request(rid="w", prompt=tuple(range(2, 8)),
                               max_new=10))
    clone = tree_map(lambda x: x.detach().clone(), llama.as_tree(model))
    got, before = _swap_run(model, dmodel, clone, 2)
    assert got == want and 0 < len(before) < 10
    got2, before2 = _swap_run(model, dmodel, dmodel, 2)
    assert got2[:len(before2)] == want[:len(before2)] and got2 != want


def test_gather_narrowing_with_speculation_at_the_horizon(target, draft):
    """A late window of a full-width reservation asks one block past the
    table; the need caps at the table width and the stream holds."""
    _, model = target
    _, dmodel = draft
    wl = [Request(rid="short", prompt=(3, 5), max_new=4),
          Request(rid="edge", prompt=(4,) * 24, max_new=8)]
    rep = run_serving(model, CFG, PAGED, wl, num_slots=2, prefill_chunk=8,
                      gather_buckets=True, device="cpu",
                      speculate=SpecConfig(k=3, draft_params=dmodel))
    for r in wl:
        assert rep.records[r.rid].tokens == _ref(model, r), r.rid
    assert rep.gather_bytes_saved > 0


def test_gather_narrowing_alone_keeps_every_stream(target):
    """Without speculation, narrowing keeps greedy and sampled streams
    equal to generate()'s (dropped columns are masked to exact zeros), and
    the programs see at most one call signature per bucket width (the JAX
    engine's compile bound) with no retrace."""
    _, model = target
    wl = synthetic_workload(seed=11, n_requests=8, rate_rps=300.0,
                            vocab_size=97, prompt_lens=(2, 5, 9),
                            max_news=(3, 6), temperatures=(0.0, 0.7))
    rep = run_serving(model, CFG, PAGED, wl, num_slots=3, prefill_chunk=4,
                      gather_buckets=True, device="cpu")
    for r in wl:
        assert rep.records[r.rid].tokens == _ref(model, r), r.rid
    assert rep.gather_bytes_saved > 0 and rep.gather_bytes > 0
    buckets = len({1, 2, 4, 8})                  # mb=8 → 1/2/4/8
    assert 2 <= rep.compiles <= 1 + buckets and rep.retraces == 0


def test_a_verify_dispatch_draws_a_fixed_number_of_values(target, draft):
    """Each verify dispatch takes exactly 2k+2 uniforms from an active
    sampling slot's generator, wherever the rejection lands; the draft's
    draws come from its own generator."""
    _, model = target
    _, dmodel = draft
    k = 2
    eng = Engine(model, CFG, PAGED, 2, prefill_chunk=8,
                 speculate=SpecConfig(k=k, draft_params=dmodel), device="cpu")
    gen = torch.Generator().manual_seed(21)
    s = eng.admit(np.arange(3, 9), 20, temperature=0.9, generator=gen)
    eng.admit(np.arange(1, 4), 20)                # a greedy neighbour
    while eng.slots[s].phase == "prefill":
        eng.step()
    for _ in range(4):
        clone = torch.Generator()
        clone.set_state(gen.get_state())
        eng.step()
        torch.rand(2 * k + 2, generator=clone)
        assert gen.get_state().equal(clone.get_state())
    assert eng.draft.generators[s] is not gen
