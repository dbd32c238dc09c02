"""The port's copy-on-write prefix sharing (``Engine(prefix_share=True)``):
the allocator peak drops by exactly the shared blocks, divergent tails share
only their common prefix, a prompt of whole blocks still samples its first
token, the donor's shared blocks keep their bytes (the port writes its pool
in place, so an unmasked write would change them), and sharing composes
with speculation and with Poisson load; every greedy stream equals the
port's ``generate()`` and the JAX engine's."""

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.serving import BlockAllocator as JaxBlockAllocator
from ddl25spring_tpu.serving import Engine as JaxEngine
from ddl25spring_tpu_torch.config import LlamaConfig
from ddl25spring_tpu_torch.convert import params_from_jax
from ddl25spring_tpu_torch.serving import (BlockAllocator, Engine,
                                           PagedKVConfig, Request,
                                           SpecConfig, reference_stream,
                                           run_serving)

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
    return _pair(7)


def _ref(model, prompt, max_new):
    return reference_stream(model, CFG, PAGED,
                            Request(rid="w", prompt=tuple(prompt),
                                    max_new=max_new), device="cpu")


def _drive_pair(params, prompt, max_new, *, prefix_share, speculate=None,
                stagger=2, prompt_b=None, engine_cls=Engine, **kw):
    """Two requests, the second admitted ``stagger`` steps into the first;
    returns (streams, physical peak, engine)."""
    eng = engine_cls(params, CFG, PAGED, 2, prefill_chunk=16,
                     prefix_share=prefix_share, speculate=speculate, **kw)
    s_a = eng.admit(np.asarray(prompt), max_new)
    out = {s_a: []}
    s_b, steps = None, 0
    while eng.busy or s_b is None:
        if steps == stagger and s_b is None:
            s_b = eng.admit(np.asarray(prompt_b or prompt), max_new)
            out[s_b] = []
        for ev in eng.step():
            out[ev.slot].append(ev.token)
        steps += 1
    return (out[s_a], out[s_b]), eng.allocator.peak_in_use, eng


def test_peak_drops_by_the_shared_count(target):
    """Two overlapping requests with one 3-block prompt: sharing lowers the
    physical peak by exactly 3, the streams are generate()'s, and the JAX
    engine shares and serves the same."""
    jp, model = target
    prompt = tuple(range(2, 14))                 # 12 tokens = 3 full blocks
    want = _ref(model, prompt, 6)
    (a1, b1), peak_cow, _ = _drive_pair(model, prompt, 6, prefix_share=True,
                                        device="cpu")
    (a0, b0), peak_plain, _ = _drive_pair(model, prompt, 6,
                                          prefix_share=False, device="cpu")
    assert a1 == b1 == a0 == b0 == want
    assert peak_cow == peak_plain - 3
    (ja, jb), jpeak, _ = _drive_pair(jp, prompt, 6, prefix_share=True,
                                     engine_cls=JaxEngine)
    assert ja == jb == want and jpeak == peak_cow


def test_divergent_tails_share_only_the_common_prefix(target):
    _, model = target
    common = tuple(range(3, 11))                 # 8 tokens = 2 full blocks
    pa, pb = common + (20, 21), common + (30,)
    (a, b), peak, _ = _drive_pair(model, pa, 5, prefix_share=True,
                                  prompt_b=pb, device="cpu")
    assert a == _ref(model, pa, 5) and b == _ref(model, pb, 5)
    (_, _), peak_plain, _ = _drive_pair(model, pa, 5, prefix_share=False,
                                        prompt_b=pb, device="cpu")
    assert peak == peak_plain - 2


def test_a_prompt_of_whole_blocks_still_samples_its_first_token(target):
    """Every prompt block is shared: the sharer recomputes only the last
    prompt token (writing it to trash) to get the first-token state."""
    _, model = target
    prompt = tuple(range(4, 12))                 # 8 = 2 exact blocks
    (a, b), _, _ = _drive_pair(model, prompt, 4, prefix_share=True,
                               device="cpu")
    assert a == b == _ref(model, prompt, 4)


def _shared_bytes(eng, blocks):
    return (eng.pool["k"][:, blocks].clone(), eng.pool["v"][:, blocks].clone())


@pytest.mark.parametrize("swap", [False, True], ids=["same", "swapped"])
def test_the_donors_shared_blocks_keep_their_bytes(target, draft, swap):
    """The shared blocks' K/V in both layers are bitwise unchanged across
    the sharer's prefill. With ``swapped`` the sharer arrives after a
    weight swap, so any write it made into the shared region would carry
    other values: this case fails if the ``write_from`` mask is lost."""
    _, model = target
    _, other = draft
    prompt = tuple(range(2, 14))                 # 3 full blocks
    eng = Engine(model, CFG, PAGED, 2, prefill_chunk=4, prefix_share=True,
                 device="cpu")
    a = eng.admit(np.asarray(prompt), 6)
    while eng.slots[a].phase == "prefill":
        eng.step()
    shared = [int(x) for x in eng.tables[a, :3]]
    before = _shared_bytes(eng, shared)
    if swap:
        eng.swap_params(other)
    b = eng.admit(np.asarray(prompt), 6)
    assert [int(x) for x in eng.tables[b, :3]] == shared
    assert all(eng.allocator.refcount(x) == 2 for x in shared)
    while eng.slots[b] is not None and eng.slots[b].phase == "prefill":
        eng.step()
    after = _shared_bytes(eng, shared)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                            after[1])


def test_sharing_composes_with_speculation(target, draft):
    """Shared prompt blocks exist in both pools (the donor's draft prefill
    wrote the draft's copies); greedy streams hold through k=3 windows."""
    _, model = target
    _, dmodel = draft
    prompt = tuple(range(5, 17))                 # 3 full blocks
    spec = SpecConfig(k=3, draft_params=dmodel)
    (a, b), peak, _ = _drive_pair(model, prompt, 6, prefix_share=True,
                                  speculate=spec, device="cpu")
    assert a == b == _ref(model, prompt, 6)
    (_, _), peak_plain, _ = _drive_pair(model, prompt, 6, prefix_share=False,
                                        speculate=spec, device="cpu")
    assert peak == peak_plain - 3


def test_poisson_load_saves_blocks_and_keeps_streams(target):
    _, model = target
    base = tuple(range(2, 10))                   # 2 full blocks shared
    wl = [Request(rid=f"r{i:02d}", prompt=base + (40 + i,), max_new=4,
                  arrival=0.002 * i) for i in range(8)]
    rep_cow = run_serving(model, CFG, PAGED, wl, num_slots=4,
                          prefill_chunk=8, prefix_share=True, device="cpu")
    rep_pln = run_serving(model, CFG, PAGED, wl, num_slots=4,
                          prefill_chunk=8, device="cpu")
    for r in wl:
        want = _ref(model, r.prompt, r.max_new)
        assert rep_cow.records[r.rid].tokens == want, r.rid
        assert rep_pln.records[r.rid].tokens == want, r.rid
    assert rep_cow.peak_blocks_in_use < rep_pln.peak_blocks_in_use


def test_admission_credits_and_eviction(target):
    """``can_admit(prompt=)`` credits the shared blocks; when the last
    reference goes, the blocks leave the prefix cache."""
    _, model = target
    tight = PagedKVConfig(num_blocks=7, block_len=4, max_blocks_per_seq=8)
    eng = Engine(model, CFG, tight, 2, prefill_chunk=16, prefix_share=True,
                 device="cpu")
    prompt = tuple(range(2, 18))                 # 16 tokens = 4 blocks
    a = eng.admit(np.asarray(prompt), 4)         # 5 of 6 blocks
    eng.step()
    assert not eng.can_admit(len(prompt), 4)
    assert eng.can_admit(len(prompt), 4, prompt=prompt)   # needs 1 fresh
    eng.retire(a)
    assert eng._prefix_blocks == {} and eng.allocator.in_use == 0


def test_fragmentation_census_matches_jax():
    ops = [("alloc", 5), ("free", [2, 4]), ("alloc", 1), ("free", [1]),
           ("alloc", 0), ("free", [5])]
    ours, ref = BlockAllocator(10), JaxBlockAllocator(10)
    seen = [(ours.fragmentation(), ours.holes, ours.largest_run)]
    for op, arg in ops:
        getattr(ours, op)(arg)
        getattr(ref, op)(arg)
        got = (ours.fragmentation(), ours.holes, ours.largest_run)
        assert got == (ref.fragmentation(), ref.holes, ref.largest_run)
        seen.append(got)
    assert seen[0] == ({"holes": 1, "largest_run": 9}, 1, 9)
    assert any(h > 1 for _, h, _ in seen)
    full = BlockAllocator(3)
    full.alloc(2)
    assert full.fragmentation() == {"holes": 0, "largest_run": 0}
