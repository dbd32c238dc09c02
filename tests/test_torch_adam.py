"""The port's Adam (``ops/adam.py``) and fused apply (``ops/pallas_adam.py``)
against the JAX package's on identical gradients: ``fused_adam`` against an
``optax.adam`` trajectory, ``FusedApplyAdam`` on CPU tensors (its plain
rule) against JAX's ``FusedApplyAdam`` running the Pallas kernel in
interpret mode, including the ragged 972 × 512 leaf and a tree of more
leaves than one kernel launch takes, the multi-leaf wrapper
``_adam_leaves_pallas`` on CPU tables against the JAX kernel leaf by leaf,
what the wrapper refuses, and the leaf routing rule. The CUDA kernel is held
against the plain rule on the card by ``chip_smoke.py`` and, compiled for
the CPU, by ``test_torch_adam_emulation.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddl25spring_tpu.config import LlamaConfig as JaxLlamaConfig
from ddl25spring_tpu.models import llama as jllama
from ddl25spring_tpu.ops import pallas_adam as jpadam
from ddl25spring_tpu_torch.ops import adam, pallas_adam
from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

LR = 1e-3


def _tree(rng, shapes):
    return {k: (rng.standard_normal(s).astype(np.float32) if isinstance(s, tuple)
                else _tree(rng, s)) for k, s in shapes.items()}


SHAPES = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)), tree)


def _assert_tree_close(got, want, **tol):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_fused_adam_matches_optax_adam_trajectory():
    """Five steps on the same gradients. Both are the Adam recurrence; they
    associate the bias-corrected quotient differently, which moves the last
    bits of each update (≤ a few ulp of lr)."""
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(5)]
    opt = optax.adam(LR)
    jp, js = params, opt.init(params)
    port = adam.fused_adam(LR)
    tp = _torch(params)
    ts = port.init(tp)
    for g in grads:
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = adam.apply_optimizer(port, _torch(g), ts, tp)
        _assert_tree_close(tp, jp, atol=1e-7, rtol=1e-6)
    assert int(ts.count) == 5
    _assert_tree_close(ts.mu, js[0].mu, atol=1e-7, rtol=1e-6)
    _assert_tree_close(ts.nu, js[0].nu, atol=1e-7, rtol=1e-6)


# 49 leaves of 128 × 512 elements: more than one launch's table of 48.
MANY_LEAVES = {**{f"w{i:02d}": (128, 512) for i in range(49)},
               "norm": (288,)}


@pytest.mark.parametrize("shapes", [
    {"big": (972 * 512,), "mid": (256, 512), "norm": (288,)}, MANY_LEAVES],
    ids=["ragged", "many leaves"])
def test_fused_apply_adam_on_cpu_matches_jax_pallas_kernel(shapes):
    """Three steps of ``apply_gradients`` with a 972 × 512 leaf (the
    kernel's multi-block ragged case in JAX), a 256 × 512 one and a small
    one that takes the plain rule; and with 49 kernel leaves. p, m and v
    within 1e-6: the same rule in the same operation order on both sides."""
    rng = np.random.default_rng(1)
    params = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(3)]
    jopt = jpadam.FusedApplyAdam(LR, interpret=True)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    opt = pallas_adam.FusedApplyAdam(LR)
    tp = _torch(params)
    ts = opt.init(tp)
    before = pallas_adam.launches
    for g in grads:
        jp, js = jopt.apply_gradients(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = opt.apply_gradients(tp, _torch(g), ts)
    assert pallas_adam.launches == before      # CPU tensors: the plain rule
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        _assert_tree_close(got, want, atol=1e-6, rtol=0)
    assert int(ts.count) == int(js.count) == 3


@pytest.mark.parametrize("vocab,n_kernel", [(32000, 9), (259, 7)])
def test_the_same_leaves_take_the_kernel(vocab, n_kernel):
    """Routing at the canonical widths: 9 leaves at vocab 32000 (embed,
    lm_head and the 7 stacked block matrices); 7 at the byte tokenizer's
    259, whose embed and lm_head (74,592 elements) are not a multiple of
    512. The norm scales take the plain rule in both packages."""
    shapes = jax.eval_shape(lambda: jllama.init_llama(
        jax.random.key(0), JaxLlamaConfig(vocab_size=vocab)))
    flat = jax.tree.leaves(shapes)
    want = [jpadam._pallas_eligible(x, x) for x in flat]
    meta = [torch.empty(x.shape, dtype=torch.float32, device="meta")
            for x in flat]
    got = [pallas_adam._pallas_eligible(x, x) for x in meta]
    assert got == want
    assert sum(got) == n_kernel


def test_smoke_check_on_cpu_runs_the_plain_rule():
    before = pallas_adam.launches
    assert pallas_adam.smoke_check(device="cpu") == 0.0
    assert pallas_adam.launches == before


def test_kernel_wrapper_refuses_bad_operands():
    p = torch.zeros(512 * 128)
    with pytest.raises(ValueError, match="fp32"):
        pallas_adam._adam_leaf_pallas(p, p.clone(), p.clone(), p.double(),
                                      torch.ones(2), lr=LR, b1=0.9, b2=0.999,
                                      eps=1e-8)


HYPER = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8)
CORRECTIONS = np.array([1 - 0.9 ** 3, 1 - 0.999 ** 3], np.float32)


@pytest.mark.parametrize("sizes", [
    [66048], [512, 66048, 1024, 1536, 2048, 512],
    [512, 1536, 2560] * 17],
    ids=["one leaf", "ragged table", "more leaves than a table"])
def test_leaves_wrapper_on_cpu_matches_jax_pallas_kernel(sizes):
    """``_adam_leaves_pallas`` on CPU tables (the plain rule on every leaf)
    against the JAX kernel in interpret mode, leaf by leaf, at step-3 bias
    corrections: p, m and v within 1e-6, and no launch counted."""
    rng = np.random.default_rng(len(sizes))
    leaves = [[rng.standard_normal(n).astype(np.float32) for _ in range(4)]
              for n in sizes]
    for leaf in leaves:
        leaf[1] *= 0.1
        leaf[2] = np.abs(leaf[2]) * 0.01
    got = [[torch.from_numpy(x.copy()) for x in leaf] for leaf in leaves]
    before = pallas_adam.launches
    pallas_adam._adam_leaves_pallas(*map(list, zip(*got)),
                                    torch.from_numpy(CORRECTIONS), **HYPER)
    assert pallas_adam.launches == before
    for (p, m, v, g), mine in zip(leaves, got):
        want = jpadam._adam_leaf_pallas(
            *map(jnp.asarray, (p, m, v, g)), jnp.asarray(CORRECTIONS),
            interpret=True, **HYPER)
        for a, b in zip(mine[:3], want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)


def _leaf(n=512 * 128, **kw):
    return [torch.zeros(n, **kw) for _ in range(4)]


def _bad_tables():
    ok = _leaf()
    cases = {
        "mixed devices": ([ok, _leaf(device="meta")], "one device"),
        "mixed shapes in a leaf": ([ok[:3] + [torch.zeros(512 * 64)]],
                                   "one shape"),
        "an fp64 gradient": ([ok[:3] + [ok[3].double()]], "fp32"),
        "an fp64 moment": ([[ok[0], ok[1].double(), ok[2], ok[3]]], "fp32"),
        "a meta table": ([_leaf(device="meta")], "CUDA or CPU"),
    }
    return {k: (v[0], v[1], torch.ones(2)) for k, v in cases.items()} | {
        "fp64 corrections": ([ok], "corrections", torch.ones(2).double()),
        "corrections of 3": ([ok], "corrections", torch.ones(3)),
        "corrections elsewhere": ([ok], "corrections",
                                  torch.ones(2, device="meta")),
    }


@pytest.mark.parametrize("case", list(_bad_tables()))
def test_leaves_wrapper_refuses_bad_operands(case):
    leaves, match, corrections = _bad_tables()[case]
    before = pallas_adam.launches
    with pytest.raises(ValueError, match=match):
        pallas_adam._adam_leaves_pallas(*map(list, zip(*leaves)), corrections,
                                        **HYPER)
    assert pallas_adam.launches == before


def test_leaves_wrapper_refuses_unequal_leaf_counts():
    p, m, v, g = _leaf()
    with pytest.raises(ValueError, match="as many"):
        pallas_adam._adam_leaves_pallas([p, p], [m], [v], [g], torch.ones(2),
                                        **HYPER)


@pytest.mark.parametrize("case", ["non-contiguous", "misaligned",
                                  "size not a multiple of 4", "empty"])
def test_kernel_leaf_checks_refuse_what_the_bulk_copies_cannot_move(case):
    """The layout checks a CUDA leaf must pass (``_check_kernel_leaf``),
    here on CPU tensors of each layout the kernel's bulk copies refuse."""
    p, m, v, g = _leaf()
    bad = {"non-contiguous": torch.zeros(512, 128).t(),
           "misaligned": torch.zeros(512 * 128 + 1)[1:],
           "size not a multiple of 4": torch.zeros(6),
           "empty": torch.zeros(0)}[case]
    leaf = [bad] * 4 if bad.numel() < 16 else [p, m, bad, g]
    with pytest.raises(ValueError, match="dense|divisible"):
        pallas_adam._check_kernel_leaf(leaf)
    pallas_adam._check_kernel_leaf([p, m, v, g])   # an aligned leaf passes
