"""The port's Byzantine defenses against the JAX package's on the same
seeded ``[m, P]`` stacks: every rule and both server adapters within 1e-6,
the median at an even and an odd client count, Krum's first-index tie
rule, and Bulyan's infeasible-trim branch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl25spring_tpu.fl import defenses as jdef
from ddl25spring_tpu_torch.fl import defenses as tdef
from ddl25spring_tpu_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def _stack(m, p=300, seed=0, n_bad=2):
    """m seeded client updates, the last n_bad scaled outliers."""
    r = np.random.default_rng(seed)
    flat = r.normal(0, 0.1, size=(m, p)).astype(np.float32)
    flat[m - n_bad:] *= -5.0
    return flat


def _close(got, want, tol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


RULES = {
    "krum_scores": lambda d, f: d.krum_scores(f, n_malicious=2),
    "krum": lambda d, f: d.krum(f, n_malicious=2),
    "multi_krum": lambda d, f: d.multi_krum(f, n_malicious=2, k=4),
    "coordinate_median": lambda d, f: d.coordinate_median(f),
    "trimmed_mean": lambda d, f: d.trimmed_mean(f, beta=0.2),
    "majority_sign": lambda d, f: d.majority_sign(f),
    "norm_clipping": lambda d, f: d.norm_clipping(f, ratio=1.0),
    "norm_clipping_half": lambda d, f: d.norm_clipping(f, ratio=0.5),
    "bulyan": lambda d, f: d.bulyan(f, n_malicious=2, k=6, beta=0.2),
    "bulyan_infeasible": lambda d, f: d.bulyan(f, n_malicious=2, k=4,
                                               beta=0.6),
    "sparse_fed": lambda d, f: d.sparse_fed(f, topk_fraction=0.1),
}


@pytest.mark.parametrize("m", [10, 7])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax(rule, m):
    flat = _stack(m, seed=m)
    got = RULES[rule](tdef, torch.from_numpy(flat))
    want = RULES[rule](jdef, jnp.asarray(flat))
    if rule in ("krum", "multi_krum"):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    flat = torch.tensor([[1.0, -5.0], [2.0, 0.0], [3.0, 5.0], [100.0, 1.0]])
    assert tdef.coordinate_median(flat).tolist() == [2.5, 0.5]
    assert tdef.coordinate_median(flat[:3]).tolist() == [2.0, 0.0]


def test_krum_takes_the_first_of_tied_scores():
    # Rows 0/1 and 2/3 are pairs of duplicates at the same spacing: the
    # four scores tie exactly, and both packages pick index 0.
    flat = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [1.0, 0.0],
                     [9.0, 9.0]], np.float32)
    scores = tdef.krum_scores(torch.from_numpy(flat), 1)
    assert scores[0] == scores[1] == scores[2] == scores[3]
    assert int(tdef.krum(torch.from_numpy(flat), 1)) == 0 == \
        int(jdef.krum(jnp.asarray(flat), 1))
    np.testing.assert_array_equal(
        tdef.multi_krum(torch.from_numpy(flat), 1, 4).numpy(),
        np.asarray(jdef.multi_krum(jnp.asarray(flat), 1, 4)))


def test_bulyan_infeasible_trim_means_the_survivors():
    flat = torch.from_numpy(_stack(10, seed=3))
    k, beta = 4, 0.6                       # int(0.6·4) = 2: 4 − 2·2 = 0
    out = tdef.bulyan(flat, n_malicious=2, k=k, beta=beta)
    winners = tdef.multi_krum(flat, n_malicious=2, k=k)
    assert torch.equal(out, flat[winners].mean(dim=0))
    with pytest.raises(ValueError, match="trims all"):
        tdef.trimmed_mean(flat, beta=0.5)


def _tree_stack(m, seed):
    r = np.random.default_rng(seed)
    return {"conv": {"b": r.normal(size=(m, 4)).astype(np.float32),
                     "w": r.normal(size=(m, 4, 2, 3)).astype(np.float32)},
            "fc": r.normal(size=(m, 5)).astype(np.float32)}


HOOKS = {
    "krum": lambda d: d.selection_defense(d.krum, n_malicious=2),
    "multi_krum": lambda d: d.selection_defense(d.multi_krum, n_malicious=2,
                                                k=3),
    "median": lambda d: d.coordinate_defense(d.coordinate_median),
    "trimmed_mean": lambda d: d.coordinate_defense(d.trimmed_mean, beta=0.2),
}


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_server_adapters_match_jax(hook):
    stack = _tree_stack(10, seed=1)
    w = np.random.default_rng(2).uniform(0.5, 1.5, 10).astype(np.float32)
    w /= w.sum()
    th, jh = HOOKS[hook](tdef), HOOKS[hook](jdef)
    tstack = tree_map(torch.from_numpy, stack)
    got = th(tstack, torch.from_numpy(w))
    want = jh(stack, jnp.asarray(w))
    got_leaves, want_leaves = tree_leaves(got), [
        want["conv"]["b"], want["conv"]["w"], want["fc"]]
    for a, b in zip(got_leaves, want_leaves):
        _close(a, b)
    # The flat core is carried on the hook and gives the same vector.
    flat, unflatten = tdef.stack_flat(tstack)
    for a, b in zip(tree_leaves(unflatten(th.flat_hook(flat, torch.from_numpy(w)))),
                    got_leaves):
        assert torch.equal(a, b)


def test_stack_flat_order_and_round_trip_match_jax():
    stack = _tree_stack(3, seed=4)
    tstack = tree_map(torch.from_numpy, stack)
    flat, unflatten = tdef.stack_flat(tstack)
    jflat, _ = jdef.stack_flat(stack)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    one = unflatten(flat[1])
    assert torch.equal(one["conv"]["w"], tstack["conv"]["w"][1])
    template = {"conv": {"b": torch.zeros(4), "w": torch.zeros(4, 2, 3)},
                "fc": torch.zeros(5)}
    back = tdef.unstack_flat(flat, template)
    for a, b in zip(tree_leaves(back), tree_leaves(tstack)):
        assert torch.equal(a, b)
