"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer moments are nested dicts with tensor
leaves, in the JAX package's tree layout. Leaves are visited in sorted-key
order, the order ``jax.tree.leaves`` gives for dicts, so a flat list of
leaves lines up across the packages and across trees of one structure.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves_of_rest)`` on every leaf of ``tree``; the other
    trees must share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def unflattener(like) -> Callable[[torch.Tensor], dict]:
    """The inverse of ``flatten`` for trees of ``like``'s structure and
    leaf shapes: a flat vector -> a tree of views into it."""
    shapes = [x.shape for x in tree_leaves(like)]

    def unflatten(vec: torch.Tensor) -> dict:
        parts, off = [], 0
        for shape in shapes:
            n = shape.numel()
            parts.append(vec[off:off + n].reshape(shape))
            off += n
        return tree_unflatten(like, parts)

    return unflatten


def flatten(tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], dict]]:
    """Tree -> (flat vector, unflatten), in ``jax.flatten_util.
    ravel_pytree``'s order: the leaves in sorted-key order, each raveled
    row-major, concatenated."""
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(tree)])
    return flat, unflattener(tree)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_index(tree, i):
    """Index ``i`` along every leaf's leading axis."""
    return tree_map(lambda x: x[i], tree)


def tree_weighted_fold(trees, weights: torch.Tensor, init: Optional[dict] = None):
    """Σ_i w_i · leaf_i over the leading stacked axis of every leaf, as a
    left fold in index order: ``acc = where(w_i != 0, acc + w_i · x_i,
    acc)`` from ``init`` (zeros when omitted). The association is fixed by
    the order, and a zero-weight row is an exact no-op (selected around,
    not added), so padding rows at weight 0 change nothing."""
    if init is None:
        init = tree_map(lambda x: torch.zeros_like(x[0]), trees)
    acc = init
    for i in range(weights.shape[0]):
        w_i = weights[i]
        acc = tree_map(
            lambda a, x: torch.where(w_i != 0, a + w_i.to(a.dtype) * x[i], a),
            acc, trees)
    return acc
