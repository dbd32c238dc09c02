"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer moments are nested dicts with tensor
leaves, in the JAX package's tree layout. Leaves are visited in sorted-key
order, the order ``jax.tree.leaves`` gives for dicts, so a flat list of
leaves lines up across the packages and across trees of one structure.
"""

from __future__ import annotations

from typing import Callable, List


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
