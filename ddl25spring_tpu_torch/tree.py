"""Nested dicts and lists of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer moments are nested dicts and lists
with tensor leaves, in the JAX package's tree layout (``nn.mlp_init``
returns a list of layers; the VFL and VAE trees nest such lists in
dicts). Leaves are visited in the order ``jax.tree.leaves`` gives: a
dict's items in sorted-key order, a list's in index order. So a flat list
of leaves lines up across the packages and across trees of one
structure. Any other object (a tensor, a tuple, a number) is a leaf.

``nested_leaves`` / ``nested_unflatten`` also take
tuples (NamedTuples among them: a ``TrainState``, an optimizer state) as
nodes, fields in order, as ``jax.tree.leaves`` does: the checkpointer and
``parallel.dp``'s host snapshots walk whole training states with them.
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
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves: dict items in sorted-key order, list items in index
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(t) for t in node]
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
    ravel_pytree``'s order: the leaves in ``tree_leaves`` order, each raveled
    row-major, concatenated."""
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(tree)])
    return flat, unflattener(tree)


def value_and_grad(fn: Callable, params, *, has_aux: bool = False):
    """``fn(params)`` and its gradient with respect to every leaf of
    ``params`` (leaf tensors that require grad), as a tree of
    ``params``' structure: ``(out, grads)``, where ``out`` is the loss,
    or ``(loss, aux)`` with ``has_aux``. Runs under ``enable_grad``, so
    callers may hold the rest of a training loop under ``no_grad``."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        out = fn(params)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves)
    return out, tree_unflatten(params, list(grads))


def trainable(tree):
    """A copy of ``tree`` whose leaves are fresh tensors that require
    grad (detached from whatever made them)."""
    return tree_map(lambda x: x.detach().clone().requires_grad_(), tree)


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


def nested_leaves(tree) -> List:
    """``tree_leaves`` with tuples (NamedTuples included) as nodes too."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in nested_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in nested_leaves(t)]
    return [tree]


def nested_unflatten(like, leaves):
    """A tree of ``like``'s structure (dicts, lists, tuples and
    NamedTuples) holding ``leaves`` in ``nested_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(t) for t in node]
        if isinstance(node, tuple):
            items = [build(t) for t in node]
            return type(node)(*items) if hasattr(node, "_fields") \
                else tuple(items)
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out



def tree_copy(tree):
    """A device copy of every tensor leaf of a ``nested_leaves`` tree, each
    requiring grad where its original does (other leaves shared)."""
    return nested_unflatten(tree, [
        x.detach().clone().requires_grad_(x.requires_grad)
        if isinstance(x, torch.Tensor) else x
        for x in nested_leaves(tree)])
