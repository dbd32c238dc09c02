"""Byzantine-robust aggregation rules over the client axis: counterpart of
the JAX package's ``fl/defenses.py``.

Rules take the stacked flat view ``[m, P]`` of the clients' raw Δs:
selection rules (Krum, Multi-Krum) return client indices, aggregation
rules (coordinate median, trimmed mean, majority sign, norm clipping,
Bulyan, SparseFed) return the aggregated ``[P]`` Δ. ``selection_defense``
and ``coordinate_defense`` lift them into ``FedAvgGradServer``'s hook,
``defense(deltas, weights) -> aggregated Δ tree``; each hook carries its
flat core as ``hook.flat_hook``.

Numerics kept from the JAX package: Krum's squared distances are
difference, square, sum (never ‖a‖² + ‖b‖² − 2a·b, which loses digits
near the winner), one client against all at a time; ``argmin`` takes the
first of tied scores; the median of an even count is the mean of the two
middle values, (lo + hi)·0.5.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..tree import tree_index, tree_leaves, tree_unflatten, unflattener

# ------------------------------------------------------------ flat stacking


def stack_flat(deltas: dict) -> Tuple[torch.Tensor, Callable]:
    """Stacked tree (leading client axis m) -> (flat [m, P], unflatten for
    a single [P] vector), leaves in sorted-key order."""
    leaves = tree_leaves(deltas)
    m = leaves[0].shape[0]
    flat = torch.cat([x.reshape(m, -1) for x in leaves], dim=1)
    return flat, unflattener(tree_index(deltas, 0))


def unstack_flat(flat: torch.Tensor, template: dict) -> dict:
    """Inverse of ``stack_flat`` for a whole [m, P] stack: the stacked tree
    whose per-leaf trailing shapes come from ``template`` (one un-stacked
    tree, e.g. the params)."""
    m = flat.shape[0]
    parts, off = [], 0
    for leaf in tree_leaves(template):
        n = leaf.numel()
        parts.append(flat[:, off:off + n].reshape((m,) + leaf.shape))
        off += n
    return tree_unflatten(template, parts)


# ------------------------------------------------------------ selection rules


def _sq_distances(flat: torch.Tensor) -> torch.Tensor:
    """[m, m] squared L2 distances, +inf on the diagonal."""
    m = flat.shape[0]
    d2 = torch.stack([((flat - flat[i]) ** 2).sum(dim=1) for i in range(m)])
    return d2 + torch.diag(torch.full((m,), float("inf"), dtype=flat.dtype,
                                      device=flat.device))


def krum_scores(flat: torch.Tensor, n_malicious: int) -> torch.Tensor:
    """Per-client Krum score: sum of its n−f−2 smallest squared
    distances."""
    k = max(flat.shape[0] - n_malicious - 2, 1)
    return torch.sort(_sq_distances(flat), dim=1).values[:, :k].sum(dim=1)


def krum(flat: torch.Tensor, n_malicious: int) -> torch.Tensor:
    """Index of the Krum winner (a 0-d tensor)."""
    return torch.argmin(krum_scores(flat, n_malicious))


def multi_krum(flat: torch.Tensor, n_malicious: int, k: int) -> torch.Tensor:
    """k Krum winners [k], picked one at a time; each winner's distances
    are excluded from every later score."""
    m = flat.shape[0]
    d2 = _sq_distances(flat)
    removed = torch.zeros(m, dtype=torch.bool, device=flat.device)
    ranks = torch.arange(m, device=flat.device)[None, :]
    winners = []
    for _ in range(k):
        kk = torch.clamp(m - removed.sum() - n_malicious - 2, min=1)
        srt = torch.sort(d2, dim=1).values
        scores = torch.where(ranks < kk, srt, 0.0).sum(dim=1)
        scores = torch.where(removed, float("inf"), scores)
        winner = torch.argmin(scores)
        removed[winner] = True
        d2[:, winner] = float("inf")
        winners.append(winner)
    return torch.stack(winners)


# ------------------------------------------------------------ coordinate rules


def coordinate_median(flat: torch.Tensor) -> torch.Tensor:
    """Per-coordinate median over clients; an even count takes the mean of
    the two middle values."""
    m = flat.shape[0]
    srt = torch.sort(flat, dim=0).values
    return (srt[(m - 1) // 2] + srt[m // 2]) * 0.5


def trimmed_mean(flat: torch.Tensor, beta: float) -> torch.Tensor:
    """Drop the β-fraction largest and smallest per coordinate, mean the
    rest."""
    m = flat.shape[0]
    t = int(beta * m)
    if m - 2 * t <= 0:
        raise ValueError(f"beta={beta} trims all {m} clients")
    return torch.sort(flat, dim=0).values[t:m - t].mean(dim=0)


def majority_sign(flat: torch.Tensor) -> torch.Tensor:
    """Keep only entries agreeing with the per-coordinate majority sign and
    average over all clients (disagreeing entries count as zeros)."""
    signs = torch.sign(flat)
    maj = torch.sign(signs.sum(dim=0))
    agree = (signs == maj) & (maj != 0)
    return torch.where(agree, flat, 0.0).mean(dim=0)


def norm_clipping(flat: torch.Tensor, ratio: float = 1.0) -> torch.Tensor:
    """Scale each client's update to at most the mean norm · ratio, then
    average."""
    norms = torch.linalg.vector_norm(flat, dim=1)
    bound = norms.mean() * ratio
    scale = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0)
    return (flat * scale[:, None]).mean(dim=0)


def bulyan(flat: torch.Tensor, n_malicious: int, k: int, beta: float
           ) -> torch.Tensor:
    """Multi-Krum preselects k survivors, then a coordinate trimmed mean
    over them. Where the trim would consume every survivor (k ≤
    2·int(β·k)), the survivors are averaged untrimmed."""
    chosen = flat[multi_krum(flat, n_malicious, k)]
    if k - 2 * int(beta * k) > 0:
        return trimmed_mean(chosen, beta)
    return chosen.mean(dim=0)


def sparse_fed(flat: torch.Tensor, topk_fraction: float, *,
               clip_ratio: float = 1.0) -> torch.Tensor:
    """Per-client norm clip, average, then keep the global top-k
    coordinates by magnitude (ties at the threshold kept), zero the
    rest."""
    avg = norm_clipping(flat, clip_ratio)
    p = avg.shape[0]
    k = max(1, int(topk_fraction * p))
    thresh = torch.sort(avg.abs()).values[p - k]
    return torch.where(avg.abs() >= thresh, avg, 0.0)


# ------------------------------------------------------------ server adapters


def selection_defense(rule: Callable[..., torch.Tensor], **kw) -> Callable:
    """Lift a selection rule (returns indices): the survivors are averaged
    with their sample-count weights renormalized."""

    def flat_hook(flat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        idx = torch.atleast_1d(rule(flat, **kw))
        w = weights[idx]
        w = w / torch.clamp(w.sum(), min=1e-12)
        return (flat[idx] * w[:, None]).sum(dim=0)

    def hook(deltas: dict, weights: torch.Tensor) -> dict:
        flat, unflatten = stack_flat(deltas)
        return unflatten(flat_hook(flat, weights))

    hook.flat_hook = flat_hook
    return hook


def coordinate_defense(rule: Callable[..., torch.Tensor], **kw) -> Callable:
    """Lift an aggregation rule on the flat [m, P] stack; the weights are
    unused (the rule replaces the weighted mean)."""

    def flat_hook(flat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        return rule(flat, **kw)

    def hook(deltas: dict, weights: torch.Tensor) -> dict:
        flat, unflatten = stack_flat(deltas)
        return unflatten(flat_hook(flat, weights))

    hook.flat_hook = flat_hook
    return hook
