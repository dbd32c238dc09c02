"""Differentially private federated averaging (DP-FedAvg): counterpart of
the JAX package's ``fl/privacy.py``.

The central-DP recipe on the Δ-upload round of ``FedAvgGradServer``:
1. every sampled client's delta is clipped to L2 norm ``clip_norm``, one
   global norm per client over all its leaves;
2. the clipped deltas are averaged uniformly over the m sampled clients;
3. the server adds Gaussian noise of per-coordinate std
   σ = noise_multiplier · clip_norm / m to the average, drawn from a
   stream of its own per round (never from a client's generator).
   Under a fault plan m counts the surviving clients, so σ is that of
   the mean actually taken.

The accountant is pure float math, copied as written: ``dp_epsilon`` is
the advanced-composition bound without subsampling amplification,
``dp_epsilon_tight`` the subsampled-Gaussian RDP accountant (Mironov et
al. 2019, integer orders) converted with Canonne-Kamath-Steinke 2020.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import rng
from ..tree import tree_leaves, tree_map, tree_sub, tree_unflatten
from .local import local_sgd
from .servers import _ServerBase

# Where the server's noise stream is keyed apart from the clients'.
NOISE_SALT = 0x5E17C0DE


def clip_by_global_norm(tree, clip_norm: float, *, stacked: bool = False):
    """Scale ``tree`` so its global L2 norm is at most ``clip_norm``
    (identity when already within). With ``stacked``, every leaf carries a
    leading client axis and each client is clipped by its own norm over
    all its leaves."""
    leaves = tree_leaves(tree)
    dims = lambda x: tuple(range(1, x.dim())) if stacked else tuple(
        range(x.dim()))
    norm = torch.sqrt(sum(torch.sum(torch.square(x), dim=dims(x))
                          for x in leaves))
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    if not stacked:
        return tree_map(lambda x: x * scale, tree)
    return tree_map(lambda x: x * scale.reshape((-1,) + (1,) * (x.dim() - 1)),
                    tree)


def gaussian_noise_like(generator: torch.Generator, tree, sigma: float):
    """One N(0, σ²) sample per coordinate of ``tree``, leaves drawn in
    ``tree_leaves`` order from ``generator`` (on its device)."""
    noise = [(torch.randn(x.shape, generator=generator, dtype=torch.float32,
                          device=generator.device) * sigma).to(x)
             for x in tree_leaves(tree)]
    return tree_unflatten(tree, noise)


def dp_epsilon(noise_multiplier: float, rounds: int,
               delta: float = 1e-5) -> float:
    """Conservative (no subsampling amplification) ε for ``rounds``
    compositions of the Gaussian mechanism with noise multiplier z:
    sqrt(2T·ln(1/δ))/z + T/(2z²)."""
    z, t = float(noise_multiplier), int(rounds)
    if z <= 0:
        return float("inf")
    return math.sqrt(2.0 * t * math.log(1.0 / delta)) / z + t / (2.0 * z * z)


# Integer Rényi orders: dense where the minimum usually lands, sparse tail
# for very-high-privacy regimes.
_RDP_ORDERS = tuple(range(2, 65)) + (80, 96, 128, 192, 256, 384, 512)


def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _rdp_sgm(q: float, z: float, alpha: int) -> float:
    """One-step RDP of integer order ``alpha`` ≥ 2 of the Gaussian
    mechanism with noise multiplier ``z`` under Poisson subsampling at
    rate ``q``:

        RDP(α) = 1/(α−1) · log Σ_{k=0}^{α} C(α,k)·(1−q)^{α−k}·q^k
                                   · exp(k(k−1)/(2z²))
    """
    if q == 0.0:
        return 0.0
    if q >= 1.0:                      # no subsampling: plain Gaussian RDP
        return alpha / (2.0 * z * z)
    # Log-sum-exp over k: the k=α term alone can overflow a float.
    log_terms = [
        _log_binom(alpha, k) + (alpha - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + k * (k - 1) / (2.0 * z * z)
        for k in range(alpha + 1)
    ]
    hi = max(log_terms)
    lse = hi + math.log(sum(math.exp(t - hi) for t in log_terms))
    return lse / (alpha - 1)


def dp_epsilon_tight(noise_multiplier: float, rounds: int,
                     sampling_rate: float, delta: float = 1e-5) -> float:
    """ε by the subsampled-Gaussian RDP accountant at per-round sampling
    rate q (the client fraction C): RDP composes additively over
    ``rounds`` and converts as

        ε = RDP_T(α) + log((α−1)/α) − (log δ + log α)/(α−1)

    minimized over the order grid. +inf for z ≤ 0."""
    z, t, q = float(noise_multiplier), int(rounds), float(sampling_rate)
    if z <= 0:
        return float("inf")
    if q <= 0.0 or t == 0:
        return 0.0
    best = float("inf")
    for alpha in _RDP_ORDERS:
        rdp = t * _rdp_sgm(q, z, alpha)
        eps = (rdp + math.log((alpha - 1) / alpha)
               - (math.log(delta) + math.log(alpha)) / (alpha - 1))
        best = min(best, eps)
    return max(0.0, best)


def privacy_spend(noise_multiplier: float, rounds: int, sampling_rate: float,
                  delta: float = 1e-6) -> dict:
    """Both ε bounds for one (z, T, q, δ) protocol point, as a JSON-able
    record."""
    return {
        "sampling_rate_q": float(sampling_rate),
        "noise_multiplier": float(noise_multiplier),
        "rounds": int(rounds),
        "delta": float(delta),
        "eps_rdp_tight": dp_epsilon_tight(noise_multiplier, rounds,
                                          sampling_rate, delta),
        "eps_advanced_composition": dp_epsilon(noise_multiplier, rounds,
                                               delta),
    }


class DPFedAvgServer(_ServerBase):
    """FedAvg with per-client delta clipping and server-side Gaussian
    noise (module docstring). ``noise_multiplier=0`` adds no noise;
    ``clip_norm=None`` with no noise is uniform (not sample-count
    weighted) FedAvg."""

    def __init__(self, *args, clip_norm: Optional[float] = 1.0,
                 noise_multiplier: float = 0.0, **kw):
        super().__init__(*args, algorithm="dp-fedavg", **kw)
        self.clip_norm = clip_norm
        self.noise_multiplier = float(noise_multiplier)
        if self.noise_multiplier > 0.0 and clip_norm is None:
            raise ValueError("noise_multiplier > 0 needs a finite clip_norm")

    def noise_generator(self, round_idx: int) -> torch.Generator:
        """Round ``round_idx``'s noise stream, on the server's device:
        keyed by (seed ^ NOISE_SALT, round), so no two rounds share it and
        none shares a client's."""
        return rng.generator(rng.derived_seed(self.cfg.seed ^ NOISE_SALT,
                                              round_idx), self.device)

    def _round(self, params, r):
        idx = self._survivors(r, self._sample(r))
        if idx is None:
            return params
        gens = [rng.client_generator(self.cfg.seed, r, int(i),
                                     self.cfg.clients_per_round, self.device)
                for i in idx]
        cfg, clip, z = self.cfg, self.clip_norm, self.noise_multiplier
        xs, ys, ms, _ = self._gather(idx)
        new = local_sgd(self.apply_fn, params, xs, ys, ms, epochs=cfg.epochs,
                        batch_size=cfg.batch_size, lr=cfg.lr,
                        generators=gens)
        deltas = tree_map(torch.sub, params, new)         # Δ = w0 − w_final
        if clip is not None:
            deltas = clip_by_global_norm(deltas, clip, stacked=True)
        m = len(idx)
        # Uniform average: the mean's sensitivity is clip/m.
        agg = tree_map(lambda d: d.sum(0) * (1.0 / m), deltas)
        if z > 0.0:
            noise = gaussian_noise_like(self.noise_generator(r), agg,
                                        z * clip / m)
            agg = tree_map(torch.add, agg, noise)
        return tree_sub(params, agg)
