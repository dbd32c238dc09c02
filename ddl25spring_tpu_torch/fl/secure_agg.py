"""Secure aggregation, pairwise additive masking on the Δ-upload round:
counterpart of the JAX package's ``fl/secure_agg.py``.

Every pair of sampled clients (i, j) derives a shared mask from a common
seed; client i uploads ``q_i + Σ_{j>i} m_ij − Σ_{j<i} m_ji`` and the server
sees only masked uploads, yet the masks cancel exactly in the sum. Exact
cancellation needs ring arithmetic, so updates ride a fixed-point grid:

1. clip each client delta to ``clip_norm``;
2. quantize to int32 on the data-independent grid
   ``clip_norm / 2^(bits−1)``;
3. add the pairwise masks, uniform over all 2^32 ring values; every sum
   wraps mod 2^32 explicitly (computed in int64, mapped back to
   [−2^31, 2^31)), so the server's sum of masked uploads equals the sum of
   the quantized deltas bit for bit;
4. dequantize the sum and average, one host multiply by ``scale / m``.

This is the protocol's dataflow (what the server observes) in one
program; key agreement, dropout recovery and double masking are out of
scope.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import rng
from ..tree import tree_index, tree_leaves, tree_map, tree_sub
from .local import local_sgd
from .privacy import clip_by_global_norm
from .servers import _ServerBase

_MASK_SALT = 0x5EC46600
_RING = 2 ** 32
_HALF = 2 ** 31


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor mod 2^32, mapped to [−2^31, 2^31), as int32."""
    return (torch.remainder(x + _HALF, _RING) - _HALF).to(torch.int32)


def ring_sum(stacked):
    """The wrapped sum over the leading axis of every int32 leaf: summed
    in int64, then reduced mod 2^32."""
    return tree_map(lambda u: wrap_int32(u.to(torch.int64).sum(0)), stacked)


def pair_generator(root: int, gi: int, gj: int, r: int,
                   device) -> torch.Generator:
    """The shared generator of the unordered client pair {gi, gj} at
    round r: both parties key it by (root, min, max, r), on the same
    device, so they draw the same mask without communicating."""
    lo, hi = min(int(gi), int(gj)), max(int(gi), int(gj))
    return rng.generator(rng.derived_seed(root, lo, hi, int(r)), device)


def quantize_tree(tree, scale: float):
    """Fixed-point int32 encoding, round(x / scale) (half to even)."""
    return tree_map(lambda x: torch.round(x / scale).to(torch.int32), tree)


def dequantize_tree(tree, scale: float):
    return tree_map(lambda q: q.to(torch.float32) * scale, tree)


def mask_tree(generator: torch.Generator, tree):
    """A uniform int32 mask of ``tree``'s structure: each entry drawn over
    all 2^32 ring values (int64 in [0, 2^32), shifted by −2^31), leaves in
    ``tree_leaves`` order, on the generator's device."""
    return tree_map(lambda x: (torch.randint(
        0, _RING, x.shape, generator=generator, dtype=torch.int64,
        device=generator.device) - _HALF).to(device=x.device,
                                             dtype=torch.int32), tree)


def secagg_scale(clip_norm: float, bits: int) -> float:
    """The shared fixed-point grid step ``clip_norm / 2^(bits-1)``."""
    return float(clip_norm) / float(2 ** (bits - 1))


def check_secagg_capacity(bits: int, m_clients: int) -> None:
    """Raise unless m clipped uploads fit int32 without wrapping the true
    (post-cancellation) sum: one coordinate of a clipped delta can reach
    2^(bits-1) grid steps, so m clients can sum to m·2^(bits-1)."""
    if not 2 <= bits <= 30:
        raise ValueError(f"bits={bits} outside [2, 30]")
    if m_clients >= 2 ** (31 - (bits - 1)):
        raise ValueError(
            f"bits={bits} overflows int32 at m={m_clients} sampled "
            f"clients: need m < 2^{31 - (bits - 1)}; lower bits or the "
            "cohort size")


def add_pair_masks(q, my_gid: int, pair_ids: Sequence[int],
                   pair_valid: Sequence[bool], mask_root: int, r: int):
    """Client ``my_gid``'s quantized tree with its pairwise masks added:
    + the mask of each valid pair where it holds the smaller id, − where
    the larger; itself and invalid entries add nothing. Wraps mod 2^32."""
    acc = tree_map(lambda a: a.to(torch.int64), q)
    device = tree_leaves(q)[0].device
    for other, valid in zip(pair_ids, pair_valid):
        other = int(other)
        if not valid or other == int(my_gid):
            continue
        sign = 1 if int(my_gid) < other else -1
        mask = mask_tree(pair_generator(mask_root, my_gid, other, r, device),
                         q)
        acc = tree_map(lambda a, mm: a + sign * mm.to(torch.int64), acc, mask)
    return tree_map(wrap_int32, acc)


def masked_upload(apply_fn, cfg, params, x, y, m, generator, my_gid,
                  pair_ids, pair_valid, mask_root, r, clip: float,
                  scale: float):
    """One client's view of the protocol: ``local_sgd`` on its subset
    (``x [S, ...]``, ``y [S]``, ``m [S]``) → clip → quantize → add the
    pairwise masks against every valid id in ``pair_ids``. Returns the
    masked int32 tree the server observes."""
    new = local_sgd(apply_fn, params, x[None], y[None], m[None],
                    epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
                    generators=[generator])
    delta = clip_by_global_norm(tree_sub(params, tree_index(new, 0)), clip)
    return add_pair_masks(quantize_tree(delta, scale), my_gid, pair_ids,
                          pair_valid, mask_root, r)


def finish_secagg_round(params, q_sum, scale: float, m_clients: int):
    """The server's unmasking tail: dequantize the ring sum with the one
    host constant ``scale / m`` and apply the averaged delta."""
    return tree_sub(params, dequantize_tree(q_sum, scale / m_clients))


class SecureAggFedAvgServer(_ServerBase):
    """FedAvg where the server only observes pairwise-masked fixed-point
    uploads (module docstring). ``bits`` sets the grid, clip_norm /
    2^(bits-1) per step. A round equals plain uniform clipped FedAvg up to
    the quantization, at most half a step per coordinate per client."""

    def __init__(self, *args, clip_norm: float = 5.0, bits: int = 20, **kw):
        super().__init__(*args, algorithm="secagg-fedavg", **kw)
        check_secagg_capacity(bits, self.cfg.clients_per_round)
        self.clip_norm = float(clip_norm)
        self.bits = bits
        self._scale = secagg_scale(self.clip_norm, bits)
        self.mask_root = self.cfg.seed ^ _MASK_SALT

    def quantized_deltas(self, params, r):
        """Round ``r``'s sampled clients and their clipped, quantized
        deltas, stacked: ``(idx, q)``. Every client trains at once. The
        sampled clients are those the fault plan keeps (pairs are masked
        among them alone); ``(None, None)`` when every client is lost."""
        idx = self._survivors(r, self._sample(r))
        if idx is None:
            return None, None
        gens = [rng.client_generator(self.cfg.seed, r, int(i),
                                     self.cfg.clients_per_round, self.device)
                for i in idx]
        cfg = self.cfg
        xs, ys, ms, _ = self._gather(idx)
        new = local_sgd(self.apply_fn, params, xs, ys, ms, epochs=cfg.epochs,
                        batch_size=cfg.batch_size, lr=cfg.lr,
                        generators=gens)
        deltas = clip_by_global_norm(tree_map(torch.sub, params, new),
                                     self.clip_norm, stacked=True)
        return idx, quantize_tree(deltas, self._scale)

    def masked_sum(self, idx, q, r):
        """The server's view: each client's masked upload, and their
        wrapped sum, in which the masks cancel."""
        valid = [True] * len(idx)
        uploads = [add_pair_masks(tree_index(q, c), int(gid), idx, valid,
                                  self.mask_root, r)
                   for c, gid in enumerate(idx)]
        return ring_sum(tree_map(lambda *u: torch.stack(u), *uploads))

    def _round(self, params, r):
        idx, q = self.quantized_deltas(params, r)
        if idx is None:
            return params
        return finish_secagg_round(params, self.masked_sum(idx, q, r),
                                   self._scale, len(idx))
