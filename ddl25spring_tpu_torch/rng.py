"""RNG discipline for federated learning: explicit ``torch.Generator``s.

Counterpart of the JAX package's ``rng.py``. Its integer formula for a
client's seed in a round, ``seed + ind + 1 + round · clients_per_round``,
is kept exactly (``per_client_seed``): a client's local randomness depends
on its global index and the round, not on where it was sampled. Streams
cannot match ``jax.random``'s; what is kept is the contract: the same
seeds, clients sampled without replacement, each stream reproducible on
its own.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def per_client_seed(seed: int, round_idx: int, client_ind: int,
                    clients_per_round: int) -> int:
    """``seed + ind + 1 + round · clients_per_round``."""
    return seed + client_ind + 1 + round_idx * clients_per_round


def derived_seed(*words: int) -> int:
    """One 63-bit seed from a tuple of integers (order matters), for
    streams keyed by more than one number, such as (seed, round)."""
    state = np.random.SeedSequence([int(w) for w in words])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device: Optional[Union[str, torch.device]] = "cpu"
              ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def client_generator(seed: int, round_idx: int, client_ind: int,
                     clients_per_round: int, device="cpu") -> torch.Generator:
    """The generator of one client's local work in one round, seeded with
    ``per_client_seed``: two (round, client) pairs that collide under the
    additive formula share a stream, as they do in the JAX package."""
    return generator(per_client_seed(seed, round_idx, client_ind,
                                     clients_per_round), device)


def sample_clients(seed: int, round_idx: int, nr_clients: int,
                   nr_per_round: int) -> torch.Tensor:
    """``nr_per_round`` of ``nr_clients`` client indices without
    replacement (int64, on the CPU), from a generator seeded with
    (seed, round): each round's draw is reproducible on its own, whatever
    rounds ran before it."""
    g = generator(derived_seed(seed, round_idx))
    return torch.randperm(nr_clients, generator=g)[:nr_per_round]
