"""Vertical-FL model stack: counterpart of the JAX package's
``models/vfl_nets.py``, on the same trees.

Each party has a bottom MLP over its feature slice; the server's top MLP
classifies the concatenation of their outputs (``{"bottoms": [[...],
...], "top": [...]}``). ``bottoms_forward`` returns the per-party
activations that cross the cut layer, and the server side consumes only
their concatenation. The VFL-VAE hybrid (homework 2, exercise 3): client
encoders → concat → server VAE → synthetic latents split back per client
→ client decoders; loss Σ per-client mean squared error + KL / batch.

Dropout is live iff a ``torch.Generator`` is given. ``top_forward`` keeps
the reference's quirk: LeakyReLU after every layer, the output included,
and train-mode dropout on the output logits.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import nn
from ..device import resolve_device
from .vae import kl_divergence, reparameterize

NUM_CLASSES = 2
DROPOUT = 0.1


def init_bottom(generator: torch.Generator, in_dim: int, out_dim: int, *,
                device) -> list:
    """fc1 in→out, fc2 out→out (ReLU after each)."""
    return nn.mlp_init(generator, [in_dim, out_dim, out_dim], device=device)


def init_top(generator: torch.Generator, in_dim: int,
             num_classes: int = NUM_CLASSES, *, device) -> list:
    """concat → 128 → 256 → num_classes."""
    return nn.mlp_init(generator, [in_dim, 128, 256, num_classes],
                       device=device)


def init_vfl(generator: torch.Generator, feature_dims: Sequence[int], *,
             bottom_out_mult: int = 2, device=None) -> dict:
    """One bottom model per party (output width ``bottom_out_mult · d_i``)
    and the top, drawn in that order."""
    dev = resolve_device(device)
    bottoms = [init_bottom(generator, d, bottom_out_mult * d, device=dev)
               for d in feature_dims]
    top = init_top(generator, sum(bottom_out_mult * d for d in feature_dims),
                   device=dev)
    return {"bottoms": bottoms, "top": top}


def bottoms_forward(params: dict, xs: Sequence[torch.Tensor], *,
                    generator: Optional[torch.Generator] = None
                    ) -> List[torch.Tensor]:
    """Per-party forward: the activations that cross the cut layer, with
    dropout(0.1) on each party's output iff ``generator`` is given."""
    return [nn.dropout(nn.mlp(b, x, activation=nn.relu,
                              final_activation=nn.relu),
                       DROPOUT, generator=generator)
            for b, x in zip(params["bottoms"], xs)]


def top_forward(params: dict, cut: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The server's classifier over the concatenated activations:
    LeakyReLU after every layer including the output, and dropout(0.1) on
    the output iff ``generator`` is given (the reference's quirk, kept)."""
    h = nn.mlp(params["top"], cut, activation=nn.leaky_relu,
               final_activation=nn.leaky_relu)
    return nn.dropout(h, DROPOUT, generator=generator)


def vfl_forward(params: dict, xs: Sequence[torch.Tensor], *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full split-NN forward: concat the bottoms' outputs, classify."""
    cut = torch.cat(bottoms_forward(params, xs, generator=generator), dim=1)
    return top_forward(params, cut, generator=generator)


# ------------------------------------------------------- VFL-VAE hybrid

def init_vfl_vae(generator: torch.Generator, feature_dims: Sequence[int], *,
                 client_latent: int = 4, server_latent: int = 8,
                 enc_hidden: int = 16, device=None) -> dict:
    """Per-client encoders and decoders and the server VAE over the
    concatenated client latents, drawn in that order. ``client_latent``
    rides in the tree as a plain int."""
    dev = resolve_device(device)
    encoders = [nn.mlp_init(generator, [d, enc_hidden, client_latent],
                            device=dev) for d in feature_dims]
    decoders = [nn.mlp_init(generator, [client_latent, enc_hidden, d],
                            device=dev) for d in feature_dims]
    concat = client_latent * len(feature_dims)
    server = {
        "mu": nn.dense_init(generator, concat, server_latent, device=dev),
        "logvar": nn.dense_init(generator, concat, server_latent,
                                device=dev),
        "dec": nn.mlp_init(generator, [server_latent, concat], device=dev),
    }
    return {"encoders": encoders, "decoders": decoders, "server": server,
            "client_latent": client_latent}


def vfl_vae_forward(params: dict, xs: Sequence[torch.Tensor],
                    generator: Optional[torch.Generator] = None, *,
                    eps: Optional[torch.Tensor] = None
                    ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``(per-client reconstructions, mu, logvar)``; the reparameterization
    noise comes from ``generator`` or is ``eps``."""
    client_lat = [nn.mlp(e, x, final_activation=nn.relu)
                  for e, x in zip(params["encoders"], xs)]
    concat = torch.cat(client_lat, dim=1)                     # the upward wire
    mu = nn.dense(params["server"]["mu"], concat)
    logvar = nn.dense(params["server"]["logvar"], concat)
    z = reparameterize(mu, logvar, generator=generator, eps=eps)
    synth = nn.mlp(params["server"]["dec"], z)                # the downward wire
    lat = params["client_latent"]
    parts = [synth[:, i * lat:(i + 1) * lat] for i in range(len(xs))]
    recons = [nn.mlp(d, p) for d, p in zip(params["decoders"], parts)]
    return recons, mu, logvar


def vfl_vae_loss(recons: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                 mu: torch.Tensor, logvar: torch.Tensor):
    """Σ per-client mean squared error + KL / batch: ``(total, recon,
    kl)``."""
    recon = sum(torch.mean(torch.square(r - x)) for r, x in zip(recons, xs))
    kl = kl_divergence(mu, logvar) / mu.shape[0]
    return recon + kl, recon, kl
