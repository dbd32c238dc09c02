"""Tabular VAE for synthetic-data generation: counterpart of the JAX
package's ``models/vae.py``, on the same trees.

Encoder: ``dense → BatchNorm → ReLU`` per hidden width, then ``mu`` and
``logvar`` heads; decoder: the mirror image from the latent, then
``out``. Parameters and BatchNorm running statistics are two trees,
``params`` and ``state`` (``{"enc": [...], "dec": [...]}``), both passed
and returned explicitly. The reparameterization takes its noise from a
``torch.Generator``, or a given ``eps`` (the form the cross-framework
tests use, since ``jax.random`` and torch cannot draw alike).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import nn
from ..config import VAEConfig
from ..device import resolve_device


def init(generator: torch.Generator, cfg: VAEConfig, device=None
         ) -> Tuple[dict, dict]:
    """``(params, state)``: dense layers drawn in the order encoder,
    ``mu``, ``logvar``, decoder, ``out``; BatchNorm at scale 1, bias 0,
    running mean 0 and variance 1."""
    dev = resolve_device(device)
    dims = [cfg.input_dim, *cfg.hidden_dims]
    rdims = [cfg.latent_dim, *reversed(cfg.hidden_dims)]
    params, state = {"enc": [], "dec": []}, {"enc": [], "dec": []}

    def stack(part, d):
        for i in range(len(d) - 1):
            bn_p, bn_s = nn.batchnorm_init(d[i + 1], device=dev)
            params[part].append({"lin": nn.dense_init(
                generator, d[i], d[i + 1], device=dev), "bn": bn_p})
            state[part].append(bn_s)

    stack("enc", dims)
    params["mu"] = nn.dense_init(generator, dims[-1], cfg.latent_dim,
                                 device=dev)
    params["logvar"] = nn.dense_init(generator, dims[-1], cfg.latent_dim,
                                     device=dev)
    stack("dec", rdims)
    params["out"] = nn.dense_init(generator, rdims[-1], cfg.input_dim,
                                  device=dev)
    return params, state


def _stack(layers, states, x, *, train):
    new_states = []
    for layer, st in zip(layers, states):
        x = nn.dense(layer["lin"], x)
        x, st2 = nn.batchnorm(layer["bn"], st, x, train=train)
        x = nn.relu(x)
        new_states.append(st2)
    return x, new_states


def encode(params, state, x, *, train: bool):
    h, enc_state = _stack(params["enc"], state["enc"], x, train=train)
    mu = nn.dense(params["mu"], h)
    logvar = nn.dense(params["logvar"], h)
    return mu, logvar, {**state, "enc": enc_state}


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mu + exp(logvar / 2) · eps``, eps ~ N(0, I) drawn from
    ``generator`` on its device unless given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                          device=generator.device).to(mu.device)
    return mu + torch.exp(0.5 * logvar) * eps


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Summed KL(q(z|x) || N(0, I)), shared by the VAE and VFL-VAE losses."""
    return -0.5 * torch.sum(1 + logvar - torch.square(mu) - torch.exp(logvar))


def decode(params, state, z, *, train: bool):
    h, dec_state = _stack(params["dec"], state["dec"], z, train=train)
    return nn.dense(params["out"], h), {**state, "dec": dec_state}


def apply(params, state, x, generator: Optional[torch.Generator] = None, *,
          train: bool, eps: Optional[torch.Tensor] = None):
    """Full VAE pass: ``(recon, mu, logvar, new_state)``. In training ``z``
    is reparameterized (noise from ``generator`` or ``eps``); in
    evaluation ``z = mu``."""
    mu, logvar, state = encode(params, state, x, train=train)
    z = (reparameterize(mu, logvar, generator=generator, eps=eps) if train
         else mu)
    recon, state = decode(params, state, z, train=train)
    return recon, mu, logvar, state


def loss_fn(recon, x, mu, logvar):
    """Summed squared error plus KL: ``(total, mse, kld)``."""
    mse = torch.sum(torch.square(recon - x))
    kld = kl_divergence(mu, logvar)
    return mse + kld, mse, kld


def sample(generator: torch.Generator, params, state, n: int,
           latent_dim: int) -> torch.Tensor:
    """``n`` synthetic rows: decode z ~ N(0, I) (drawn from ``generator``
    on its device) in evaluation mode."""
    dev = params["out"]["w"].device
    z = torch.randn((n, latent_dim), generator=generator,
                    device=generator.device).to(dev)
    out, _ = decode(params, state, z, train=False)
    return out
