"""Functional NN primitives (counterparts of the JAX package's ``nn``):
init/apply pairs over plain dicts of tensors.

Conventions kept from the JAX package: dense weights are ``[in, out]`` and
applied as ``x @ w``; an MLP is a list of dense layers; convolutions are
NCHW with OIHW weights (torch's own layout) and ``VALID`` padding;
BatchNorm takes and returns its running statistics as an explicit state
tree; stochastic layers take their randomness explicitly, as a
``torch.Generator`` or a precomputed keep-mask.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _uniform(shape, bound: float, generator: torch.Generator,
             device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """U(-bound, bound) drawn on the generator's device, then moved."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * (2 * bound) - bound).to(device=device, dtype=dtype)


# ---------------------------------------------------------------- dense

def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               device: torch.device, dtype: torch.dtype = torch.float32
               ) -> dict:
    """Kaiming-uniform, bound 1/sqrt(in_dim), as the JAX init."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform((in_dim, out_dim), bound, generator, device, dtype),
            "b": _uniform((out_dim,), bound, generator, device, dtype)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------------------------------------------------------- conv2d

def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                kernel: int, *, device: torch.device,
                dtype: torch.dtype = torch.float32) -> dict:
    bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
    return {"w": _uniform((out_ch, in_ch, kernel, kernel), bound, generator,
                          device, dtype),
            "b": _uniform((out_ch,), bound, generator, device, dtype)}


def conv2d(params: dict, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """x: [N, C, H, W], weight [O, I, kh, kw], ``VALID`` padding."""
    return F.conv2d(x, params["w"], params["b"], stride=stride)


def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: Optional[int] = None) -> torch.Tensor:
    return F.max_pool2d(x, window, stride or window)


relu = torch.relu


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Slope 0.01 below zero, as ``jax.nn.leaky_relu``'s default."""
    return F.leaky_relu(x, 0.01)


# ---------------------------------------------------------------- mlp

def mlp_init(generator: torch.Generator, dims: Sequence[int], *,
             device: torch.device, dtype: torch.dtype = torch.float32
             ) -> list:
    """Stack of dense layers, dims = [in, h1, ..., out], drawn in order."""
    return [dense_init(generator, dims[i], dims[i + 1], device=device,
                       dtype=dtype) for i in range(len(dims) - 1)]


def mlp(params: list, x: torch.Tensor, *, activation: Callable = relu,
        final_activation: Optional[Callable] = None) -> torch.Tensor:
    """``activation`` between layers, ``final_activation`` (if any) after
    the last."""
    for i, layer in enumerate(params):
        x = dense(layer, x)
        if i < len(params) - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


# ---------------------------------------------------------------- batchnorm

def batchnorm_init(dim: int, dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None
                   ) -> Tuple[dict, dict]:
    """``(params, state)``: scale 1 and bias 0; running mean 0 and
    variance 1."""
    ones = lambda: torch.ones(dim, dtype=dtype, device=device)
    zeros = lambda: torch.zeros(dim, dtype=dtype, device=device)
    return ({"scale": ones(), "bias": zeros()},
            {"mean": zeros(), "var": ones()})


def batchnorm(params: dict, state: dict, x: torch.Tensor, *, train: bool,
              momentum: float = 0.1, eps: float = 1e-5
              ) -> Tuple[torch.Tensor, dict]:
    """BatchNorm over the batch axis of ``x [N, D]``. In training it
    normalizes with the batch's biased variance and moves the running
    variance toward the unbiased one (× n/(n−1)); the new state carries
    no gradient. In evaluation it normalizes with the running state."""
    if train:
        mean = x.mean(0)
        var = x.var(0, unbiased=False)
        n = x.shape[0]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) / torch.sqrt(var + eps)
    return y * params["scale"] + params["bias"], new_state


# ---------------------------------------------------------------- rmsnorm

def rmsnorm_init(dim: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    # The reduction runs in fp32 and is cast back, for bf16 activations.
    x32 = x.float()
    rms = torch.sqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return (x32 / rms).to(x.dtype) * params["scale"].to(x.dtype)


# ---------------------------------------------------------------- dropout

def dropout_keep(generator: torch.Generator, shape, rate: float
                 ) -> torch.Tensor:
    """A bool keep-mask: each entry kept with probability 1 − rate (a
    uniform draw below 1 − rate, as ``jax.random.bernoulli``), drawn on the
    generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout: kept entries scaled by 1/(1 − rate), the others
    zero. The keep-mask is ``keep`` when given, else drawn from
    ``generator``; with neither (or ``rate == 0``) ``x`` passes through."""
    if rate == 0.0 or (keep is None and generator is None):
        return x
    if keep is None:
        keep = dropout_keep(generator, x.shape, rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
