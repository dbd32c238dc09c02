"""Functional NN primitives the Llama needs (counterparts of the JAX
package's ``nn``): init/apply pairs over plain dicts of tensors."""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_init(dim: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    # The reduction runs in fp32 and is cast back, for bf16 activations.
    x32 = x.float()
    rms = torch.sqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return (x32 / rms).to(x.dtype) * params["scale"].to(x.dtype)
