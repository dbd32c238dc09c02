"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA: the port's entry points run on the card unless
    the caller asks for the CPU. Raises when CUDA is asked for (or implied)
    and no CUDA device is present, rather than quietly running elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on CUDA by default; "
            "pass device='cpu' to run its plain PyTorch paths on the CPU")
    return dev


def check_on_device(tensor: torch.Tensor, device: torch.device,
                    what: str) -> None:
    """Raise unless ``tensor`` lives on ``device`` (an index-less device
    such as ``cuda`` matches any of its type)."""
    d = tensor.device
    if d.type != device.type or (device.index is not None
                                 and d.index != device.index):
        raise ValueError(f"{what} is on {d} but the call runs on {device}: "
                         f"move it first (e.g. params_from_jax(..., "
                         f"device={str(device)!r}))")
