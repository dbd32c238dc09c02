"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """Full fp32 matrix products and convolutions inside the block:
    TF32 off for cuBLAS and cuDNN (PyTorch lets cuDNN use TF32 by
    default), the previous settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
