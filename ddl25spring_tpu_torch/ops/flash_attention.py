"""Causal flash attention: the hand-written CUDA forward and its plain version.

Counterpart of the JAX package's ``ops/flash_attention.py``, whose Pallas
TPU forward kernels ``_fwd_kernel`` (row-major operands) and
``_fwd_kernel_t`` (dh-major operands) are replaced here by one CUDA kernel,
``csrc/flash_fwd.cu``, that reads either layout through strides. The
public function keeps the JAX API: ``[B, T, H, Dh]`` in and out.

- ``flash_attention`` launches the kernel for CUDA tensors and takes the
  plain version, ``flash_attention_reference``, for CPU tensors only. A
  failed build or launch raises; nothing falls back.
- ``flash_attention_fwd`` returns the kernel's ``(out, lse)``.
- The backward (the TPU package's dQ and dK/dV kernels) belongs to the
  training slice and is not ported yet: ``_FlashAttnFwd.backward`` raises.

``launches`` counts kernel launches; ``chip_smoke.py`` zeroes it before it
drives the model and reads it after, to show the path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _ext

_NEG_INF = -1e30

launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: q, k, v ``[B, T, H, Dh]`` →
    ``(out [B, T, H, Dh]`` in q's dtype, ``lse [B·H, T]`` fp32``)``.
    fp32 softmax with scale ``1/sqrt(Dh)``; masked scores are a finite
    ``-1e30`` as in the TPU kernel."""
    b, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale       # [B, H, T, T]
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).reshape(b * h, t)
    return out.to(q.dtype).permute(0, 2, 1, 3), lse


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v are on different devices")


def _launch(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
            o4: torch.Tensor, lse: torch.Tensor, *, causal: bool) -> None:
    """Launch the CUDA kernel. Operands are views indexed ``[B, H, T, Dh]``
    in any memory layout (the kernel reads their strides); ``lse`` is a
    dense fp32 ``[B·H, T]``."""
    global launches
    b, h, t, dh = q4.shape
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q4.dtype}")
    if not 1 <= dh <= 128:
        raise ValueError(f"flash kernel takes head dims 1..128, got {dh}")
    for x in (k4, v4, o4):
        if (x.shape, x.dtype, x.device) != (q4.shape, q4.dtype, q4.device):
            raise ValueError("flash kernel operands must share shape, dtype "
                             "and device")
    if not (q4.is_cuda and lse.is_cuda and lse.dtype == torch.float32
            and lse.shape == (b * h, t) and lse.is_contiguous()):
        raise ValueError("flash kernel needs CUDA operands and a dense fp32 "
                         "[B*H, T] lse")
    lib = _ext.library("flash_fwd")
    strides = (ctypes.c_longlong * 16)(
        *(s for x in (q4, k4, v4, o4) for s in x.stride()))
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = lib.ddl_flash_fwd(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            lse.data_ptr(), int(q4.dtype == torch.bfloat16), b, h, t, dh,
            ctypes.cast(strides, ctypes.c_void_p), 1.0 / math.sqrt(dh),
            int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd: CUDA launch failed with cudaError_t "
                           f"{err}")
    launches += 1


def kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dh_major: bool):
    """q, k, v ``[B, T, H, Dh]`` → the kernel's ``[B, H, T, Dh]`` views of
    them and of a new output. ``dh_major=False`` views the tensors where
    they lie (no copy); ``dh_major=True`` first lays each out as a dense
    ``[B·H, Dh, T]`` (the TPU package's ``_layout_t``), output included."""
    b, t, h, dh = q.shape
    if dh_major:
        ops = [x.permute(0, 2, 3, 1).contiguous().transpose(2, 3)
               for x in (q, k, v)]
        o4 = torch.empty(b, h, dh, t, dtype=q.dtype,
                         device=q.device).transpose(2, 3)
    else:
        ops = [x.permute(0, 2, 1, 3) for x in (q, k, v)]
        o4 = torch.empty(b, t, h, dh, dtype=q.dtype,
                         device=q.device).permute(0, 2, 1, 3)
    return (*ops, o4)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, dh_major: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on q, k, v ``[B, T, H, Dh]`` → ``(out [B, T, H, Dh],
    lse [B·H, T] fp32)``, reading the operands in the layout
    ``dh_major`` selects (``kernel_operands``)."""
    _check_inputs(q, k, v)
    b, t, h, _ = q.shape
    q4, k4, v4, o4 = kernel_operands(q, k, v, dh_major)
    lse = torch.empty(b * h, t, dtype=torch.float32, device=q.device)
    _launch(q4, k4, v4, o4, lse, causal=causal)
    return o4.permute(0, 2, 1, 3), lse


class _FlashAttnFwd(torch.autograd.Function):
    """The kernel as an autograd node. Only the forward is ported."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, dh_major: bool):
        out, _ = flash_attention_fwd(q, k, v, causal=causal,
                                     dh_major=dh_major)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash attention backward (dQ, dK/dV kernels) is not ported yet: "
            "ROADMAP.md, queue B, kernels K3-K6 (training slice)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, dh_major: bool = False
                    ) -> torch.Tensor:
    """Fused causal attention over q, k, v ``[B, T, H, Dh]`` → ``[B, T, H,
    Dh]``: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``block_q``/``block_k`` are accepted for parity with the JAX
    API and not used: the CUDA kernel picks its own tiles (64 queries by 64
    keys) and masks the ragged edge itself, so nothing is padded.
    ``dh_major`` selects the operand layout the kernel reads (see
    ``flash_attention_fwd``); it changes no result."""
    del block_q, block_k
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)[0]
    return _FlashAttnFwd.apply(q, k, v, causal, dh_major)
