"""Causal flash attention: hand-written CUDA forward and backward kernels and
their plain versions.

Counterpart of the JAX package's ``ops/flash_attention.py``. Its Pallas TPU
kernels are replaced by three CUDA kernels that each read either operand
layout through strides: the forward ``csrc/flash_fwd.cu`` (``_fwd_kernel``
and ``_fwd_kernel_t``), and the backward ``csrc/flash_bwd.cu``, one dQ
kernel (``_dq_kernel``, ``_dq_kernel_t``) and one dK/dV kernel
(``_dkv_kernel``, ``_dkv_kernel_t``). In bf16 all three run on the tensor
cores (``mma.sync`` through ``csrc/mma_bf16.cuh``, P and dS rounded to bf16
before their products, fp32 accumulation). In fp32 all three run on the
tensor cores in 3xTF32 (``csrc/mma_tf32.cuh``: three TF32 products per fp32
one, within a few 1e-6 of fp32). The kernels take head dims 1 to
``MAX_HEAD_DIM``. The public function keeps the JAX API: ``[B, T, H, Dh]``
in and out, differentiable.

- ``flash_attention`` runs the kernels for CUDA tensors (forward, and on
  the backward pass dQ and dK/dV) and the plain version,
  ``flash_attention_reference``, for CPU tensors only, where autograd
  differentiates it. A failed build or launch raises; nothing falls back.
- ``flash_attention_fwd`` returns the forward kernel's ``(out, lse)``;
  ``flash_attention_bwd`` runs the two backward kernels;
  ``flash_attention_bwd_reference`` does their arithmetic in plain PyTorch.

``launches``, ``dq_launches`` and ``dkv_launches`` count the launches of
the three kernels; ``chip_smoke.py`` zeroes them before it drives the model
and reads them after, to show the path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _ext

_NEG_INF = -1e30
# The head dims the CUDA kernels take (csrc/flash_fwd.cu, csrc/flash_bwd.cu):
# the wrappers refuse others, and models/llama.py routes "auto" by it.
MAX_HEAD_DIM = 128

launches = 0        # forward kernel
dq_launches = 0     # backward dQ kernel
dkv_launches = 0    # backward dK/dV kernel


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


def kernel_takes(head_dim: int) -> bool:
    """Whether the CUDA kernels take heads of ``head_dim``:
    ``1 <= head_dim <= MAX_HEAD_DIM``."""
    return 1 <= head_dim <= MAX_HEAD_DIM


def _check_head_dim(dh: int, what: str) -> None:
    if not kernel_takes(dh):
        raise ValueError(f"{what} takes head dims 1..{MAX_HEAD_DIM} "
                         f"(MAX_HEAD_DIM), got {dh}")


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
    _check_head_dim(dh, "flash kernel")
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


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, dh_major: bool):
    """Launch the forward kernel: ``(q4, k4, v4, out, lse)``, the operand
    views it read (which the backward reads again), ``out [B, T, H, Dh]``
    and ``lse [B·H, T]``."""
    _check_inputs(q, k, v)
    b, t, h, _ = q.shape
    q4, k4, v4, o4 = kernel_operands(q, k, v, dh_major)
    lse = torch.empty(b * h, t, dtype=torch.float32, device=q.device)
    _launch(q4, k4, v4, o4, lse, causal=causal)
    return q4, k4, v4, o4.permute(0, 2, 1, 3), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, dh_major: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on q, k, v ``[B, T, H, Dh]`` → ``(out [B, T, H, Dh],
    lse [B·H, T] fp32)``, reading the operands in the layout
    ``dh_major`` selects (``kernel_operands``)."""
    return _fwd(q, k, v, causal=causal, dh_major=dh_major)[3:]


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernels, step for step: q, k,
    v, out, do ``[B, T, H, Dh]`` and the forward's ``lse [B·H, T]`` →
    ``(dq, dk, dv)`` ``[B, T, H, Dh]`` in q's dtype. fp32 throughout:
    P = exp(S − lse) recomputed, Δ = rowsum(dO∘O), dS = P∘(dO·Vᵀ − Δ)·scale,
    dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO."""
    b, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, of, dof = (x.float().permute(0, 2, 1, 3)
                           for x in (q, k, v, out, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale       # [B, H, T, T]
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    if causal:
        pos = torch.arange(t, device=q.device)
        p = torch.where(pos[:, None] >= pos[None, :], p, torch.zeros_like(p))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    grads = (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
             torch.matmul(p.transpose(-1, -2), dof))
    return tuple(g.to(q.dtype).permute(0, 2, 1, 3) for g in grads)


def _launch_bwd(fn_name: str, ops, grads, lse: torch.Tensor,
                delta: torch.Tensor, *, causal: bool) -> None:
    """Launch one backward kernel. ``ops`` are q, k, v, dO and ``grads``
    the gradient outputs, all views indexed ``[B, H, T, Dh]`` in any
    layout; ``lse`` and ``delta`` are dense fp32 ``[B·H, T]``."""
    q4 = ops[0]
    b, h, t, dh = q4.shape
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash backward takes float32 or bfloat16, got "
                        f"{q4.dtype}")
    _check_head_dim(dh, "flash backward")
    for x in (*ops, *grads):
        if (x.shape, x.dtype, x.device) != (q4.shape, q4.dtype, q4.device):
            raise ValueError("flash backward operands must share shape, "
                             "dtype and device")
    for x in (lse, delta):
        if not (x.is_cuda and x.dtype == torch.float32
                and x.shape == (b * h, t) and x.is_contiguous()):
            raise ValueError("flash backward needs CUDA operands and dense "
                             "fp32 [B*H, T] lse and delta")
    if not q4.is_cuda:
        raise ValueError(f"flash backward needs CUDA operands, got "
                         f"{q4.device}")
    lib = _ext.library("flash_bwd")
    tensors = (*ops, *grads)
    strides = (ctypes.c_longlong * (4 * len(tensors)))(
        *(s for x in tensors for s in x.stride()))
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = getattr(lib, fn_name)(
            *(x.data_ptr() for x in ops), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in grads), int(q4.dtype == torch.bfloat16),
            b, h, t, dh, ctypes.cast(strides, ctypes.c_void_p),
            1.0 / math.sqrt(dh), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def flash_attention_bwd(q4: torch.Tensor, k4: torch.Tensor,
                        v4: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA dQ and dK/dV kernels. ``q4, k4, v4`` are the forward
    kernel's ``[B, H, T, Dh]`` operand views (either layout,
    ``kernel_operands``); ``out`` and ``do`` are ``[B, T, H, Dh]`` in any
    strides (``do`` is read where it lies); ``lse [B·H, T]`` is the
    forward's. Δ = rowsum(dO∘O) is a plain reduction here, as in the JAX
    package. Returns dense ``[B, T, H, Dh]`` gradients in q's dtype."""
    global dq_launches, dkv_launches
    b, h, t, dh = q4.shape
    if do.stride(-1) != 1:
        # The bf16 kernels read each operand with its dims or its positions
        # at stride 1; a cotangent broadcast from a sum has neither.
        do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
    # [B·H, T], dense: at B = 1 the reshape is a strided view.
    delta = delta.reshape(b * h, t).contiguous()
    dq, dk, dv = (torch.empty(b, t, h, dh, dtype=q4.dtype, device=q4.device)
                  for _ in range(3))
    ops = (q4, k4, v4, do.permute(0, 2, 1, 3))
    dq4, dk4, dv4 = (g.permute(0, 2, 1, 3) for g in (dq, dk, dv))
    _launch_bwd("ddl_flash_bwd_dq", ops, (dq4,), lse, delta, causal=causal)
    dq_launches += 1
    _launch_bwd("ddl_flash_bwd_dkv", ops, (dk4, dv4), lse, delta,
                causal=causal)
    dkv_launches += 1
    return dq, dk, dv


class _FlashAttnFwd(torch.autograd.Function):
    """The kernels as an autograd node: the forward kernel, whose operand
    views (in the layout it read), output and ``lse`` are saved for the
    backward's dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, dh_major: bool):
        q4, k4, v4, out, lse = _fwd(q, k, v, causal=causal,
                                    dh_major=dh_major)
        ctx.save_for_backward(q4, k4, v4, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q4, k4, v4, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q4, k4, v4, out, lse, grad_out,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, dh_major: bool = False
                    ) -> torch.Tensor:
    """Fused causal attention over q, k, v ``[B, T, H, Dh]`` → ``[B, T, H,
    Dh]``, differentiable: the CUDA kernels for CUDA tensors (the forward,
    and dQ and dK/dV on the backward pass), the plain version for CPU
    tensors. ``block_q``/``block_k`` are accepted for parity with the JAX
    API and not used: the CUDA kernels pick their own tiles (64 queries by
    64 keys) and mask the ragged edge themselves, so nothing is padded.
    ``dh_major`` selects the operand layout the kernel reads (see
    ``flash_attention_fwd``); it changes no result."""
    del block_q, block_k
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)[0]
    return _FlashAttnFwd.apply(q, k, v, causal, dh_major)
