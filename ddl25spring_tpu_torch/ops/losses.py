"""Loss functions: counterpart of the JAX package's ``ops/losses.py``.

``causal_lm_loss`` shifts inside the loss (callers pass the same token
batch they fed the model). ``fused_linear_cross_entropy`` is the training
head: the mean cross-entropy of ``softmax(h @ w)`` without the ``[N, V]``
logits ever existing, as an autograd node over row chunks.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy. logits ``[..., C]``, integer labels
    ``[...]``; with ``mask``, the mean over the rows it weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                   ignore_index: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy: logits ``[B, T, V]`` vs tokens ``[B, T]``,
    predicting ``tokens[:, 1:]`` from ``logits[:, :-1]``."""
    shift_labels = tokens[:, 1:]
    mask = None if ignore_index is None else shift_labels != ignore_index
    return cross_entropy_loss(logits[:, :-1], shift_labels, mask)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 product of ``a`` and ``b``'s values (the JAX package's
    ``preferred_element_type=float32``): on CUDA, bf16 operands go to a
    bf16 product that accumulates and returns fp32; elsewhere both are
    upcast first, which gives the same values."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedLinearCE(torch.autograd.Function):
    """Σ mask·(lse(h@w) − (h@w)[label]) over ``chunk``-row tiles. The
    forward keeps only each row's lse; the backward recomputes each
    ``[chunk, V]`` logit tile and forms (softmax − one-hot)·mask·g, so the
    full ``[N, V]`` logits exist in neither pass (the JAX package's
    ``jax.checkpoint`` inside a ``lax.scan``)."""

    @staticmethod
    def forward(ctx, h, w, labels, mask, chunk: int):
        n = h.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=h.device)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i0 in range(0, n, chunk):
            logits = _mm_f32(h[i0:i0 + chunk], w)
            lse_c = torch.logsumexp(logits, dim=-1)
            lab = torch.gather(logits, 1, labels[i0:i0 + chunk, None])[:, 0]
            total = total + ((lse_c - lab) * mask[i0:i0 + chunk]).sum()
            lse[i0:i0 + chunk] = lse_c
        ctx.save_for_backward(h, w, labels, mask, lse)
        ctx.chunk = chunk
        return total

    @staticmethod
    def backward(ctx, g):
        h, w, labels, mask, lse = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i0 in range(0, h.shape[0], chunk):
            hc = h[i0:i0 + chunk]
            logits = _mm_f32(hc, w)
            p = torch.exp(logits - lse[i0:i0 + chunk, None])
            p.scatter_add_(1, labels[i0:i0 + chunk, None],
                           torch.full_like(lse[i0:i0 + chunk, None], -1.0))
            # The cotangent of the fp32 logits, rounded to the compute
            # dtype for the two products (the JAX transpose returns the
            # gradient of each bf16 operand in bf16).
            dlogits = (p * (mask[i0:i0 + chunk] * g)[:, None]).to(h.dtype)
            dh[i0:i0 + chunk] = _mm_f32(dlogits, w.t()).to(h.dtype)
            dw += _mm_f32(hc.t(), dlogits)
        return dh, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               mask: Optional[torch.Tensor] = None,
                               chunk_size: int = 512) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(h @ w)`` vs ``labels`` over the rows
    ``mask`` weights, without the ``[N, V]`` logits: each ``[chunk_size,
    V]`` tile is computed in fp32, reduced to its row lse and label logit,
    and recomputed in the backward.

    h ``[N, D]`` (compute dtype), w ``[D, V]`` (cast to h's dtype, so its
    gradient comes back in that dtype before it is upcast), labels int
    ``[N]``, mask optional ``[N]`` weights. Returns an fp32 scalar."""
    n = h.shape[0]
    mask = (torch.ones(n, dtype=torch.float32, device=h.device)
            if mask is None else mask.float())
    total = _FusedLinearCE.apply(h, w.to(h.dtype), labels.long(), mask,
                                 chunk_size)
    return total / torch.clamp(mask.sum(), min=1.0)
