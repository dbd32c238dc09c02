"""Fully-fused Adam apply: the hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/pallas_adam.py``, whose Pallas TPU
kernel ``_adam_kernel`` is replaced by ``csrc/adam.cu``: one launch over a
table of leaves (up to 48) that reads p, m, v, g and writes p, m, v in
place (the TPU kernel's ``input_output_aliases``), with the step's bias
corrections read from a device array at run time.

``FusedApplyAdam`` keeps the JAX class's surface: ``init`` / ``update``
(the plain rule, ``ops.adam.fused_adam``) and ``apply_gradients(params,
grads, state)``, the fused path that ``parallel.dp`` takes. Leaf routing is
the JAX package's (``_pallas_eligible``): fp32 leaves of at least 65,536
elements whose size is a multiple of 512 take the kernel; the rest (norm
scales, odd sizes) take ``adam_math``, so the same leaves take the
kernel in both packages.

``_adam_leaves_pallas`` launches the kernel once per table of CUDA leaves
and takes the plain rule (``_leaf_plain``) for CPU tensors only; a failed
build or launch raises. ``_adam_leaf_pallas`` (the JAX function's name) is
its one-leaf case. ``launches`` counts kernel launches: one per training
step, whatever the vocabulary.
"""

from __future__ import annotations

import ctypes

import torch

from . import _ext
from .adam import FusedAdamState, adam_math, bias_corrections, fused_adam
from ..device import resolve_device
from ..tree import tree_leaves

_LANES = 512          # leaf sizes the JAX kernel tiles as [rows, 512]
_MIN_PALLAS = 1 << 16  # leaves smaller than this stay on the plain rule

launches = 0


def _leaf_plain(p, m, v, g, c1, c2, *, lr, b1, b2, eps) -> None:
    """The plain rule (``adam_math``) on one leaf, applied in place."""
    (u,), (m_new,), (v_new,) = adam_math([g], [m], [v], c1, c2, lr=lr, b1=b1,
                                         b2=b2, eps=eps)
    with torch.no_grad():
        m.copy_(m_new)
        v.copy_(v_new)
        p.add_(u)


def _check_kernel_leaf(leaf) -> None:
    """What the kernel's bulk copies need of one leaf's p, m, v, g: dense,
    16-byte aligned, a positive multiple of 4 elements (16 bytes)."""
    n = leaf[0].numel()
    if n < 4 or n % 4:
        raise ValueError(f"fused Adam kernel needs a positive size divisible "
                         f"by 4, got {n}")
    for x in leaf:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("fused Adam kernel needs dense, 16-byte-aligned "
                             "tensors")


def _check_operands(ps, ms, vs, gs, corrections) -> torch.device:
    """The device of every operand, after checking it: fp32 p, m, v, g of one
    shape per leaf, all on one device, CPU or CUDA (where each leaf must
    also pass ``_check_kernel_leaf``), and fp32 ``[2]`` corrections there."""
    if not len(ps) == len(ms) == len(vs) == len(gs):
        raise ValueError("fused Adam takes as many m, v and g leaves as p")
    dev = ps[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused Adam runs on CUDA or CPU tensors, got {dev}")
    for leaf in zip(ps, ms, vs, gs):
        shape = leaf[0].shape
        for x in leaf:
            if (x.shape, x.dtype, x.device) != (shape, torch.float32, dev):
                raise ValueError("fused Adam takes fp32 p, m, v, g of one "
                                 "shape per leaf, all on one device")
        if dev.type == "cuda":
            _check_kernel_leaf(leaf)
    if (corrections.dtype != torch.float32 or corrections.shape != (2,)
            or corrections.device != dev):
        raise ValueError("corrections must be an fp32 [2] tensor on the "
                         "parameters' device")
    return dev


def _adam_leaves_pallas(ps, ms, vs, gs, corrections, *, lr, b1, b2, eps):
    """Every leaf's fused update, in place: one kernel launch per table of
    CUDA leaves (``ddl_adam_table_size()``, 48), the plain rule for CPU
    tensors. ``corrections`` is the fp32 ``[c1, c2]`` of this step."""
    global launches
    if not ps:
        return
    dev = _check_operands(ps, ms, vs, gs, corrections)
    if dev.type == "cpu":
        for p, m, v, g in zip(ps, ms, vs, gs):
            _leaf_plain(p, m, v, g, corrections[0], corrections[1], lr=lr,
                        b1=b1, b2=b2, eps=eps)
        return
    lib = _ext.library("adam")
    table = lib.ddl_adam_table_size()
    every = list(zip(ps, ms, vs, gs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first in range(0, len(every), table):
            leaves = every[first:first + table]
            ptrs = (ctypes.c_longlong * (4 * len(leaves)))(
                *(x.data_ptr() for leaf in leaves for x in leaf))
            counts = (ctypes.c_longlong * len(leaves))(
                *(leaf[0].numel() for leaf in leaves))
            err = lib.ddl_adam(ptrs, counts, len(leaves),
                               corrections.data_ptr(), lr, b1, 1.0 - b1, b2,
                               1.0 - b2, eps, stream)
            if err != 0:
                raise RuntimeError(f"adam: CUDA launch failed with "
                                   f"cudaError_t {err}")
            launches += 1


def _adam_leaf_pallas(p, m, v, g, corrections, *, lr, b1, b2, eps):
    """One eligible leaf's fused update, in place (``_adam_leaves_pallas``
    on one leaf). Returns ``(p, m, v)``."""
    _adam_leaves_pallas([p], [m], [v], [g], corrections, lr=lr, b1=b1, b2=b2,
                        eps=eps)
    return p, m, v


def smoke_check(atol: float = 1e-6, device=None) -> float:
    """Run the kernel once on one eligible leaf of 972 × 512 elements (the
    size of one stacked [6, 288, 288] block matrix, many blocks of threads)
    with the corrections of step 3, and hold p, m and v against the plain
    rule on the same inputs. Raises past ``atol``; returns the largest
    max|Δ|."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shape = (972 * _LANES,)
    draw = lambda: torch.randn(shape, generator=gen, device=dev)
    p, m, v, g = draw(), 0.1 * draw(), (0.1 * draw()).abs(), draw()
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    c1, c2 = bias_corrections(torch.tensor(3, device=dev), 0.9, 0.999)
    want = [x.clone() for x in (p, m, v)]
    _leaf_plain(*want, g, c1, c2, **hyper)
    got = _adam_leaf_pallas(p, m, v, g, torch.stack([c1, c2]), **hyper)
    worst = 0.0
    for name, a, b in zip(("p", "m", "v"), got, want):
        err = float((a - b).abs().max())
        if not err <= atol:      # NaN-safe: NaN fails the comparison
            raise AssertionError(f"fused Adam smoke: {name} max|Δ|={err:.3e} "
                                 f"> {atol} on {dev}")
        worst = max(worst, err)
    return worst


def _pallas_eligible(p, g) -> bool:
    return (p.dtype == torch.float32 and g.dtype == torch.float32
            and p.numel() >= _MIN_PALLAS and p.numel() % _LANES == 0)


class FusedApplyAdam:
    """Adam with a fused param+moment apply (see the module docstring).

    optax-compatible: ``.init(params)`` / ``.update(grads, state, params)``
    behave exactly like ``ops.adam.fused_adam``. The fast path is
    ``.apply_gradients(params, grads, state)``, which updates params and
    moments in place.
    """

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self._plain = fused_adam(learning_rate, b1, b2, eps)

    # ---- optax surface -------------------------------------------------
    def init(self, params) -> FusedAdamState:
        return self._plain.init(params)

    def update(self, grads, state, params=None):
        return self._plain.update(grads, state, params)

    # ---- fused fast path -----------------------------------------------
    def apply_gradients(self, params, grads, state: FusedAdamState):
        count = state.count + 1
        c1, c2 = bias_corrections(count, self.b1, self.b2)
        corrections = torch.stack([c1, c2])
        hyper = dict(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps)
        fused = []
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(grads)):
            if _pallas_eligible(p, g):
                fused.append((p.detach(), m, v, g))
            else:
                _leaf_plain(p, m, v, g.to(p.dtype), c1, c2, **hyper)
        if fused:
            _adam_leaves_pallas(*map(list, zip(*fused)), corrections, **hyper)
        return params, FusedAdamState(count, state.mu, state.nu)
