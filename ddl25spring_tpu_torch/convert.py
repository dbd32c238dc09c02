"""Bridge between the JAX package's trees and the port's: the
``init_llama`` parameter tree and the port's ``Llama`` (a name-for-name
copy of numpy arrays, with no transposes: both sides store weights
``[in, out]`` with blocks stacked on ``[L]``), the MoE model's tree
(``init_moe_llama``: the same, with the router and the expert bank; and
an expert shard's slice of it), the MNIST CNN's tree (both
sides store conv weights OIHW and dense weights ``[in, out]``), the
tabular trees (the classifier, the VAE's parameters and BatchNorm state,
VFL and VFL-VAE: the same lists and dicts of ``{"w" [in, out], "b" [out]}``
layers on both sides, checked against a tree of the same model; the
VFL-VAE's ``client_latent`` stays a plain int), and the optimizer states:
Adam's (``count``, ``mu``, ``nu``) of JAX's ``FusedAdamState`` or optax's
``adam`` and the port's ``FusedAdamState``, the master-weight Adam's
``MasterAdamState`` (``count``, ``mu``, ``nu``, ``master``), and a ZeRO-1
state's moments (JAX's ``[n·local]`` vectors, sharded over the ``data``
axis, as one slice per rank)."""

from __future__ import annotations

import numpy as np
import torch

from .config import LlamaConfig, MoEConfig
from .device import resolve_device
from .models.llama import Llama, as_tree
from .ops.adam import FusedAdamState
from .ops.mixed_precision import MasterAdamState
from .tree import tree_map


def _expected_shapes(cfg: LlamaConfig) -> dict:
    d, f, n, v = cfg.dmodel, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    blocks = {k: (n, d, d) for k in ("wq", "wk", "wv", "wo")}
    blocks.update(attn_norm={"scale": (n, d)}, mlp_norm={"scale": (n, d)},
                  w_gate=(n, d, f), w_up=(n, d, f), w_down=(n, f, d))
    return {"embed": (v, d), "blocks": blocks, "final_norm": {"scale": (d,)},
            "lm_head": (d, v)}


def _moe_expected_shapes(cfg: MoEConfig) -> dict:
    base = cfg.base
    d, f, e, n = base.dmodel, base.ffn_dim, cfg.n_experts, base.n_layers
    shapes = _expected_shapes(base)
    shapes["blocks"].update(router=(n, d, e), w_gate=(n, e, d, f),
                            w_up=(n, e, d, f), w_down=(n, e, f, d))
    return shapes


# The expert bank's leaves: sliced on their ``[E]`` axis (dim 1 after the
# stacked-layer dim) under expert parallelism.
MOE_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


_MNIST_SHAPES = {
    "conv1": {"w": (32, 1, 3, 3), "b": (32,)},
    "conv2": {"w": (64, 32, 3, 3), "b": (64,)},
    "fc1": {"w": (9216, 128), "b": (128,)},
    "fc2": {"w": (128, 10), "b": (10,)},
}


def _check_tree(tree, like, path="") -> None:
    """Raise unless ``tree`` has ``like``'s dicts (same keys), lists (same
    lengths) and leaf shapes. A leaf of ``like`` is an array, a tensor or a
    shape tuple; an int leaf (the VFL-VAE's ``client_latent``) must be
    equal."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"params{path}: keys {got} != {sorted(like)}")
        for k in like:
            _check_tree(tree[k], like[k], f"{path}.{k}")
    elif isinstance(like, list):
        if not isinstance(tree, list) or len(tree) != len(like):
            raise ValueError(f"params{path}: not a list of {len(like)}")
        for i, (t, l) in enumerate(zip(tree, like)):
            _check_tree(t, l, f"{path}[{i}]")
    elif isinstance(like, (int, np.integer)):
        if tree != like:
            raise ValueError(f"params{path}: {tree!r} != {like}")
    else:
        want = like if isinstance(like, tuple) else tuple(np.shape(like))
        if tuple(np.shape(tree)) != want:
            raise ValueError(f"params{path}: shape {tuple(np.shape(tree))} "
                             f"!= {want}")


def params_from_jax(tree: dict, cfg: LlamaConfig, device=None) -> Llama:
    """JAX ``init_llama`` tree (numpy arrays, or anything ``np.asarray``
    takes) → ``Llama`` on ``device``, dtypes kept. Raises on a tree that
    does not fit ``cfg``."""
    dev = resolve_device(device)
    _check_tree(tree, _expected_shapes(cfg))
    return Llama(cfg, tree_map(lambda x: _to_torch(x).to(dev), tree))


def moe_params_from_jax(tree: dict, cfg: MoEConfig, device=None, *,
                        expert_shard=None) -> dict:
    """JAX ``init_moe_llama`` tree (numpy arrays, or anything
    ``np.asarray`` takes) → the port's MoE tree on ``device``, dtypes
    kept. Raises on a tree that does not fit ``cfg`` (router ``[L, D,
    E]``, experts ``[L, E, D, F]`` / ``[L, E, F, D]``). ``expert_shard =
    (ep, index)``: the expert leaves keep shard ``index``'s ``E/ep``
    experts only (expert parallelism's slice of the bank)."""
    dev = resolve_device(device)
    _check_tree(tree, _moe_expected_shapes(cfg))
    out = tree_map(lambda x: _to_torch(x).to(dev), tree)
    if expert_shard is not None:
        ep, index = expert_shard
        if cfg.n_experts % ep:
            raise ValueError(f"{cfg.n_experts} experts do not split over an "
                             f"expert axis of {ep}")
        per = cfg.n_experts // ep
        for name in MOE_EXPERT_LEAVES:
            out["blocks"][name] = out["blocks"][name][
                :, index * per:(index + 1) * per].clone()
    return out


def moe_params_to_numpy(params: dict, cfg: MoEConfig) -> dict:
    """The port's whole MoE tree → nested dict of numpy arrays in the JAX
    tree's layout, checked against ``cfg``."""
    _check_tree(params, _moe_expected_shapes(cfg))
    return tree_map(_to_numpy, params)


def mnist_params_from_jax(tree: dict, device=None) -> dict:
    """JAX ``mnist_cnn.init`` tree (numpy arrays, or anything
    ``np.asarray`` takes) → the port's tree on ``device``, dtypes kept.
    Raises on a tree of other names or shapes."""
    dev = resolve_device(device)
    _check_tree(tree, _MNIST_SHAPES)
    return tree_map(lambda x: _to_torch(x).to(dev), tree)


def mnist_params_to_numpy(params: dict) -> dict:
    """The port's MNIST CNN tree → nested dict of numpy arrays."""
    _check_tree(params, _MNIST_SHAPES)
    return tree_map(_to_numpy, params)


def tree_from_numpy(tree, like, device=None):
    """A JAX tree of the tabular models (numpy arrays, or anything
    ``np.asarray`` takes) → the port's tree on ``device``, dtypes kept;
    int leaves stay ints. Raises unless ``tree`` has ``like``'s layout:
    ``like`` is a tree of the same model, such as the port's own init."""
    _check_tree(tree, like)
    dev = resolve_device(device)
    return tree_map(lambda x: int(x) if isinstance(x, (int, np.integer))
                    else _to_torch(x).to(dev), tree)


def tree_to_numpy(tree):
    """The port's tree → the same tree of numpy arrays (ints stay)."""
    return tree_map(lambda x: int(x) if isinstance(x, (int, np.integer))
                    else _to_numpy(x), tree)


def _to_torch(x) -> torch.Tensor:
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":          # ml_dtypes' bf16, unknown to torch
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy().copy()


def params_to_numpy(params) -> dict:
    """``Llama`` (or its tree) → nested dict of numpy arrays in the JAX
    tree's layout (bf16 leaves come back as fp32, which numpy lacks)."""
    return tree_map(_to_numpy, as_tree(params))


def _adam_fields(state):
    """The ``(count, mu, nu)`` of a JAX ``FusedAdamState``, an optax
    ``ScaleByAdamState``, optax ``adam``'s ``(ScaleByAdamState,
    EmptyState)`` chain, or the port's ``FusedAdamState`` (any leaves)."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state.count, state.mu, state.nu
    if isinstance(state, tuple):
        found = [s for s in state
                 if all(hasattr(s, f) for f in ("count", "mu", "nu"))]
        if len(found) == 1:
            return found[0].count, found[0].mu, found[0].nu
    raise ValueError(f"not an Adam state with count, mu and nu: "
                     f"{type(state).__name__}")


def opt_state_from_jax(state, device=None):
    """A JAX optimizer state → the port's on ``device``: a
    ``MasterAdamState`` (it has ``master``) → the port's
    ``MasterAdamState``; an Adam state (``FusedAdamState``, or optax
    ``adam``'s) → ``FusedAdamState``. ``count`` becomes an int32 scalar,
    the trees (or a ZeRO-1 slice's bare vector) go leaf for leaf, dtypes
    kept."""
    dev = resolve_device(device)
    count, mu, nu = _adam_fields(state)
    to_t = lambda tree: tree_map(lambda x: _to_torch(x).to(dev), tree)
    count = torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                         device=dev)
    if hasattr(state, "master"):
        return MasterAdamState(count, to_t(mu), to_t(nu), to_t(state.master))
    return FusedAdamState(count, to_t(mu), to_t(nu))


def opt_state_to_numpy(state):
    """The port's ``FusedAdamState`` or ``MasterAdamState`` → the same
    NamedTuple with numpy leaves (``count`` an int32 scalar array): the
    fields JAX's ``FusedAdamState`` / ``MasterAdamState`` and optax's
    ``ScaleByAdamState`` hold."""
    count, mu, nu = _adam_fields(state)
    to_np = lambda tree: tree_map(
        lambda x: _to_numpy(x) if isinstance(x, torch.Tensor)
        else np.asarray(x), tree)
    count = np.asarray(int(count), dtype=np.int32)
    if hasattr(state, "master"):
        return MasterAdamState(count, to_np(mu), to_np(nu),
                               to_np(state.master))
    return FusedAdamState(count, to_np(mu), to_np(nu))


def zero1_opt_state_from_jax(state, rank: int, world: int,
                             device=None) -> FusedAdamState:
    """Rank ``rank``'s slice of a JAX ZeRO-1 Adam state (``make_zero1_step``'s
    ``opt_state``: mu and nu ``[world·local]`` vectors sharded over the
    ``data`` axis, gathered as numpy) → the port's ``FusedAdamState`` of
    ``[local]`` vectors, the moments ``parallel.dp.make_zero1_step`` holds
    on that rank."""
    count, mu, nu = _adam_fields(state)
    mu, nu = np.asarray(mu), np.asarray(nu)
    if mu.ndim != 1 or mu.shape != nu.shape or mu.shape[0] % world:
        raise ValueError(f"not a ZeRO-1 state of world {world}: mu "
                         f"{mu.shape}, nu {nu.shape}")
    local = mu.shape[0] // world
    mine = slice(rank * local, (rank + 1) * local)
    return opt_state_from_jax(FusedAdamState(count, mu[mine], nu[mine]),
                              device)


def zero1_opt_state_to_numpy(slices) -> FusedAdamState:
    """Every rank's ZeRO-1 ``FusedAdamState`` (rank order) → one with numpy
    ``[world·local]`` mu and nu, the arrays JAX's ZeRO-1 state holds."""
    states = [opt_state_to_numpy(s) for s in slices]
    counts = {int(s.count) for s in states}
    if len(counts) != 1:
        raise ValueError(f"ranks disagree on the step count: {counts}")
    return FusedAdamState(states[0].count,
                          np.concatenate([s.mu for s in states]),
                          np.concatenate([s.nu for s in states]))
