"""Shared LM building blocks and the ParamSpec parameter system (the
reference's `repro.models.common`).

ParamSpec tables are the single source of truth for parameter shapes and
logical axes: `materialize` turns a spec tree (nested dicts) into tensors
bit-identical to the reference's `materialize` at the same key,
`abstract` into `meta` tensors, and `logical_axes_tree` extracts the axes.

Scalar constants enter the arithmetic as tensors of the operand's dtype,
as JAX's weakly typed Python scalars do: a bfloat16 activation times a
constant multiplies by the constant rounded to bfloat16, and a division
by a constant stays a division on the card (PyTorch's CUDA division by a
host scalar multiplies by its reciprocal).

A class that lists its children in a `TREE_FIELDS` class attribute (the
training state) is a tree node, walked in that order, as the reference
registers it with `jax.tree_util`.  `checkpoint_name` tags the projection
matmuls that the reference names for its remat policy "names", and
`remat_context` gives each remat mode's selective-checkpoint policy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.runtime import DeviceLike, resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | scaled
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def is_node(tree) -> bool:
    """Whether `tree` is an instance of a class with `TREE_FIELDS`."""
    return hasattr(type(tree), "TREE_FIELDS")


def tree_leaves_with_path(tree: PyTree, path: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) in `jax.tree.flatten`'s order: dict keys sorted,
    lists and tuples in order, a node's `TREE_FIELDS` in their order, depth
    first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (str(i),))
    elif is_node(tree):
        for k in type(tree).TREE_FIELDS:
            yield from tree_leaves_with_path(getattr(tree, k), path + (k,))
    else:
        yield path, tree


def tree_map(fn, tree: PyTree) -> PyTree:
    """`jax.tree.map` of one tree of nested dicts, lists, tuples and
    nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if is_node(tree):
        return type(tree)(**{k: tree_map(fn, getattr(tree, k))
                             for k in type(tree).TREE_FIELDS})
    return fn(tree)


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def materialize(key: torch.Tensor, specs: PyTree,
                device: DeviceLike = "cuda") -> PyTree:
    """Initialize a tree of ParamSpec into tensors on `device`, bit for bit
    the reference's: one key per leaf from `split(key, n_leaves)` in
    `jax.tree.flatten` order; zeros and ones as the leaf says; otherwise
    `normal(k, shape)` in float32, times float32(scale / sqrt(fan_in)) as
    its own rounding (the reference multiplies eagerly, after the jitted
    normal), then cast to the leaf's dtype.  fan_in is shape[-2], or
    shape[-1] for a vector.  Each leaf is scaled in place and cast alone,
    so one float32 leaf at a time is alive beside the result."""
    dev = resolve_device(device)
    leaves = list(tree_leaves_with_path(specs))
    keys = prng.split(key.to(dev), len(leaves))
    out: Dict = {}
    for i, (path, s) in enumerate(leaves):
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=s.dtype, device=dev)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=s.dtype, device=dev)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = np.float32(s.scale / math.sqrt(max(fan_in, 1)))
            t = prng.normal(keys[i], s.shape)
            t.mul_(torch.tensor(std, device=dev))
            if s.dtype != torch.float32:
                t = t.to(s.dtype)
        _set_path(out, path, t)
    return out


def abstract(specs: PyTree) -> PyTree:
    """`meta` tensors matching `materialize` (no allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def logical_axes_tree(specs: PyTree) -> PyTree:
    return tree_map(lambda s: s.axes, specs)


# ------------------------------------------------------------------ numerics

@functools.lru_cache(maxsize=1024)
def scalar(v: float, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """A 0-dim tensor of `v`, made once per (value, dtype, device) and kept
    (read it, never write it): making a card tensor from a host value waits
    for the card."""
    return torch.tensor(v, dtype=dtype, device=device)


def const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak type makes it: a 0-dim tensor of
    `like`'s dtype on its device (`scalar`)."""
    return scalar(float(v), like.dtype, like.device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm with float32 statistics but activation-dtype elementwise
    math: the square rounds to x's dtype, its mean and rsqrt are float32,
    and x * scale * gamma stays in x's dtype."""
    dt = x.dtype
    var = torch.mean(torch.square(x).float(), dim=-1, keepdim=True)
    scale = torch.rsqrt(var + const(eps, var)).to(dt)
    if plus_one:        # gemma-style (1 + gamma)
        g = (1.0 + gamma.float()).to(dt)
    else:
        g = gamma.to(dt)
    return x * scale * g


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    x32 = x.float()
    return (const(cap, x32) * torch.tanh(x32 / const(cap, x32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding.  x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = torch.pow(const(theta, ar), -ar / const(half, ar))
    ang = positions[..., :, None].float() * freq             # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    half = d_model // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = torch.pow(const(10000.0, ar), -ar / const(half, ar))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE in f32 with optional z-loss; labels [B,S] int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    zl = const(z_loss, lse) * torch.square(lse)
    per_tok = nll + zl
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(per_tok * mask) / denom
    metrics = {"nll": torch.sum(nll * mask) / denom,
               "z_loss": torch.sum(zl * mask) / denom}
    return loss, metrics


# ------------------------------------------------------------------ remat

REMAT_MODES = ("none", "block", "dots", "names")
# the projections the reference tags with `checkpoint_name`
SAVED_NAMES = ("attn_q", "attn_k", "attn_v", "mlp_gate", "mlp_up")
_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the matmuls run inside the block as `name` (the reference's
    `jax.ad_checkpoint.checkpoint_name` on their output); remat "names"
    saves the outputs of those tagged with one of SAVED_NAMES."""
    prev = getattr(_TAG, "name", None)
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = prev


def _is_matmul(op) -> bool:
    packet = getattr(op, "_overloadpacket", None)
    return packet is torch.ops.aten.mm or packet is torch.ops.aten.addmm


def _save_dots(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: a projection `x @ w` reaches
    aten as `mm` (or `addmm`); an einsum with batch dimensions as `bmm`."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if _is_matmul(op)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_names(ctx, op, *args, **kwargs):
    """`save_only_these_names(*SAVED_NAMES)`: the matmul outputs made under
    one of those tags."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE
            if _is_matmul(op) and getattr(_TAG, "name", None) in SAVED_NAMES
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(mode: str):
    """`context_fn` for `torch.utils.checkpoint.checkpoint` under remat
    `mode` ("block": None, saving nothing inside the checkpointed
    function)."""
    if mode not in REMAT_MODES or mode == "none":
        raise ValueError(f"remat must be one of {REMAT_MODES[1:]} here, "
                         f"got {mode!r}")
    if mode == "block":
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    policy = _save_dots if mode == "dots" else _save_names
    return functools.partial(create_selective_checkpoint_contexts, policy)
