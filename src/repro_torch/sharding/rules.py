"""Logical-axis -> mesh-axis sharding rules (MaxText-style), with the
reference's divisibility fix-up so every (arch x shape x mesh) cell gets a
valid spec: an axis that does not divide its dimension is dropped
(replicated) rather than failing (the reference's `repro.sharding.rules`).

Parallelism encoded here:
  * FSDP/ZeRO-3: parameter + optimizer sharding over ("pod","data") via the
    "embed" rule; a DTensor matmul gathers the shards it needs.
  * TP (Megatron col->row): "heads_qkv"/"kv_qkv"/"mlp" over "model".
  * EP: "experts" over "model".
  * DP: activation batch over ("pod","data").
  * SP: long-context decode KV caches shard the sequence dim over "model"
    (flash-decoding style), since batch=1 cannot absorb the mesh.

A spec is the port's own `PartitionSpec`: a tuple with one entry per
tensor dimension, each None, a mesh axis name, or a tuple of names.
`placements` turns it into DTensor placements, one per mesh dimension.
A mesh is a `torch.distributed.DeviceMesh` (`mesh_dim_names`, `shape`)
or any object with `axis_names` and `devices.shape` (a stand-in).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple


PyTree = Any

# logical axis -> preferred mesh axes (tried in order, dropped if they
# don't divide or are already taken by an earlier dim of the same tensor)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "layers": (),                       # stacked; never sharded
    "vocab": ("model",),
    "embed": ("pod", "data"),          # FSDP axis for params
    "heads_qkv": ("model",),
    "kv_qkv": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    # Monte Carlo chip ensembles (repro_torch.mc): the chips axis is
    # embarrassingly parallel — shard sampled-chip state and per-chip
    # activations over every data-parallel axis, replicate the shared input
    # batch
    "chips": ("pod", "data"),
    # activations / caches
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_seq_model": ("model",),        # SP for decode caches
    "act_heads": ("model",),
    "act_embed": (),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (the dimension split over those axes, the first
    major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a stand-in with
    `axis_names` and `devices.shape`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for_axes(axes: Sequence[Optional[str]], shape: Sequence[int],
                  mesh, overrides: Optional[Dict[str, Tuple[str, ...]]] = None
                  ) -> PartitionSpec:
    """Resolve logical axes to a valid PartitionSpec for `shape` on `mesh`.

    Drops mesh axes that (a) don't exist on this mesh, (b) don't divide the
    dimension, or (c) were already used by an earlier dimension.
    """
    rules = dict(LOGICAL_RULES)
    if overrides:
        rules.update(overrides)
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    parts: List = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in rules:
            parts.append(None)
            continue
        chosen = []
        prod = 1
        for m in rules[ax]:
            if m not in sizes or m in used:
                continue
            if dim % (prod * sizes[m]) == 0:
                chosen.append(m)
                prod *= sizes[m]
        used.update(chosen)
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    return P(*parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _zip_map(fn, axes_tree: PyTree, other: PyTree) -> PyTree:
    """`fn(axes, leaf)` over an axes tree (leaves: tuples of names) and a
    tree of the same structure."""
    if _is_axes(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(_zip_map(fn, a, o)
                               for a, o in zip(axes_tree, other))
    fields = type(axes_tree).TREE_FIELDS
    return type(axes_tree)(**{k: _zip_map(fn, getattr(axes_tree, k),
                                          getattr(other, k))
                              for k in fields})


def _shape(t) -> Tuple[int, ...]:
    """A tensor's shape, a shape tuple as it is, () for a Python scalar
    (the cache's index)."""
    if hasattr(t, "shape"):
        return tuple(t.shape)
    return tuple(t) if isinstance(t, (tuple, list)) else ()


def tree_pspecs(axes_tree: PyTree, shape_tree: PyTree, mesh,
                overrides=None) -> PyTree:
    """Map (logical axes tree, tree of tensors or shapes) -> PartitionSpec
    tree."""
    return _zip_map(lambda axes, t: spec_for_axes(
        axes, _shape(t), mesh, overrides), axes_tree, shape_tree)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: for each mesh dimension,
    `Shard(d)` for the tensor dimension d whose entry names it, else
    `Replicate()`.

    A dimension split over several axes, as ("pod", "data"), is laid out
    major to minor as in JAX: shard index pod * |data| + data.  DTensor
    splits a dimension sharded on several mesh dimensions in mesh-dimension
    order, the first mesh dimension outermost, so the tuple must name the
    axes in the mesh's own order (LOGICAL_RULES does); another order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} is split over {group}, not in "
                             f"the mesh's axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(axes_tree: PyTree, shape_tree: PyTree, mesh,
                   overrides=None) -> PyTree:
    """Tree of DTensor placements (`placements` of `tree_pspecs`)."""
    return _zip_map(lambda axes, t: placements(spec_for_axes(
        axes, _shape(t), mesh, overrides), mesh), axes_tree, shape_tree)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The per-device shard shape of a tensor of `shape` under `spec`: each
    dimension divided by the product of its axes' sizes."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        group = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        div = 1
        for a in group:
            div *= sizes[a]
        out.append(dim // div)
    return tuple(out)


def batch_pspec(mesh) -> PartitionSpec:
    """[B, S] token batches: batch over every data-parallel axis present."""
    names = mesh_axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    return P(axes if len(axes) > 1 else (axes[0] if axes else None), None)


def chips_pspec(mesh, n_chips: int, ndim: int) -> PartitionSpec:
    """Leading-chips-axis spec for ensemble state / activations, via the
    "chips" logical rule (divisibility fix-up included: an awkward chunk
    size falls back to replication)."""
    return spec_for_axes(("chips",) + (None,) * (ndim - 1),
                         (n_chips,) + (1,) * (ndim - 1), mesh)


# ------------------------------------------------------------------ caches

def _cache_leaf_axes(name: str, nd: int) -> Tuple:
    if name == "index":
        return (None,) * nd
    if nd == 5 and name in ("k", "v"):            # [L,B,S,KV,hd]
        return ("layers", "act_batch", "act_seq_model", None, None)
    if name == "wkv":                             # [L,B,H,hd,hd]
        return ("layers", "act_batch", "act_heads", None, None)
    if name == "h":                               # [L,B,di,n]
        return ("layers", "act_batch", "heads_qkv", None)
    if name == "conv":                            # [L,B,K-1,di]
        return ("layers", "act_batch", None, "heads_qkv")
    if nd == 3:                                   # shift states [L,B,D]
        return ("layers", "act_batch", None)
    return (None,) * nd


def cache_axes_tree(cache: PyTree) -> PyTree:
    """Logical axes for a decode cache built by `LM.init_cache`.

    KV caches [L,B,S,KV,hd]: batch over DP axes, sequence over 'model' (SP
    / flash-decoding split).  SSM/RWKV states: batch over DP axes, feature
    dim over 'model'.  The cache's "index" (a Python int here, a scalar
    array in the reference) has no axes."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _cache_leaf_axes(name, getattr(tree, "ndim", 0))
    return walk(cache, "")


# ------------------------------------------------------------------ DTensors

def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def distribute(t, spec: Sequence, mesh):
    """A DTensor of `t` placed by `spec` on `mesh` (a DeviceMesh).  A
    `meta` tensor, or a fake one, gives an empty local shard of its
    dtype and device (no data moves); a real tensor gives this rank's
    chunk of it (every rank holds the same whole tensor)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if t.device.type == "meta" or _is_fake(t):
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device=t.device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape,
                                  stride=_contiguous_stride(t.shape))
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def tree_distribute(axes_tree: PyTree, tree: PyTree, mesh,
                    overrides=None) -> PyTree:
    """`distribute` every tensor leaf of `tree` by its logical axes (other
    leaves, as the cache's index, stay as they are)."""
    import torch
    return _zip_map(lambda axes, t: distribute(
        t, spec_for_axes(axes, tuple(t.shape), mesh, overrides), mesh)
        if torch.is_tensor(t) else t, axes_tree, tree)
