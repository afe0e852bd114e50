"""DTensor helpers for the LM's sharded forward (`LM.use_mesh`)."""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from repro_torch.sharding.rules import placements, spec_for_axes


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, axes: Sequence[Optional[str]], mesh, overrides=None):
    """`x` (a DTensor) redistributed to the placements of `axes` by the
    rules (a no-op where it already has them): the reference's
    `with_sharding_constraint`, whose backward pins the gradient alike
    (`_Constrain`)."""
    pl = placements(spec_for_axes(axes, tuple(x.shape), mesh, overrides),
                    mesh)
    if tuple(x.placements) == pl:
        return x
    return _Constrain.apply(x, pl)


class _Constrain(torch.autograd.Function):
    """Redistribute forward; backward, the gradient goes to the input's
    placements, a partial placement taken as replicated.  DTensor's own
    backward of a partial -> replicated reduction leaves the gradient
    partial, and the next matmul backward then gathers whole weights to
    multiply it (DTensor prices bytes moved, not FLOPs): the row-parallel
    projections' backward ran 16x their FLOPs that way."""

    @staticmethod
    def forward(ctx, x, pl):
        from torch.distributed.tensor import Partial, Replicate
        ctx.mesh = x.device_mesh
        ctx.back = tuple(Replicate() if isinstance(p, Partial) else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.back), None


@contextlib.contextmanager
def sharded_context(active: bool):
    """Plain tensors that meet a DTensor (rope tables, masks, constants)
    count as replicated while `active` (DTensor's `implicit_replication`,
    restoring the previous setting on exit, so that the contexts nest)."""
    if not active:
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def replicate(x):
    """A DTensor replicated on every mesh dimension (partial sums
    reduced)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


@contextlib.contextmanager
def fake_mode_fixes():
    """Under `FakeTensorMode`, DTensor's `_StridedShard` (the placement a
    view of a dim sharded over two mesh dims gets) works out its shard
    sizes from index tensors it reads back with `.tolist()`, which a fake
    tensor cannot do: while this context is open those index tensors are
    real (they are small, and hold no model data)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.__dict__["local_shard_size_and_offset"]

    def real_indices(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real_indices
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def split_last(t, shape):
    """`t.reshape(shape)` where `shape` splits t's last dim in two; a
    DTensor sharded on that dim keeps the shards only where the outer of
    the two new dims divides among them (replicated first otherwise)."""
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    last = t.ndim - 1
    mesh = t.device_mesh
    n = 1
    for i, p in enumerate(t.placements):
        if p == Shard(last):
            n *= mesh.size(i)
    if shape[-2] % n:
        t = t.redistribute(mesh, [Replicate() if p == Shard(last) else p
                                  for p in t.placements])
    return t.view(shape)


def gather_fsdp(tree, names=("pod", "data", "dp")):
    """Every DTensor leaf of `tree` with its shards over the data axes
    gathered (FSDP / ZeRO-3: a layer's params all-gathered before it runs;
    their gradients reduce-scatter back in the backward).  Shards over
    "model" (TP, EP) stay."""
    from torch.distributed.tensor import Replicate
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, names) for k, v in tree.items()}
    if not is_dtensor(tree):
        return tree
    mesh = tree.device_mesh
    dims = tuple(mesh.mesh_dim_names)
    pl = [Replicate() if dims[i] in names else p
          for i, p in enumerate(tree.placements)]
    if pl == list(tree.placements):
        return tree
    return tree.redistribute(mesh, pl)


# The multi-pod mesh computes on its (pod*data, model) view: DTensor picks
# each op's strategy by pricing every combination of per-mesh-dim
# placements, which over three mesh dims took ~60x the time of two (a
# smoke train step: 460 s against 8 s).  ("pod", "data") sharding is the
# flattened "dp" dim's, pod major, so nothing changes but the search.
FLAT_OVERRIDES = {"embed": ("dp",), "chips": ("dp",), "act_batch": ("dp",)}


def compute_mesh(mesh):
    """The mesh the LM computes on: `mesh` itself, or for a
    ("pod","data","model") mesh a ("dp","model") mesh over the same
    ranks in the same order."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    if names != ("pod", "data", "model"):
        raise ValueError(f"a multi-pod mesh is (pod, data, model), got "
                         f"{names}")
    pod, data, model = tuple(mesh.shape)
    return init_device_mesh(mesh.device_type, (pod * data, model),
                            mesh_dim_names=("dp", "model"))


def to_mesh(t, mesh):
    """A DTensor on the ("pod","data","model") mesh as the same tensor on
    its ("dp","model") view `mesh` (`compute_mesh`); the pod and data
    placements must agree (both sharding one dim, or both replicated),
    else they are replicated first.  Differentiable; other values and
    DTensors already on `mesh` pass as they are."""
    if not is_dtensor(t) or t.device_mesh is mesh or \
            tuple(t.device_mesh.mesh_dim_names) == \
            tuple(mesh.mesh_dim_names):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    pod, data, model = t.placements
    if pod != data:
        t = t.redistribute(t.device_mesh, [Replicate(), Replicate(), model])
        pod = data = Replicate()
    return DTensor.from_local(t.to_local(), mesh, [pod, model],
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def tree_to_mesh(tree, mesh):
    """`to_mesh` over a tree of dicts (other leaves pass)."""
    if isinstance(tree, dict):
        return {k: tree_to_mesh(v, mesh) for k, v in tree.items()}
    return to_mesh(tree, mesh)


def local_apply(fn, t):
    """`fn(t)` for an op that keeps t's shape and moves nothing across a
    dim the placements shard (flipping the conv taps' unsharded dim): on a
    DTensor, `fn` of the local shard under the same placements (a DTensor
    build may have no sharding rule for the op); `fn(t)` otherwise."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(t.placements)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     in_grad_placements=(pl,),
                     device_mesh=t.device_mesh)(t)
