"""Production mesh construction (the reference's `repro.launch.mesh`).

Defined as FUNCTIONS (never module-level constants), so importing this
module starts no process group.  The production target is 16 x 16 = 256
devices as a ("data", "model") mesh; the multi-pod configuration stacks 2
pods = 512 devices with a leading "pod" axis.

A process that is not already one rank of a group of that size gets a
group of the `"fake"` backend (`torch.testing`'s `FakeStore`): rank 0 of
256 or 512, whose collectives return at once without moving data.  That is
what the dry run traces a cell on (`repro_torch.launch.dryrun`): one
process, every DTensor holding rank 0's shard, under `FakeTensorMode`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(mesh shape, axis names) of the single- or multi-pod mesh."""
    return PRODUCTION_SHAPES[bool(multi_pod)]


def production_size(multi_pod: bool = False) -> int:
    """Devices in the single- (256) or multi-pod (512) mesh."""
    n = 1
    for s in production_shape(multi_pod)[0]:
        n *= s
    return n


def ensure_fake_group(world_size: int) -> None:
    """Make the default process group one of `world_size` ranks: keep a
    group of that size, replace a fake group of another size, start a fake
    one (rank 0) where there is none; a real group of another size
    raises."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"this process is one of {dist.get_world_size()} ranks of a "
                f"{dist.get_backend()} group; the mesh needs {world_size}")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16,16) ("data","model") or (2,16,16) ("pod","data","model")
    `DeviceMesh` over a group of 256 or 512 ranks (`ensure_fake_group`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = production_shape(multi_pod)
    ensure_fake_group(production_size(multi_pod))
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(device_type: str = "cuda"):
    """Whatever this host runs as (tests / examples): a 1-D ("data",) mesh
    over the default group, which is started as a one-rank group (gloo on
    the CPU, NCCL on the card) where there is none."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def destroy() -> None:
    """End the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
