"""Fault-tolerant checkpointing in the reference's on-disk format.

A checkpoint of step n is a directory `step_<n:09d>/` holding
  * `host_<i>.npz`: one array per leaf, keyed by the `/`-joined key path of
    the leaf in `jax.tree.flatten` order (dict keys sorted, list and tuple
    items by index, a training state's `params`, `opt`, `step` in that
    order); bfloat16, which numpy cannot store, goes in as its uint16 bit
    pattern;
  * `META.json`: `step`, `n_hosts`, `time`, `keys` (sorted), `shapes` and
    `dtypes` (numpy's dtype names, "bfloat16" for bfloat16).
Writes go to `step_<n>.tmp/`, every file is fsynced, and the directory is
renamed to `step_<n>/` only then: a job killed mid-save never leaves a
checkpoint that `latest_step` would pick up.  `CheckpointManager` adds the
async save (a host snapshot now, the write on a background thread) and
keep-k garbage collection.

The same files come out of both packages for the same tree, apart from
`time` and the zip members' timestamps, so a checkpoint written by either
restores in the other.  Restoring a bit-pattern dtype goes through a signed
integer view and `torch.Tensor.view`; `ml_dtypes` is not needed.

The reference's `shardings` (an elastic reshard against a JAX mesh) has no
meaning here: `restore_pytree` and `restore_latest` accept only None for
it, and put every leaf on `device`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import (is_node, tree_leaves_with_path,
                                       tree_map)
from repro_torch.runtime import DeviceLike, resolve_device

PyTree = Any

def _to_numpy(leaf) -> tuple:
    """A leaf as (storable numpy array, dtype name); bfloat16 as its
    uint16 bit pattern, named "bfloat16"."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_torch(arr: np.ndarray, saved: str) -> torch.Tensor:
    """A stored array as a tensor of its saved dtype."""
    if saved == str(arr.dtype):
        return torch.from_numpy(np.array(arr))
    if saved != "bfloat16" or arr.dtype != np.uint16:
        raise TypeError(f"a leaf saved as {saved} stored as {arr.dtype}: "
                        f"the port restores bfloat16 bit patterns only")
    bits = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _flatten_with_paths(tree: PyTree) -> Dict[str, Any]:
    return {"/".join(p): leaf for p, leaf in tree_leaves_with_path(tree)
            if leaf is not None}


def save_pytree(tree: PyTree, directory: str | Path, step: int,
                host_id: int = 0, n_hosts: int = 1) -> Path:
    """Synchronous save with atomic rename."""
    directory = Path(directory)
    tmp = directory / f"step_{step:09d}.tmp"
    final = directory / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    flat = _flatten_with_paths(tree)
    stored = {k: _to_numpy(v) for k, v in flat.items()}
    storable = {k: arr for k, (arr, _) in stored.items()}
    dtypes = {k: name for k, (_, name) in stored.items()}
    np.savez(tmp / f"host_{host_id}.npz", **storable)
    meta = {
        "step": step, "n_hosts": n_hosts,
        "time": time.time(),
        "keys": sorted(storable),
        "shapes": {k: list(v.shape) for k, v in storable.items()},
        "dtypes": dtypes,
    }
    (tmp / "META.json").write_text(json.dumps(meta))
    # fsync the files, then atomic rename
    for f in tmp.iterdir():
        fd = os.open(f, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")
             and (p / "META.json").exists()]
    return max(steps) if steps else None


def _no_shardings(shardings) -> None:
    if shardings is not None:
        raise ValueError("shardings: the port restores onto one device "
                         "(`device`); pass None")


def restore_pytree(template: PyTree, directory: str | Path,
                   step: Optional[int] = None, host_id: int = 0,
                   shardings: Optional[PyTree] = None,
                   device: DeviceLike = "cuda") -> PyTree:
    """Restore into the structure of `template` (tensors, `meta` ones
    too): each leaf cast to its template leaf's dtype, on `device`.  A
    template leaf the checkpoint lacks raises KeyError."""
    _no_shardings(shardings)
    dev = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    src = directory / f"step_{step:09d}"
    meta = json.loads((src / "META.json").read_text())
    with np.load(src / f"host_{host_id}.npz") as data:
        def build(node, path):
            if isinstance(node, dict):
                return {k: build(v, path + (str(k),))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v, path + (str(i),))
                                  for i, v in enumerate(node))
            if is_node(node):
                return type(node)(**{k: build(getattr(node, k), path + (k,))
                                     for k in type(node).TREE_FIELDS})
            if node is None:
                return None
            key = "/".join(path)
            arr = data[key]
            t = _to_torch(arr, meta["dtypes"].get(key, str(arr.dtype)))
            if torch.is_tensor(node):
                t = t.to(node.dtype)
            return t.to(dev)
        return build(template, ())


class CheckpointManager:
    """Async keep-k checkpoint manager."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 host_id: int = 0, n_hosts: int = 1):
        self.directory = Path(directory)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: list = []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, tree: PyTree, step: int):
        """Snapshot to host RAM now; write + GC on a background thread."""
        self.wait()
        snapshot = tree_map(
            lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x)
            else np.array(x), tree)

        def _write():
            save_pytree(snapshot, self.directory, step, self.host_id,
                        self.n_hosts)
            self.saved_steps.append(step)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save(self, tree: PyTree, step: int):
        save_pytree(tree, self.directory, step, self.host_id, self.n_hosts)
        self.saved_steps.append(step)
        self._gc()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        doomed = steps[:-self.keep] if self.keep else []
        for s in doomed:
            shutil.rmtree(self.directory / f"step_{s:09d}", ignore_errors=True)

    def restore_latest(self, template: PyTree, shardings=None,
                       device: DeviceLike = "cuda") -> tuple:
        step = latest_step(self.directory)
        if step is None:
            return None, None
        tree = restore_pytree(template, self.directory, step, self.host_id,
                              shardings, device)
        return tree, step
