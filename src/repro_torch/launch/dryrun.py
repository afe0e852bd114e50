"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes and record per-device memory / cost / collective figures (the
reference's `repro.launch.dryrun`).

The reference lowers and compiles each cell for 512 host devices.  Here one
process is rank 0 of a fake process group of 256 or 512 ranks
(`launch.mesh`); the params, optimizer state, caches and batch are DTensors
placed by the sharding rules, holding fake tensors (`FakeTensorMode`:
nothing is allocated), and the cell's step runs once: the train step
(`make_train_step`, remat "block", microbatch max(1, B // 32)), the prefill
`apply`, or `decode_step`.  `LocalCounter` watches the ops DTensor runs on
rank 0's local shards and counts what one device does:

  * cost_analysis.flops — matmul / convolution / attention FLOPs of the
    local ops (`torch.utils.flop_counter`'s formulas); elementwise ops are
    not counted (XLA's cost_analysis counts them at 1 per element);
  * cost_analysis["bytes accessed"] — input + output bytes of every local
    op that is not a view;
  * hbm_bytes_est — 2 x the output bytes of every such op, plus the
    arguments (eager PyTorch materializes every op, so no TPU fusion model
    applies);
  * collectives — count and result bytes of the `_c10d_functional` ops by
    kind (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute) and their total;
  * memory_analysis — argument_size_in_bytes (the local shard bytes of the
    inputs; the decode cache's index, a Python int here, counts as the
    reference's 4-byte int32), output_size_in_bytes, and temp_size_in_bytes
    (the peak of the bytes the step's own tensors hold at once).

Ops DTensor runs at global shape on fake tensors to propagate shapes are
not counted.  `lower_s` is the trace's seconds; there is no compile, so no
`compile_s`.  The collectives are those DTensor picks on the given device
type: on a CPU mesh it stands an all-gather in for every all-to-all.

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k \\
      --mesh single [--device cpu]
  python -m repro_torch.launch.dryrun --list           # enumerate cells
Records: one JSON per cell under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, shape_applicable

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op name -> kind: `_c10d_functional` (and its autograd twin)
# ops, and `_dtensor.shard_dim_alltoall`, DTensor's all-to-all on the card
# (wait_tensor is not one)
_COLL_OPS = {"shard_dim_alltoall": "all-to-all",
             "all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
             "all_reduce_coalesced": "all-reduce",
             "all_reduce_coalesced_": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "broadcast": "collective-permute",
             "broadcast_": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(type(tree), "TREE_FIELDS"):
        for k in type(tree).TREE_FIELDS:
            yield from _tensors(getattr(tree, k))
    elif torch.is_tensor(tree):
        yield tree


def local_bytes(tree) -> int:
    """Bytes of every tensor leaf of `tree` on this rank (a DTensor's
    local shard)."""
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in _tensors(tree))


def is_collective(func) -> bool:
    """Whether an op overload is a collective (or its wait): the
    `_c10d_functional` namespaces' and `_dtensor.shard_dim_alltoall`."""
    ns = func.namespace
    return "_c10d_functional" in ns or (
        ns == "_dtensor" and func._overloadpacket.__name__ in _COLL_OPS)


def collective_kind(func):
    """The collective kind an op overload counts as, or None."""
    return _COLL_OPS.get(func._overloadpacket.__name__) \
        if is_collective(func) else None


class LocalCounter(TorchDispatchMode):
    """Counts the ops one device runs: DTensor ops are passed on to
    DTensor (which then runs their local ops on the shards, seen here),
    and the ops DTensor's sharding propagation runs at global shape are
    skipped (`_propagation_guard`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.out_bytes = 0.0
        self.collectives = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._skip = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._skip:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        outs = [t for t in _tensors(out)]
        if is_collective(func):
            kind = collective_kind(func)
            if kind is not None:
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += sum(map(_nbytes, outs))
            return
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view or name in ("detach", "alias", "lift_fresh"):
            return
        ins = [t for t in _tensors((args, kwargs))]
        ob = sum(map(_nbytes, outs))
        self.bytes_accessed += sum(map(_nbytes, ins)) + ob
        self.out_bytes += ob
        for t in outs:
            self._track(t)

    def _track(self, t) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def collective_record(self) -> Dict[str, Any]:
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out


class _propagation_guard:
    """While open, the ops run inside DTensor's shape propagation (at
    global shape) are not counted by `counter`."""

    def __init__(self, counter: LocalCounter):
        self.counter = counter

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._cls = ShardingPropagator
        self._orig = ShardingPropagator.__dict__[
            "_propagate_tensor_meta_non_cached"]
        counter, orig = self.counter, self._orig

        def guarded(prop, *args, **kwargs):
            counter._skip += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                counter._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = guarded
        return self

    def __exit__(self, *exc):
        self._cls._propagate_tensor_meta_non_cached = self._orig
        return False


def counting(counter: LocalCounter):
    """Context: `counter` on, DTensor's propagation ops off it."""
    import contextlib
    stack = contextlib.ExitStack()
    stack.enter_context(_propagation_guard(counter))
    stack.enter_context(counter)
    return stack


def _fake_like(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _place(axes_tree, tree, mesh):
    from repro_torch.sharding.rules import tree_distribute
    return tree_distribute(axes_tree, tree, mesh)


def _place_batch(batch, mesh):
    from repro_torch.sharding.rules import distribute, spec_for_axes
    return {k: distribute(v, spec_for_axes(
        ("act_batch",) + (None,) * (v.ndim - 1), tuple(v.shape), mesh), mesh)
        for k, v in batch.items()}


def lower_cell(arch: str, shape_name: str, mesh_kind: str, variant: str,
               *, microbatch: int = 0, remat: str = "block",
               probe_layers: int = 0, attn_mode: str | None = None,
               act_overrides: dict | None = None,
               extra: dict | None = None, device: str = "cuda") -> dict:
    """Trace one cell's step on the fake production mesh; returns the
    record dict.

    probe_layers > 0 traces a COST PROBE: the same architecture truncated
    to that many layers (microbatch 1 unless given).  The layer loop is
    always unrolled here, so a full-depth record counts every layer too;
    the probes keep the reference's roofline method (`launch.roofline`)
    and cost less to trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.transformer import LM
    from repro_torch.sharding.dtensor import fake_mode_fixes
    from repro_torch.sharding.rules import cache_axes_tree
    from repro_torch.train.steps import (abstract_train_state,
                                         make_train_step, train_state_axes)

    cfg = get_config(arch, variant)
    if probe_layers:
        cfg = dataclasses.replace(cfg, n_layers=probe_layers)
        microbatch = microbatch or 1
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=device)
    n_dev = mesh.size()
    lm = LM(cfg).use_mesh(mesh, act_overrides=act_overrides)
    if attn_mode is not None:
        lm.attn_mode = attn_mode
    counter = LocalCounter()
    index_bytes = 0
    with FakeTensorMode(), fake_mode_fixes():
        specs = input_specs(lm, shape, device)
        t0 = time.time()
        if shape.kind == "train":
            mb = microbatch or max(1, shape.global_batch // 32)
            state = abstract_train_state(lm)
            state = _place(train_state_axes(lm), type(state)(
                params=_tree_fake(state.params, device),
                opt=_tree_fake(state.opt, device),
                step=_fake_like(state.step, device)), mesh)
            batch = _place_batch(specs["batch"], mesh)
            args = (state, batch)
            step_fn = make_train_step(lm, remat=remat, microbatch=mb)
            with counting(counter):
                out = step_fn(state, batch)
        else:
            params = _place(lm.logical_axes(),
                            _tree_fake(lm.abstract_params(), device), mesh)
            if shape.kind == "prefill":
                batch = _place_batch(specs["batch"], mesh)
                args = (params, batch)
                with counting(counter), torch.no_grad():
                    out = lm.apply(params, batch["tokens"], remat=remat)[0]
            else:
                cache = specs["cache"]
                cache = _place(cache_axes_tree(cache), cache, mesh)
                tokens = _place_batch({"t": specs["tokens"]}, mesh)["t"]
                index_bytes = 4
                args = (params, tokens, cache)
                with counting(counter), torch.no_grad():
                    out = lm.decode_step(params, tokens, cache)
        t_lower = time.time() - t0
        arg_bytes = local_bytes(args) + index_bytes
        out_bytes = local_bytes(out)

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "status": "ok", "device_type": device,
        "devices": n_dev, "microbatch": microbatch, "remat": remat,
        "probe_layers": probe_layers,
        "n_layers": cfg.n_layers, "n_dense_prefix": cfg.n_dense_prefix,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "kind": shape.kind, "block": cfg.block, "dtype": cfg.dtype,
        "attn_mode": lm.attn_mode, "moe_groups": lm.moe_groups,
        "lower_s": round(t_lower, 1),
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "output_size_in_bytes": out_bytes,
                            "temp_size_in_bytes": counter.peak},
        "cost_analysis": {"flops": counter.flops,
                          "bytes accessed": counter.bytes_accessed},
        "hbm_bytes_est": 2.0 * counter.out_bytes + arg_bytes,
        "collectives": counter.collective_record(),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if extra:
        rec.update(extra)
    return rec


def unsharded_flops(arch: str, shape_name: str, variant: str = "full", *,
                    microbatch: int = 0, remat: str = "block",
                    probe_layers: int = 0, attn_mode: str | None = None,
                    moe_groups: int = 1, device: str = "cuda") -> float:
    """The FLOPs `LocalCounter` counts for the same step on one device
    holding everything (no mesh; the record's `attn_mode` and
    `moe_groups`, which pick the function): the yardstick of the FLOP
    inflation, sum over devices / this."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.transformer import LM
    from repro_torch.train.steps import (abstract_train_state,
                                         make_train_step)
    cfg = get_config(arch, variant)
    if probe_layers:
        cfg = dataclasses.replace(cfg, n_layers=probe_layers)
        microbatch = microbatch or 1
    shape = SHAPES[shape_name]
    lm = LM(cfg)
    lm.attn_mode, lm.moe_groups = attn_mode, moe_groups
    counter = LocalCounter()
    with FakeTensorMode():
        specs = input_specs(lm, shape, device)
        if shape.kind == "train":
            st = abstract_train_state(lm)
            st = type(st)(params=_tree_fake(st.params, device),
                          opt=_tree_fake(st.opt, device),
                          step=_fake_like(st.step, device))
            step_fn = make_train_step(
                lm, remat=remat,
                microbatch=microbatch or max(1, shape.global_batch // 32))
            with counting(counter):
                step_fn(st, specs["batch"])
        else:
            params = _tree_fake(lm.abstract_params(), device)
            with counting(counter), torch.no_grad():
                if shape.kind == "prefill":
                    lm.apply(params, specs["batch"]["tokens"], remat=remat)
                else:
                    lm.decode_step(params, specs["tokens"], specs["cache"])
    return counter.flops


def _tree_fake(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_fake(v, device) for k, v in tree.items()}
    return _fake_like(tree, device)


def _worker_cmd(args) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun"] + args


def _env() -> dict:
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def run_cell_subprocess(arch, shape, mesh_kind, variant, out_path: Path,
                        timeout=3600, device: str = "cuda") -> bool:
    cmd = _worker_cmd(["--arch", arch, "--shape", shape, "--mesh",
                       mesh_kind, "--variant", variant, "--out",
                       str(out_path), "--device", device])
    r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        err = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "error", "stderr": r.stderr[-4000:]}
        out_path.write_text(json.dumps(err, indent=1))
        return False
    return True


def all_cells(meshes=("single", "multi")):
    for arch in list_archs():
        for shape in SHAPES:
            for mesh_kind in meshes:
                yield arch, shape, mesh_kind


def probe_pair(arch: str):
    """(L1, L2) probe depths: MoE dense prefixes stay in the prefix term."""
    cfg = get_config(arch, "full")
    base = cfg.n_dense_prefix + 1
    return base, base + 1


def probe_points(kind: str, l1: int, l2: int):
    """(probe_layers, microbatch) points of a cell: train cells get four
    (L1/L2 x mb1/mb2): the mb delta separates parameter collectives (FSDP
    gathers / grad reductions, which re-run per microbatch) from
    activation collectives (whose total is microbatch-invariant)."""
    points = [(l1, 1), (l2, 1)]
    if kind == "train":
        points += [(l1, 2), (l2, 2)]
    return points


def probe_suffix(pl: int, mb: int) -> str:
    return f"probe{pl}" + (f"mb{mb}" if mb > 1 else "")


def run_probes(force: bool = False, device: str = "cuda",
               out_dir: Path = OUT_DIR):
    """Cost probes for every runnable single-pod cell (roofline input)."""
    failures = 0
    for arch in list_archs():
        l1, l2 = probe_pair(arch)
        for shape in SHAPES:
            cfg = get_config(arch, "full")
            if not shape_applicable(cfg, SHAPES[shape])[0]:
                continue
            for pl, mb in probe_points(SHAPES[shape].kind, l1, l2):
                out = out_dir / f"{arch}__{shape}__single__" \
                    f"{probe_suffix(pl, mb)}.json"
                if out.exists() and not force:
                    rec = json.loads(out.read_text())
                    if rec.get("status") == "ok":
                        continue
                cmd = _worker_cmd(["--arch", arch, "--shape", shape,
                                   "--mesh", "single", "--probe-layers",
                                   str(pl), "--probe-microbatch", str(mb),
                                   "--out", str(out), "--device", device])
                t0 = time.time()
                r = subprocess.run(cmd, env=_env(), capture_output=True,
                                   text=True, timeout=3600)
                if r.returncode != 0:
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": "single",
                         "probe_layers": pl, "status": "error",
                         "stderr": r.stderr[-4000:]}))
                    failures += 1
                    status = "error"
                else:
                    status = json.loads(out.read_text()).get("status")
                print(f"probe {arch:24s} {shape:12s} L={pl} mb={mb} "
                      f"{status:8s} {time.time()-t0:6.1f}s", flush=True)
    print(f"probes done; {failures} failures")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--out")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probe-layers", type=int, default=0,
                    help="cost probe: truncate to N layers, mb=1")
    ap.add_argument("--probe-microbatch", type=int, default=0,
                    help="probe microbatch (param-collective separation)")
    ap.add_argument("--probes", action="store_true",
                    help="run the cost probes for every "
                         "single-pod cell (for the roofline)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake mesh's tensors")
    args = ap.parse_args(argv)

    if args.list:
        for cell in all_cells():
            print(*cell)
        return

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if args.probes:
        sys.exit(1 if run_probes(force=args.force, device=args.device)
                 else 0)
    if args.arch and args.shape:
        # single cell, in-process (the subprocess worker path)
        try:
            rec = lower_cell(args.arch, args.shape, args.mesh, args.variant,
                             probe_layers=args.probe_layers,
                             microbatch=args.probe_microbatch,
                             device=args.device)
        except Exception:
            rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                   "status": "error", "traceback": traceback.format_exc()}
        suffix = ("__" + probe_suffix(args.probe_layers,
                                      args.probe_microbatch)
                  if args.probe_layers else "")
        out = Path(args.out) if args.out else (
            OUT_DIR / f"{args.arch}__{args.shape}__{args.mesh}{suffix}.json")
        out.write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: rec.get(k) for k in
                          ("arch", "shape", "mesh", "status", "lower_s")}))
        if rec["status"] == "error":
            print(rec.get("traceback", rec.get("reason", ""))[-2000:],
                  file=sys.stderr)
            sys.exit(1)
        return

    # all cells, each in its own subprocess (resumable)
    failures = 0
    for arch, shape, mesh_kind in all_cells():
        out = OUT_DIR / f"{arch}__{shape}__{mesh_kind}.json"
        if out.exists() and not args.force:
            rec = json.loads(out.read_text())
            if rec.get("status") in ("ok", "skipped"):
                continue
        t0 = time.time()
        run_cell_subprocess(arch, shape, mesh_kind, args.variant, out,
                            device=args.device)
        rec = json.loads(out.read_text())
        status = rec.get("status")
        print(f"{arch:24s} {shape:12s} {mesh_kind:6s} {status:8s} "
              f"{time.time()-t0:7.1f}s", flush=True)
        failures += (status == "error")
    print(f"done; {failures} failures")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
