"""The port's dry run (`repro_torch.launch.dryrun`) and its roofline,
perf and summary tools on the CPU: the local counting of FLOPs and
collectives below DTensor, the CLI's records against the JAX package's
spec trees, the probe method, the FLOP inflation guard at full width, and
`LM.use_mesh` on a real 2x2 gloo mesh against the one-process port."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun, meshcheck, mesh as mesh_mod  # noqa: E402
from repro_torch.launch import roofline, summarize  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_group():
    yield mesh_mod
    mesh_mod.destroy()


def test_counting_is_local(fake_group):
    """A matmul of DTensors on the fake 16x16 mesh counts rank 0's local
    product and the collectives' result bytes as reckoned by hand, not the
    global shapes (and not DTensor's global-shape propagation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_group.make_production_mesh(device_type="cpu")
    c = dryrun.LocalCounter()
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(16, 1024), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(1024, 256), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with dryrun.counting(c):
            y = x @ w                                  # [256, 4096] global
            z = y.redistribute(mesh, [Replicate(), Replicate()])
    assert tuple(z.to_local().shape) == (256, 4096)
    assert c.flops == 2 * 16 * 1024 * 256              # local, not 2.15e9
    coll = c.collective_record()
    # model dim: [16, 256] -> [16, 4096]; data dim: -> [256, 4096] (f32)
    assert coll["all-gather"] == {"count": 2,
                                  "bytes": 4 * (16 * 4096 + 256 * 4096)}
    assert coll["total_bytes"] == coll["all-gather"]["bytes"]
    assert c.peak > 0 and c.bytes_accessed > 0


def test_collective_kinds():
    """The ops counted as collectives: `_c10d_functional`'s (their waits
    not counted) and DTensor's all-to-all on the card,
    `_dtensor.shard_dim_alltoall` (a CPU mesh stands all-gather + chunk in
    for it)."""
    import torch.distributed.tensor._collective_utils  # noqa: F401
    ops = torch.ops
    assert dryrun.collective_kind(
        ops._dtensor.shard_dim_alltoall.default) == "all-to-all"
    assert dryrun.collective_kind(
        ops._c10d_functional.all_gather_into_tensor.default) == "all-gather"
    assert dryrun.collective_kind(
        ops._c10d_functional.reduce_scatter_tensor.default) == \
        "reduce-scatter"
    assert dryrun.collective_kind(
        ops._c10d_functional.all_reduce.default) == "all-reduce"
    assert dryrun.is_collective(ops._c10d_functional.wait_tensor.default)
    assert dryrun.collective_kind(
        ops._c10d_functional.wait_tensor.default) is None
    assert not dryrun.is_collective(ops.aten.mm.default)


def _jax_arg_bytes(arch, shape_name, mesh_kind):
    """Local shard bytes of a cell's inputs by the JAX package's spec
    trees on the stand-in mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro.configs.registry import get_config as jcfg
    from repro.configs.shapes import SHAPES
    from repro.models.transformer import LM as JaxLM
    from repro.sharding import rules as jr
    from repro.train import steps as js
    from test_torch_sharding import MESHES
    mesh = MESHES[mesh_kind]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    lm = JaxLM(jcfg(arch, "smoke"))
    shape = SHAPES[shape_name]

    def nbytes(specs, tree):
        flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
        flat_t = jax.tree.leaves(tree)
        total = 0
        for spec, t in zip(flat_s, flat_t):
            n = 1
            for d, e in zip(t.shape, tuple(spec) + (None,) * len(t.shape)):
                g = () if e is None else ((e,) if isinstance(e, str) else e)
                n *= d // int(np.prod([sizes[a] for a in g]))
            total += n * jnp.dtype(t.dtype).itemsize
        return total

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        st = jax.eval_shape(lambda: js.abstract_train_state(lm))
        total = nbytes(jr.tree_pspecs(js.train_state_axes(lm), st, mesh), st)
        tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
        spec = jr.spec_for_axes(("act_batch", None), (B, S), mesh)
        return total + 2 * nbytes([spec], [tok])
    params = lm.abstract_params()
    total = nbytes(jr.tree_pspecs(lm.logical_axes(), params, mesh), params)
    cache = jax.eval_shape(lambda: lm.init_cache(B, S))
    total += nbytes(jr.tree_pspecs(jr.cache_axes_tree(cache), cache, mesh),
                    cache)
    tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    return total + nbytes([jr.spec_for_axes(("act_batch", None), (B, 1),
                                            mesh)], [tok])


CLI_CELLS = [("phi3-medium-14b", "train_4k", "multi"),
             ("qwen3-moe-235b-a22b", "decode_32k", "multi"),
             ("hymba-1.5b", "train_4k", "single"),
             ("rwkv6-3b", "decode_32k", "single")]


def test_cli_smoke_cells(tmp_path):
    """`python -m repro_torch.launch.dryrun --variant smoke --device cpu`
    on the reference's two cells and a hymba and an rwkv6 cell (the four
    subprocesses at once): status ok, 256 / 512 devices, FLOPs > 0, and
    argument bytes equal to the local shards of the JAX spec tree."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    procs = []
    for arch, shape, mesh in CLI_CELLS:
        out = tmp_path / f"{arch}__{shape}__{mesh}.json"
        procs.append((arch, shape, mesh, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--variant", "smoke",
             "--device", "cpu", "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    for arch, shape, mesh, out, p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        rec = json.loads(out.read_text())
        assert rec["status"] == "ok"
        assert rec["devices"] == (512 if mesh == "multi" else 256)
        assert rec["cost_analysis"]["flops"] > 0
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            _jax_arg_bytes(arch, shape, mesh), (arch, shape, mesh)
        assert rec["collectives"]["total_bytes"] > 0
        assert "compile_s" not in rec and rec["lower_s"] >= 0


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_probes_reproduce_full_depth_flops(fake_group, tmp_path, shape):
    """probe_pair's L1/L2 probes and analyze_cell give a 4-layer record's
    FLOPs exactly (phi3, homogeneous), and summarize / roofline read the
    records."""
    arch = "phi3-medium-14b"
    l1, l2 = dryrun.probe_pair(arch)
    for pl in (l1, l2):
        rec = dryrun.lower_cell(arch, shape, "single", "smoke",
                                probe_layers=pl, device="cpu")
        (tmp_path / f"{arch}__{shape}__single__probe{pl}.json").write_text(
            json.dumps(rec))
    full = dryrun.lower_cell(arch, shape, "single", "smoke", probe_layers=4,
                             device="cpu")
    assert full["n_layers"] == 4
    (tmp_path / f"{arch}__{shape}__single.json").write_text(json.dumps(full))
    row = roofline.analyze_cell(arch, shape, out_dir=tmp_path)
    assert row["method"] == f"probe-delta(L={l1},{l2})"
    assert row["flops_dev"] == full["cost_analysis"]["flops"]
    assert row["coll_dev"] == full["collectives"]["total_bytes"]
    assert row["compute_s"] == row["flops_dev"] / 989e12
    assert row["collective_s"] == row["coll_dev"] / 50e9
    md = tmp_path / "r.md"
    roofline.main(["--dir", str(tmp_path), "--csv", str(tmp_path / "r.csv"),
                   "--markdown", str(md)])
    assert f"| {arch} | {shape} |" in md.read_text()
    rows = summarize.rows_of(tmp_path)
    assert [r[:4] for r in rows] == [(arch, shape, "single", "ok")]


INFLATION_CELLS = ["gemma2-27b", "llama3-405b", "phi3-medium-14b",
                   "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", INFLATION_CELLS)
def test_flop_inflation_full_width(fake_group, arch):
    """At full width, on 1-layer probes (and the MoE's), for train_4k,
    prefill_32k and decode_32k on the single mesh: FLOPs summed over the
    256 devices stay within 1.25x the count of the same step on one device
    (the guard against the leak the reference's use_mesh describes:
    tokens replicated, features sharded).  The attention modes are the
    reference's: kv_heads, q_groups, kv_seq, q_groups."""
    want_mode = {"gemma2-27b": "kv_heads", "llama3-405b": "q_groups",
                 "phi3-medium-14b": "kv_seq",
                 "qwen3-moe-235b-a22b": "q_groups"}[arch]
    pl = dryrun.probe_pair(arch)[0]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.lower_cell(arch, shape, "single", "full",
                                probe_layers=pl, device="cpu")
        assert rec["attn_mode"] == want_mode
        one = dryrun.unsharded_flops(arch, shape, "full", probe_layers=pl,
                                     attn_mode=rec["attn_mode"],
                                     moe_groups=rec["moe_groups"],
                                     device="cpu")
        ratio = rec["cost_analysis"]["flops"] * rec["devices"] / one
        print(f"{arch} {shape}: inflation {ratio:.4f}")
        assert 0.99 <= ratio <= 1.25, (shape, ratio)


# ------------------------------------------------------------ real mesh

def test_use_mesh_on_a_real_gloo_mesh(tmp_path):
    """Four gloo processes on a real 2x2 ("data","model") mesh: the loss
    and gradients of the smoke configs of a dense (q_groups), an MoE
    (kv_heads) and a hybrid (kv_seq) arch under `use_mesh` against the
    one-process port with the same attention mode and MoE groups; one
    train step's loss and first moments; ten decode steps' logits on a
    cache whose sequence is sharded over "model" (each step's max
    difference within 1e-5 of the logits' max)."""
    out = meshcheck.run(tmp_path)
    assert meshcheck.failures(out) == [], meshcheck.failures(out)
