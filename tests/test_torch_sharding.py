"""The port's sharding rules (`repro_torch.sharding.rules`) and
`LM.use_mesh` against the JAX package's, on the same mesh stand-ins; the
DTensor placements under a fake 512-rank mesh; the `xla_fma` custom op
under fake tensors and DTensors; the LM with no mesh as it was."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.transformer import LM as JaxLM  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs.registry import get_config, list_archs  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = list_archs()


def _fake_mesh(shape, names):
    """AbstractMesh stand-in: spec_for_axes only reads axis_names/shape
    (a copy of the one in tests/test_sharding_dryrun.py, whose module sets
    XLA_FLAGS on import)."""
    devs = np.empty(shape, object)
    return type("M", (), {"axis_names": names,
                          "devices": type("D", (), {"shape": shape,
                                                    "size": devs.size})()})()


MULTI = _fake_mesh((2, 16, 16), ("pod", "data", "model"))
SINGLE = _fake_mesh((16, 16), ("data", "model"))
MESHES = {"single": SINGLE, "multi": MULTI}


def _same(port_spec, jax_spec):
    return tuple(port_spec) == tuple(jax_spec)


# ------------------------------------------------------------ spec_for_axes

@pytest.mark.parametrize("axes,shape,mesh,want", [
    (("embed", "mlp"), (4096, 16384), "multi", (("pod", "data"), "model")),
    (("kv_qkv",), (320,), "single", ("model",)),
    (("kv_qkv",), (50,), "single", (None,)),
    (("embed",), (34,), "multi", ("pod",)),
    (("experts", "embed", "mlp"), (128, 4096, 1536), "multi",
     ("model", ("pod", "data"), None)),
    (("embed",), (4096,), "single", ("data",)),
    ((), (), "single", ()),
])
def test_spec_for_axes_reference_cases(axes, shape, mesh, want):
    m = MESHES[mesh]
    port = rules.spec_for_axes(axes, shape, m)
    assert tuple(port) == want
    assert _same(port, jrules.spec_for_axes(axes, shape, m))
    assert isinstance(port, rules.PartitionSpec)


def test_spec_for_axes_drawn_axes_and_shapes():
    """Hypothesis-drawn logical axes (every rule name, unknown names and
    None) and dims (powers of two times small odd factors), on both
    meshes, with and without overrides."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    names = sorted(rules.LOGICAL_RULES) + [None, "unknown"]
    dims = st.builds(lambda p, o: (2 ** p) * o, st.integers(0, 12),
                     st.sampled_from([1, 3, 5, 7, 25]))

    @hyp.settings(max_examples=300, deadline=None)
    @hyp.given(st.lists(st.tuples(st.sampled_from(names), dims),
                        min_size=0, max_size=5),
               st.sampled_from(sorted(MESHES)),
               st.sampled_from([None, {"act_seq": ("model",)},
                                {"embed": ("data",)}]))
    def check(pairs, mesh, overrides):
        axes = tuple(a for a, _ in pairs)
        shape = tuple(d for _, d in pairs)
        m = MESHES[mesh]
        assert _same(rules.spec_for_axes(axes, shape, m, overrides),
                     jrules.spec_for_axes(axes, shape, m, overrides))

    check()


def test_batch_and_chips_pspecs():
    for m in MESHES.values():
        assert _same(rules.batch_pspec(m), jrules.batch_pspec(m))
        for n in (1, 2, 32, 48, 512):
            assert _same(rules.chips_pspec(m, n, 3),
                         jrules.chips_pspec(m, n, 3))


# ------------------------------------------------------------ spec trees

def _port_leaves(tree, path=()):
    if isinstance(tree, rules.PartitionSpec):
        yield path, tuple(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (str(k),))
    else:
        for k in type(tree).TREE_FIELDS:
            yield from _port_leaves(getattr(tree, k), path + (k,))


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(tuple(str(getattr(k, "key", getattr(k, "name", k)))
                   for k in path), tuple(spec)) for path, spec in flat]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_pspecs_full_config(arch, mesh):
    """Params and train state of every arch's full config: the port's
    spec trees equal the JAX package's leaf for leaf."""
    m = MESHES[mesh]
    jlm, plm = JaxLM(jax_config(arch, "full")), LM(get_config(arch, "full"))
    jp = jrules.tree_pspecs(jlm.logical_axes(), jlm.abstract_params(), m)
    pp = rules.tree_pspecs(plm.logical_axes(), plm.abstract_params(), m)
    assert list(_port_leaves(pp)) == _jax_leaves(jp)
    jstate = jax.eval_shape(lambda: jsteps.abstract_train_state(jlm))
    js = jrules.tree_pspecs(jsteps.train_state_axes(jlm), jstate, m)
    ps = rules.tree_pspecs(steps.train_state_axes(plm),
                           steps.abstract_train_state(plm), m)
    assert list(_port_leaves(ps)) == _jax_leaves(js)


def _port_axes_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_axes_leaves(tree[k], path + (str(k),))
    else:
        yield path, tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_tree_smoke(arch):
    jlm = JaxLM(jax_config(arch, "smoke"))
    plm = LM(get_config(arch, "smoke"))
    jcache = jax.eval_shape(lambda: jlm.init_cache(2, 16))
    pcache = plm.init_cache(2, 16, device="meta")
    jaxes = jrules.cache_axes_tree(jcache)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jaxes, is_leaf=lambda x: isinstance(x, tuple))
    want = [(tuple(str(k.key) for k in p), tuple(a)) for p, a in flat]
    assert list(_port_axes_leaves(rules.cache_axes_tree(pcache))) == want
    for m in MESHES.values():
        js = jrules.tree_pspecs(jaxes, jcache, m)
        ps = rules.tree_pspecs(rules.cache_axes_tree(pcache), pcache, m)
        assert [s for _, s in _port_leaves(ps)] == \
            [s for _, s in _jax_leaves(js)]


# ------------------------------------------------------------ use_mesh

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_use_mesh_modes_match_reference(mesh):
    m = MESHES[mesh]
    for arch in ARCHS:
        for variant in ("full", "smoke"):
            j = JaxLM(jax_config(arch, variant)).use_mesh(m)
            p = LM(get_config(arch, variant)).use_mesh(m)
            assert (p.attn_mode, p.moe_groups) == (j.attn_mode,
                                                   j.moe_groups), arch
            assert not p.sharded            # a stand-in sets the modes only


# ------------------------------------------------------------ placements

@pytest.fixture
def fake_group():
    from repro_torch.launch import mesh
    yield mesh
    mesh.destroy()


def test_placements_local_shapes_fake_512(fake_group):
    """Every full-config param of a dense, an MoE and a hybrid arch as a
    DTensor on the fake (2,16,16) mesh: rank 0's shard is dim / prod(axis
    sizes) on every dim, and the layout is pod-major."""
    from torch.distributed.tensor import Shard
    mesh = fake_group.make_production_mesh(multi_pod=True, device_type="cpu")
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert rules.mesh_axis_sizes(mesh) == sizes
    for arch in ("phi3-medium-14b", "qwen3-moe-235b-a22b", "hymba-1.5b"):
        lm = LM(get_config(arch, "full"))
        specs = rules.tree_pspecs(lm.logical_axes(), lm.abstract_params(),
                                  mesh)
        placed = rules.tree_distribute(lm.logical_axes(),
                                       lm.abstract_params(), mesh)
        for (path, spec), (_, t) in zip(_port_leaves(specs),
                                        _tensor_leaves(placed)):
            want = []
            for d, entry in zip(t.shape, tuple(spec)):
                group = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                want.append(d // int(np.prod([sizes[a] for a in group])))
            assert tuple(t.to_local().shape) == tuple(want), (arch, path)
            assert tuple(t.to_local().shape) == rules.local_shape(
                t.shape, spec, mesh)
    spec = rules.PartitionSpec(("pod", "data"), "model")
    assert rules.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        rules.placements(rules.PartitionSpec(("data", "pod")), mesh)


def _tensor_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensor_leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def test_shard_offsets_are_pod_major(fake_group):
    """A dim split over ("pod","data") puts pod-major shard index
    pod * 16 + data at rank (pod, data, 0), as JAX lays it out."""
    from repro_torch.sharding.parallel import shard_offset
    mesh = fake_group.make_production_mesh(multi_pod=True, device_type="cpu")
    t = rules.distribute(torch.empty(64, 8, device="meta"),
                         rules.PartitionSpec(("pod", "data"), None), mesh)
    assert tuple(mesh.get_coordinate()) == (0, 0, 0)
    assert shard_offset(t, 0) == 0 and t.to_local().shape == (2, 8)
    mp = pytest.MonkeyPatch()
    try:    # rank (pod 1, data 3, model 5) holds rows 2 * (1 * 16 + 3) ...
        mp.setattr(t.device_mesh, "get_coordinate", lambda: [1, 3, 5])
        assert shard_offset(t, 0) == 38
    finally:
        mp.undo()


# ------------------------------------------------------------ xla_fma op

def test_xla_fma_custom_op_fake_and_dtensor(fake_group):
    """`xla_fma` is the custom op `repro_torch::xla_fma`: under
    FakeTensorMode its fake implementation gives the broadcast float32
    shape and launches nothing; on DTensors its pointwise rule keeps the
    shard, and the local result is the plain version's bits."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import xla_order as xo
    from repro_torch.kernels import ops
    assert hasattr(torch.ops.repro_torch, "xla_fma")
    ops.reset_launches()
    with FakeTensorMode():
        a = torch.empty(4, 1, 8, dtype=torch.bfloat16)
        b = torch.empty(6, 1)
        out = ops.xla_fma(a, b, 0.5)
        assert tuple(out.shape) == (4, 6, 8) and out.dtype == torch.float32
    assert ops.LAUNCHES["xla_fma"] == 0
    mesh = fake_group.make_production_mesh(device_type="cpu")
    rng = np.random.default_rng(3)
    a_l, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 5, 8), (5, 8), (8,)))
    a = DTensor.from_local(a_l, mesh, [Shard(0), Replicate()],
                           run_check=False)
    b_d = DTensor.from_local(b, mesh, [Replicate(), Replicate()],
                             run_check=False)
    c_d = DTensor.from_local(c, mesh, [Replicate(), Replicate()],
                             run_check=False)
    out = ops.xla_fma(a, b_d, c_d)
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert tuple(out.shape) == (32, 5, 8)
    want = xo.fma_plain(a_l, b, c)
    assert torch.equal(out.to_local().view(torch.int32),
                       want.view(torch.int32))
    out = ops.xla_fma(a, b_d, 2.0)
    assert torch.equal(out.to_local(), xo.fma_plain(a_l, b, 2.0))
    assert ops.LAUNCHES["xla_fma"] == 0


# ------------------------------------------------------------ no mesh

def _moe_block_before(params, x, cfg, dispatch_groups=1):
    """The MoE block as the port computed it before the mesh path (a
    verbatim copy), the yardstick of `moe_block` with no mesh."""
    from repro_torch.models.common import const, silu
    from repro_torch.models.moe import _capacity, top_k
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    G = dispatch_groups if T % dispatch_groups == 0 else 1
    Tl = T // G
    C = _capacity(cfg, Tl)
    xt = x.reshape(G, Tl, D)
    dev = x.device
    logits = torch.einsum("gtd,de->gte", xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.nn.functional.one_hot(expert_idx[..., 0], E)
                    .float(), dim=(0, 1))
    aux = const(cfg.router_aux_coef * E, me) * torch.sum(me * ce)
    sel = torch.nn.functional.one_hot(expert_idx, E)
    flat_sel = sel.reshape(G, Tl * K, E)
    pos_in_expert = torch.cumsum(flat_sel, dim=1) - flat_sel
    slot = torch.sum(pos_in_expert * flat_sel, dim=-1)
    eid = expert_idx.reshape(G, Tl * K)
    keep = slot < C
    slot = torch.where(keep, slot, torch.full_like(slot, C))
    tok_ids = torch.arange(Tl, device=dev).repeat_interleave(K)
    gidx = torch.arange(G, device=dev)[:, None].expand(G, Tl * K)
    buckets = torch.zeros((G, E, C + 1, D), dtype=x.dtype, device=dev)
    buckets[gidx, eid, slot] = xt[:, tok_ids]
    h = buckets[:, :, :C, :]
    dt = x.dtype
    gate = torch.einsum("gecd,edf->gecf", h, params["w_gate"].to(dt))
    up = torch.einsum("gecd,edf->gecf", h, params["w_up"].to(dt))
    y = torch.einsum("gecf,efd->gecd", silu(gate) * up,
                     params["w_down"].to(dt))
    y_pad = torch.cat([y, torch.zeros((G, E, 1, D), dtype=dt, device=dev)],
                      dim=2)
    y_tok = y_pad[gidx, eid, slot]
    w = (gate_vals.reshape(G, Tl * K) * keep).to(dt)
    out = torch.zeros((G, Tl, D), dtype=dt, device=dev)
    for g in range(G):
        out[g].index_add_(0, tok_ids, y_tok[g] * w[g][:, None])
    return out.reshape(B, S, D), {"aux_loss": aux,
                                  "dropped": torch.sum(~keep)}


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_moe_without_mesh_is_bit_identical(groups):
    from repro_torch import prng
    from repro_torch.models import moe
    from repro_torch.models.common import materialize
    cfg = get_config("qwen3-moe-235b-a22b", "smoke")
    params = materialize(prng.PRNGKey(5, device="cpu"), moe.moe_specs(cfg),
                         "cpu")
    x = torch.from_numpy(np.random.default_rng(groups).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    got, gaux = moe.moe_block(params, x, cfg, dispatch_groups=groups)
    want, waux = _moe_block_before(params, x, cfg, groups)
    assert torch.equal(got, want)
    assert torch.equal(gaux["aux_loss"], waux["aux_loss"])
    assert torch.equal(gaux["dropped"], waux["dropped"])


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b",
                                  "rwkv6-3b", "qwen3-moe-235b-a22b"])
def test_no_mesh_and_unsharded_stand_in_agree(arch):
    """With no mesh and after `use_mesh` of a one-device stand-in (modes
    only), apply, loss and three decode steps give the same bits."""
    from repro_torch import prng
    cfg = get_config(arch, "smoke")
    a, b = LM(cfg), LM(cfg).use_mesh(_fake_mesh((1, 1), ("data", "model")))
    assert b.attn_mode is None and not b.sharded
    params = a.init(prng.PRNGKey(0, device="cpu"), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int64))
    la, lb = a.apply(params, tok)[0], b.apply(params, tok)[0]
    assert torch.equal(la, lb)
    batch = {"tokens": tok, "labels": tok}
    assert torch.equal(a.loss(params, batch)[0], b.loss(params, batch)[0])
    ca, cb = a.init_cache(2, 8, device="cpu"), b.init_cache(2, 8,
                                                            device="cpu")
    for i in range(3):
        oa, ca = a.decode_step(params, tok[:, i:i + 1], ca)
        ob, cb = b.decode_step(params, tok[:, i:i + 1], cb)
        assert torch.equal(oa, ob)
