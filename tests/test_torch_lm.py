"""The port's LM zoo against the JAX package's, at every registered arch's
smoke config on the CPU: `LM.init` bit-identical, `apply` and five
`decode_step`s within atol 1e-5 + rtol 1e-4 (float32; both compute in true
float32, in different summation orders), the decode against the
teacher-forced forward within the reference's own 2e-2, the loss, MoE
capacity drops, top-k ties, IRC mode, one bfloat16 case within
3e-2 * max|ref| (the CPU backends round bfloat16 matmul intermediates
differently), the configs and registry value for value, and the synthetic
token pipeline.  The JAX side runs as its own tests run it (its decode
jitted, as its serving engine runs it)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.data import lm as jdata
from repro.models import LM as JLM
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch import prng
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import lm as tdata
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models.lm_config import IRCMode
from repro_torch.models.transformer import LM as TLM

ARCHS = jreg.list_archs()
ATOL, RTOL = 1e-5, 1e-4
DECODE_STEPS = 5


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _bits(a) -> np.ndarray:
    """A float array's bit pattern (bfloat16 included)."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    """A float tensor's bit pattern (bfloat16 included)."""
    size = t.element_size()
    return t.view(getattr(torch, f"int{8 * size}")).numpy().view(
        {2: np.uint16, 4: np.uint32}[size])


def _replace(cfg, overrides):
    return dataclasses.replace(cfg, **dict(overrides)) if overrides else cfg


@functools.lru_cache(maxsize=None)
def _ref(arch, overrides=()):
    """(reference LM, its params) at the smoke config."""
    lm = JLM(_replace(jreg.get_config(arch, "smoke"), overrides))
    return lm, lm.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port(arch, overrides=()):
    """(port LM, its params) at the smoke config, on the CPU."""
    lm = TLM(_replace(treg.get_config(arch, "smoke"), overrides))
    return lm, lm.init(prng.PRNGKey(0, device="cpu"), device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_decode(arch, overrides=()):
    lm, _ = _ref(arch, overrides)
    return jax.jit(lm.decode_step)


def _tokens(cfg, shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _ref_apply(arch, toks, overrides=()):
    lm, p = _ref(arch, overrides)
    out, _ = jax.jit(lambda q, t: lm.apply(q, t, remat="none"))(
        p, jnp.asarray(toks))
    return np.asarray(out)


def _decode_pair(arch, toks, overrides=()):
    """Stacked [B, S, V] decode logits of both packages, teacher-forced."""
    jlm, jp = _ref(arch, overrides)
    tlm, tp = _port(arch, overrides)
    dec = _ref_decode(arch, overrides)
    B, S = toks.shape
    jc, tc = jlm.init_cache(B, 16), tlm.init_cache(B, 16, device="cpu")
    ref, got = [], []
    for t in range(S):
        a, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        b, tc = tlm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc)
        ref.append(np.asarray(a)[:, 0])
        got.append(b.numpy()[:, 0])
    assert tc["index"] == S and int(jc["index"]) == S
    return np.stack(ref, 1), np.stack(got, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_bit_identical(arch):
    _, jp = _ref(arch)
    _, tp = _port(arch)
    jf, tf = dict(_flat(jax.device_get(jp))), dict(_flat(tp))
    assert list(jf) == list(tf)
    for k in jf:
        assert tuple(jf[k].shape) == tuple(tf[k].shape), k
        assert str(jf[k].dtype) == str(tf[k].dtype).split(".")[-1], k
        assert np.array_equal(_bits(jf[k]), _tbits(tf[k])), k


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_decode(arch):
    tlm, tp = _port(arch)
    toks = _tokens(tlm.cfg, (2, DECODE_STEPS))
    ref = _ref_apply(arch, toks)
    got, aux = tlm.apply(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert torch.isfinite(aux["moe_aux_loss"])
    ref_d, got_d = _decode_pair(arch, toks)
    np.testing.assert_allclose(got_d, ref_d, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode == forward within the reference's 2e-2
    (`tests/test_configs_smoke.py`), on both packages."""
    tlm, tp = _port(arch)
    toks = _tokens(tlm.cfg, (1, 5), seed=3)
    full, _ = tlm.apply(tp, torch.from_numpy(toks))
    ref_d, got_d = _decode_pair(arch, toks)
    assert np.max(np.abs(full.numpy() - got_d)) < 2e-2
    assert np.max(np.abs(_ref_apply(arch, toks) - ref_d)) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_loss(arch):
    jlm, jp = _ref(arch)
    tlm, tp = _port(arch)
    toks = _tokens(tlm.cfg, (2, 6), seed=5)
    labels = np.roll(toks, -1, 1)
    jl, jm = jax.jit(lambda p, b: jlm.loss(p, b, remat="none"))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tl, tm = tlm.loss(tp, {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels)})
    for k in ("loss", "nll", "z_loss", "moe_aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert float(tl) == float(tm["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal(arch):
    for variant in ("full", "smoke"):
        j = dataclasses.asdict(jreg.get_config(arch, variant))
        t = dataclasses.asdict(treg.get_config(arch, variant))
        assert j == t, variant
        jc, tc = jreg.get_config(arch, variant), treg.get_config(arch, variant)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.global_layer_flags() == jc.global_layer_flags()
        assert tc.adtype == getattr(torch, jc.dtype)
        for s in jshapes.SHAPES:
            assert (tshapes.shape_applicable(tc, tshapes.SHAPES[s])
                    == jshapes.shape_applicable(jc, jshapes.SHAPES[s]))
    # the spec trees: shapes, axes, init, scale and dtype leaf by leaf
    js = dict(_flat(JLM(jreg.get_config(arch, "full")).specs()))
    ts = dict(_flat(TLM(treg.get_config(arch, "full")).specs()))
    assert list(js) == list(ts)
    for k, s in js.items():
        u = ts[k]
        assert (u.shape, u.axes, u.init, u.scale) == (
            s.shape, s.axes, s.init, s.scale), k
        assert str(u.dtype).split(".")[-1] == jnp.dtype(s.dtype).name, k


def test_registry():
    assert treg.list_archs() == jreg.list_archs()
    assert treg.ARCH_STATUS == jreg.ARCH_STATUS
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    with pytest.raises(KeyError):
        treg.get_config("gpt-2")
    with pytest.raises(ValueError):
        treg.get_config("phi3-medium-14b", "tiny")


def test_abstract_and_axes():
    tlm = TLM(treg.get_config("kimi-k2-1t-a32b", "smoke"))
    jlm = JLM(jreg.get_config("kimi-k2-1t-a32b", "smoke"))
    ja = dict(_flat(jax.device_get(jlm.abstract_params())))
    ta = dict(_flat(tlm.abstract_params()))
    assert list(ja) == list(ta)
    for k in ja:
        assert ta[k].device.type == "meta"
        assert tuple(ta[k].shape) == tuple(ja[k].shape), k
    jx = jax.tree.leaves(jlm.logical_axes(),
                         is_leaf=lambda x: isinstance(x, tuple))
    tx = [v for _, v in _flat(tlm.logical_axes())]
    assert jx == tx


def test_materialize_dtypes_bit_identical():
    """zeros / ones / scaled / normal leaves, float32 and bfloat16, nested:
    `materialize` equals the reference's bit for bit."""
    def specs(mod, f32, bf16):
        P = mod.ParamSpec
        return {"b": {"z": P((3,), (None,), init="zeros", dtype=bf16),
                      "w": P((4, 5), (None, None), dtype=bf16)},
                "a": P((7, 3, 2), (None, None, None), init="scaled",
                       scale=0.1, dtype=f32),
                "c": P((6,), (None,), init="ones", dtype=f32),
                "d": P((2, 9), (None, None), scale=2.0, dtype=f32)}
    ref = jcommon.materialize(
        jax.random.PRNGKey(9), specs(jcommon, jnp.float32, jnp.bfloat16))
    got = tcommon.materialize(
        prng.PRNGKey(9, device="cpu"),
        specs(tcommon, torch.float32, torch.bfloat16), device="cpu")
    rf, gf = dict(_flat(jax.device_get(ref))), dict(_flat(got))
    assert list(rf) == list(gf)
    for k in rf:
        assert np.array_equal(_bits(rf[k]), _tbits(gf[k])), k


def test_lm_params_from_jax_keeps_dtypes():
    over = (("dtype", "bfloat16"), ("param_dtype", "bfloat16"))
    _, jp = _ref("phi3-medium-14b", over)
    _, tp = _port("phi3-medium-14b", over)
    got = lm_params_from_jax(jax.device_get(jp), device="cpu")
    for (k, a), (_, b) in zip(_flat(got), _flat(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_bf16_case():
    """phi3 smoke in bfloat16 (activations and params): init bit-identical,
    apply and decode within 3e-2 * max|ref|."""
    arch = "phi3-medium-14b"
    over = (("dtype", "bfloat16"), ("param_dtype", "bfloat16"))
    _, jp = _ref(arch, over)
    tlm, tp = _port(arch, over)
    for (k, a), (_, b) in zip(_flat(jax.device_get(jp)), _flat(tp)):
        assert b.dtype == torch.bfloat16 and np.array_equal(
            _bits(a), _tbits(b)), k
    toks = _tokens(tlm.cfg, (2, DECODE_STEPS))
    ref = _ref_apply(arch, toks, over)
    got, _ = tlm.apply(tp, torch.from_numpy(toks))
    bar = 3e-2 * np.max(np.abs(ref))
    assert np.max(np.abs(got.numpy() - ref)) <= bar
    ref_d, got_d = _decode_pair(arch, toks, over)
    assert np.max(np.abs(got_d - ref_d)) <= 3e-2 * np.max(np.abs(ref_d))


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "hymba-1.5b",
                                  "rwkv6-3b", "qwen3-moe-235b-a22b"])
def test_irc_mode(arch):
    """IRC mode on: every projection ternary-quantized through the STE
    (the port's `ternary_quantize`), apply and decode within tolerance."""
    over = (("irc", IRCMode(enabled=True)),)
    tlm, tp = _port(arch, over)
    toks = _tokens(tlm.cfg, (2, 4), seed=7)
    got, _ = tlm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), _ref_apply(arch, toks, over),
                               atol=ATOL, rtol=RTOL)
    ref_d, got_d = _decode_pair(arch, toks, over)
    np.testing.assert_allclose(got_d, ref_d, atol=ATOL, rtol=RTOL)


def _expected_drops(cfg, x, router):
    """Assignments beyond capacity, from the reference's routing."""
    T = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    counts = np.zeros(cfg.n_experts, int)
    dropped = 0
    for e in np.asarray(idx).reshape(-1):
        dropped += counts[e] >= jmoe._capacity(cfg, T)
        counts[e] += 1
    return dropped


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_capacity_drops(groups):
    """A small capacity factor drops tokens; the port drops the same ones
    (outputs within tolerance, dropped count as the reference routes)."""
    arch = "qwen3-moe-235b-a22b"
    over = (("capacity_factor", 0.25),)
    jlm, jp = _ref(arch, over)
    tlm, tp = _port(arch, over)
    cfg = tlm.cfg
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["seg0_moe"]["moe"])
    tl = {k: v[0] for k, v in tp["seg0_moe"]["moe"].items()}
    ref, raux = jax.jit(lambda p, v: jmoe.moe_block(
        p, v, jlm.cfg, dispatch_groups=groups))(jl, jnp.asarray(x))
    got, aux = tmoe.moe_block(tl, torch.from_numpy(x), cfg,
                              dispatch_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(raux["aux_loss"]), rtol=RTOL)
    if groups == 1:
        want = _expected_drops(cfg, x, np.asarray(jl["router"]))
        assert want > 0 and int(aux["dropped"]) == want
    toks = _tokens(cfg, (2, 8), seed=11)
    full, _ = tlm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(full.numpy(), _ref_apply(arch, toks, over),
                               atol=ATOL, rtol=RTOL)


def test_top_k_ties_to_lower_index():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 5):
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = tmoe.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(np.asarray(ri), gi.numpy())
        assert np.array_equal(np.asarray(rv), gv.numpy())


def test_ssm_branch_long_sequence():
    """The hybrid block's prefill scan over 24 steps (both packages'
    associative scan; the einsum and projections sum in other orders)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    jlm, jp = _ref("hymba-1.5b")
    _, tp = _port("hymba-1.5b")
    x = np.random.default_rng(2).normal(
        size=(2, 24, jlm.cfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, v: jssm.ssm_branch(p, v, jlm.cfg))(
        jax.tree.map(lambda a: a[0], jp["seg0_hybrid"]["ssm"]),
        jnp.asarray(x))
    got = tssm.ssm_branch({k: v[0] for k, v in
                           tp["seg0_hybrid"]["ssm"].items()},
                          torch.from_numpy(x), treg.get_config("hymba-1.5b",
                                                               "smoke"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("step,host,n_hosts", [(0, 0, 1), (3, 0, 1),
                                               (7, 1, 2)])
def test_lm_batches_equal(step, host, n_hosts):
    ref = jdata.SyntheticLMData(vocab_size=300, seq_len=24, global_batch=4,
                                seed=5).batch_for_step(step, host, n_hosts)
    got = tdata.SyntheticLMData(vocab_size=300, seq_len=24, global_batch=4,
                                seed=5).batch_for_step(step, host, n_hosts,
                                                       device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    direct = tdata.lm_batch_for_step(128, 8, 2, step, device="cpu")
    jd = jdata.lm_batch_for_step(128, 8, 2, step)
    assert np.array_equal(direct["tokens"].numpy(), np.asarray(jd["tokens"]))
