"""The port's LM training step against the JAX package's, on the CPU at
every registered arch's smoke config, from the reference's params
(`convert.lm_params_from_jax`) and numpy-seeded batches.  The reference
runs jitted, as its trainer runs it.

Tolerances, stated where they are used:
  * the loss within atol 1e-5 + rtol 1e-4 (float32 in other summation
    orders);
  * each gradient leaf within relative L2 1e-5 with IRC off, 1e-3 with it
    on (the ternary weights amplify reordering);
  * the params after AdamW within lr * 1e-3, except elements whose
    reference gradient lies within the float32 reordering bound of zero
    (`_near_zero`): there Adam's step g / (|g| + eps) moves by up to 2 lr
    with the gradient's last bits.  Those elements are counted and
    printed;
  * every remat mode equal to "none" within the port bit for bit
    (`torch.equal`), and within the gradient bar of the reference's same
    mode;
  * the associative scan's states bit-identical to the jitted
    `jax.lax.associative_scan` (XLA fuses the combine's multiply-add,
    which the port fuses too), `ssm_branch` within atol 1e-5 + rtol 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.lm_config import IRCMode as JIRCMode  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import tree_leaves_with_path  # noqa: E402
from repro_torch.models.lm_config import IRCMode  # noqa: E402
from repro_torch.models.transformer import LM as TLM  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

torch.set_num_threads(2)

ARCHS = jreg.list_archs()
ATOL, RTOL = 1e-5, 1e-4
GRAD_RTOL = {False: 1e-5, True: 1e-3}
LR = 1e-3
PARAM_TOL = LR * 1e-3
# a reference gradient element within this many times its leaf's largest
# port-vs-reference gradient difference is "within the reordering bound of
# zero"; so is one under Adam's eps scale, where g / (|g| + eps) is not
# saturated and follows the gradient's last bits
NEAR_ZERO_FACTOR = 64.0
ADAM_EPS_SCALE = 1e-6


def _cfgs(arch, irc):
    jc, tc = jreg.get_config(arch, "smoke"), treg.get_config(arch, "smoke")
    if irc:
        jc = dataclasses.replace(jc, irc=JIRCMode(enabled=True))
        tc = dataclasses.replace(tc, irc=IRCMode(enabled=True))
    return JLM(jc), TLM(tc)


def _batch(vocab, rows=2, seq=8, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (rows, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree):
    return {"/".join(p): np.asarray(v, np.float64)
            for p, v in tree_leaves_with_path(jax.device_get(tree))}


def _tflat(tree):
    return {"/".join(p): v.detach().double().numpy()
            for p, v in tree_leaves_with_path(tree)}


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _port_state(jstate):
    params = lm_params_from_jax(jstate.params, device="cpu")
    return tsteps.TrainState(params=params, opt=adamw_init(params),
                             step=torch.zeros((), dtype=torch.int32))


def _lr_j(_):
    return jnp.float32(LR)


def _lr_t(_):
    return torch.tensor(LR, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, irc, microbatch=1, rows=2):
    """The jitted reference `make_train_step` from
    `init_train_state(PRNGKey(0))` on `_batch`: (state, batch, new state,
    metrics)."""
    jlm, _ = _cfgs(arch, irc)
    state = jsteps.init_train_state(jlm, jax.random.PRNGKey(0))
    batch = _batch(jlm.cfg.vocab_size, rows)
    step = jsteps.make_train_step(jlm, remat="none", lr_fn=_lr_j,
                                  microbatch=microbatch)
    new, metrics = jax.jit(step)(state, _jb(batch))
    return state, batch, new, metrics


def _near_zero(g_ref, g_port):
    """Elements whose reference gradient is within the float32 reordering
    bound of zero (see NEAR_ZERO_FACTOR)."""
    bound = max(NEAR_ZERO_FACTOR * float(np.abs(g_port - g_ref).max()),
                ADAM_EPS_SCALE)
    return np.abs(g_ref) <= bound


def _check_step(new, metrics, jnew, jmetrics, rtol, tag):
    """The metrics within atol 1e-5 + rtol 1e-4; each leaf's first moment
    m = (1 - b1) * clipped gradient within relative L2 `rtol` (the clip
    scale, min(1, 1 / grad_norm), is common to all leaves); the params
    within PARAM_TOL outside the near-zero elements, whose count it
    returns with the worst m (as (error, leaf))."""
    assert sorted(metrics) == sorted(jmetrics) == [
        "grad_norm", "loss", "lr", "moe_aux_loss", "nll", "z_loss"]
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    m_got, m_want = _tflat(new.opt["m"]), _flat(jnew.opt["m"])
    assert list(m_got) == list(m_want)
    worst = max((_rel(m_got[k], m_want[k]), k) for k in m_want)
    assert worst[0] <= rtol, (tag, worst)
    got, want = _tflat(new.params), _flat(jnew.params)
    assert list(got) == list(want)
    skipped = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        near = _near_zero(m_want[k], m_got[k])
        assert np.all(diff[~near] <= PARAM_TOL), (
            tag, k, float(diff[~near].max()))
        skipped += int(np.sum(near & (diff > PARAM_TOL)))
    v_got, v_want = _tflat(new.opt["v"]), _flat(jnew.opt["v"])
    for k in v_want:
        assert _rel(v_got[k], v_want[k]) <= 2 * rtol, (tag, "v", k)
    return skipped, worst


@pytest.mark.parametrize("irc", [False, True], ids=["irc_off", "irc_on"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, irc):
    """One step: loss, gradients (through m), AdamW's params and moments."""
    jstate, batch, jnew, jmetrics = _reference_step(arch, irc)
    _, tlm = _cfgs(arch, irc)
    state = _port_state(jstate)
    new, metrics = tsteps.make_train_step(tlm, remat="none", lr_fn=_lr_t)(
        state, _tb(batch))
    assert int(new.step) == 1 and int(new.opt["step"]) == 1
    skipped, worst = _check_step(new, metrics, jnew, jmetrics,
                                 GRAD_RTOL[irc], arch)
    print(f"{arch} irc={irc}: loss {float(metrics['loss']):.7f} vs "
          f"{float(jmetrics['loss']):.7f}; worst gradient rel L2 "
          f"{worst[0]:.2e} ({worst[1]}); near-zero gradient elements past "
          f"lr*1e-3: {skipped}")


def test_microbatch_matches_reference():
    """microbatch=2 over 4 rows (port under remat "block") against the
    reference's microbatch=2."""
    arch = "phi3-medium-14b"
    jstate, batch, jnew, jmetrics = _reference_step(
        arch, False, microbatch=2, rows=4)
    _, tlm = _cfgs(arch, False)
    new, metrics = tsteps.make_train_step(
        tlm, remat="block", lr_fn=_lr_t, microbatch=2)(
        _port_state(jstate), _tb(batch))
    skipped, worst = _check_step(new, metrics, jnew, jmetrics,
                                 GRAD_RTOL[False], "microbatch")
    print(f"microbatch=2: worst gradient rel L2 {worst[0]:.2e}; near-zero "
          f"gradient elements past lr*1e-3: {skipped}")


def test_microbatch_refuses_an_uneven_split():
    _, tlm = _cfgs("llama3-405b", False)
    params = tlm.init(prng.PRNGKey(0, device="cpu"), device="cpu")
    state = tsteps.TrainState(params, adamw_init(params),
                              torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="micro-slices"):
        tsteps.make_train_step(tlm, lr_fn=_lr_t, microbatch=3)(
            state, _tb(_batch(tlm.cfg.vocab_size, rows=2)))
    with pytest.raises(ValueError, match="microbatch"):
        tsteps.make_train_step(tlm, microbatch=0)


REMAT_ARCHS = ("hymba-1.5b", "kimi-k2-1t-a32b")


@functools.lru_cache(maxsize=None)
def _port_grads(arch, remat):
    jstate, batch, _, _ = _reference_step(arch, False)
    _, tlm = _cfgs(arch, False)
    return tsteps.value_and_grad(tlm, _port_state(jstate).params,
                                 _tb(batch), remat=remat)


@pytest.mark.parametrize("remat", ["none", "block", "dots", "names"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_modes(arch, remat):
    """Each mode's loss and gradients equal "none"'s bit for bit, and
    `jax.value_and_grad` of the jitted reference loss under the same mode
    within atol 1e-5 + rtol 1e-4 and relative L2 1e-5 per leaf."""
    loss, metrics, grads = _port_grads(arch, remat)
    loss0, metrics0, grads0 = _port_grads(arch, "none")
    assert torch.equal(loss, loss0)
    assert all(torch.equal(metrics[k], metrics0[k]) for k in metrics0)
    for (p, g), (_, g0) in zip(tree_leaves_with_path(grads),
                               tree_leaves_with_path(grads0)):
        assert torch.equal(g, g0), p
    jstate, batch, _, _ = _reference_step(arch, False)
    jlm, _ = _cfgs(arch, False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, b, remat=remat), has_aux=True))(
        jstate.params, _jb(batch))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL,
                               rtol=RTOL)
    g_ref, g_port = _flat(jgrads), _tflat(grads)
    assert list(g_port) == list(g_ref)
    for k in g_ref:
        assert _rel(g_port[k], g_ref[k]) <= GRAD_RTOL[False], k


@pytest.mark.parametrize("mode,saved", [
    ("dots", {"hymba-1.5b": 22, "musicgen-medium": 12, "rwkv6-3b": 20}),
    ("names", {"hymba-1.5b": 10, "musicgen-medium": 8, "rwkv6-3b": 0})])
def test_remat_policies_save_the_reference_set(monkeypatch, mode, saved):
    """Outputs saved by the selective policies in one forward: "dots" every
    projection matmul (hymba: 11 a layer, 4 attention + 3 MLP + 4 SSM;
    musicgen 6; rwkv6 10), "names" only the tagged attn_q/k/v and
    mlp_gate/up (hymba 5 a layer, musicgen's GELU MLP 4, rwkv6's blocks
    none, as in the reference, whose RWKV block tags nothing)."""
    name = "_save_dots" if mode == "dots" else "_save_names"
    inner = getattr(tcommon, name)
    for arch, want in saved.items():
        ops = []

        def policy(ctx, op, *args, **kwargs):
            out = inner(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and out.name == "MUST_SAVE":
                ops.append(str(op))
            return out
        monkeypatch.setattr(tcommon, name, policy)
        _, tlm = _cfgs(arch, False)
        params = tlm.init(prng.PRNGKey(0, device="cpu"), device="cpu")
        tsteps.value_and_grad(tlm, params, _tb(_batch(tlm.cfg.vocab_size)),
                              remat=mode)
        assert len(ops) == want and set(ops) <= {"aten.mm.default"}, (
            arch, ops)
    with pytest.raises(ValueError, match="remat"):
        tlm.apply(params, _tb(_batch(16))["tokens"], remat="all")


@pytest.mark.parametrize("S", [16, 64, 257])
def test_ssm_branch_matches_reference(S):
    """The associative scan's states bit-identical to the jitted
    `jax.lax.associative_scan` on the same terms, and `ssm_branch` within
    atol 1e-5 + rtol 1e-4 of the jitted reference's."""
    jlm, _ = _cfgs("hymba-1.5b", False)
    cfg = treg.get_config("hymba-1.5b", "smoke")
    jp = jax.tree.map(lambda a: a[0], jsteps.init_train_state(
        jlm, jax.random.PRNGKey(0)).params["seg0_hybrid"]["ssm"])
    tp = lm_params_from_jax(jp, device="cpu")
    x = np.random.default_rng(S).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, v: jssm.ssm_branch(p, v, jlm.cfg))(
        jp, jnp.asarray(x))
    got = tssm.ssm_branch(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    rng = np.random.default_rng(S + 1)
    a = np.exp(-np.abs(rng.normal(size=(2, S, 6, 4)))).astype(np.float32)
    b = rng.normal(size=(2, S, 6, 4)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]
    _, hs = jax.jit(lambda u, v: jax.lax.associative_scan(
        combine, (u, v), axis=1))(a, b)
    calls = []

    def counted(left, right):
        calls.append(left[0].shape[1])
        return tssm._combine(left, right)
    _, got_hs = tssm.associative_scan(
        counted, (torch.from_numpy(a), torch.from_numpy(b)), axis=1)
    assert np.array_equal(got_hs.numpy(), np.asarray(hs))
    # no loop over the sequence: two combines a level, log2(S) levels
    assert len(calls) <= 2 * int(np.ceil(np.log2(S))), len(calls)


def test_abstract_state_and_axes_match_reference():
    for arch in ("hymba-1.5b", "qwen3-moe-235b-a22b"):
        jlm, tlm = _cfgs(arch, False)
        ja = jsteps.abstract_train_state(jlm)
        ta = tsteps.abstract_train_state(tlm)
        want = {"/".join(str(getattr(k, "key", k)) for k in p):
                (tuple(v.shape), str(v.dtype))
                for p, v in jax.tree_util.tree_flatten_with_path(ja)[0]}
        got = {"/".join(p): (tuple(v.shape),
                             str(v.dtype).replace("torch.", ""))
               for p, v in tree_leaves_with_path(ta)}
        assert got == want
        assert all(v.device.type == "meta"
                   for _, v in tree_leaves_with_path(ta))
        jx, tx = jsteps.train_state_axes(jlm), tsteps.train_state_axes(tlm)
        assert tx.opt["step"] == () and tx.step == ()
        assert tx.params == jx.params
        assert tx.opt["m"] == tx.opt["v"] == tx.params


def test_eval_and_decode_steps_match_reference():
    arch = "llama3-405b"
    jlm, tlm = _cfgs(arch, False)
    jstate = jsteps.init_train_state(jlm, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jstate.params, device="cpu")
    batch = _batch(jlm.cfg.vocab_size)
    want = jax.jit(jsteps.make_eval_step(jlm))(jstate.params, _jb(batch))
    got = tsteps.make_eval_step(tlm)(params, _tb(batch))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    toks = batch["tokens"][:, :1]
    jl, _ = jax.jit(jsteps.make_decode_step(jlm))(
        jstate.params, jnp.asarray(toks), jlm.init_cache(2, 8))
    tl, cache = tsteps.make_decode_step(tlm)(
        params, torch.from_numpy(toks), tlm.init_cache(2, 8, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    assert cache["index"] == 1
