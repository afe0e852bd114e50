"""The port's IRC MVM: its plain PyTorch version against the JAX package's
kernel oracle (`repro.kernels.ref`), the dispatch of `repro_torch.kernels.ops`,
and — on a machine with a card — the CUDA kernel against the plain version.

Same numpy inputs on both sides, for every layout (shared / per-chip word
lines x shared / per-chip placement planes) and both outputs.  Counts are
exact; `output="diff"` agrees within 1e-4 (the two sides sum the 32-row
blocks and the 18 IR blocks in different float32 orders); binary outputs are
equal except at near-ties, which are counted."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build as nvb  # noqa: E402
from repro_torch.kernels import irc_mvm as kern  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)

C, B, R, N = 3, 40, 572, 60
OFF = dict(apply_nonlinearity=False, apply_ir=False, apply_sa=False,
           apply_range=False)


def _case(seed, per_chip_x, per_chip_g):
    """Detector-like operands: 32 bias rows, ternary 20/60/20 placement,
    log-normal effective planes with the HRS leak, word lines at 0.5."""
    rng = np.random.default_rng(seed)
    n_g = C if per_chip_g else 1
    u = rng.random((n_g, R, N))
    gp = (u > 0.8).astype(np.float32)
    gn = (u < 0.2).astype(np.float32)
    gp[:, :32] = 1.0
    gn[:, :32] = 1.0

    def eff(g):
        m = np.exp(0.4245 * rng.standard_normal((C, R, N))).astype(np.float32)
        return (g * m + (1.0 - g) * 1e-4).astype(np.float32)

    ep, en = eff(gp), eff(gn)
    lead = (C,) if per_chip_x else ()
    x = (rng.random(lead + (B, R)) < 0.5).astype(np.float32)
    x[..., :32] = 1.0
    eps = rng.standard_normal((C, B, N)).astype(np.float32)
    rnd = (rng.random((C, B, N)) < 0.5).astype(np.float32)
    if not per_chip_g:
        gp, gn = gp[0], gn[0]
    return x, ep, en, gp, gn, eps, rnd


def _params(mod, output, effects):
    return mod.IrcEpilogueParams(output=output,
                                 **({} if effects == "all" else OFF))


def _both(arrs, params_kw):
    output, effects = params_kw
    j = np.asarray(jref.irc_mvm_chips_ref(*map(jnp.asarray, arrs),
                                          _params(jref, output, effects)))
    t, margin = tref.irc_mvm_chips_ref(*map(torch.from_numpy, arrs),
                                       _params(tref, output, effects),
                                       margin=True)
    return j, t.numpy(), margin


LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("per_chip_x,per_chip_g", LAYOUTS)
def test_counts_exact(per_chip_x, per_chip_g):
    """e+ := g+ (e- := 0) with every effect off makes the diff output the
    activated-LRS count p+ (and -p- the other way): exact on both sides."""
    x, ep, en, gp, gn, eps, rnd = _case(1, per_chip_x, per_chip_g)
    zeros = np.zeros_like(ep)
    gpc = np.broadcast_to(gp, ep.shape).copy()
    gnc = np.broadcast_to(gn, en.shape).copy()
    for a, b in ((gpc, zeros), (zeros, gnc)):
        j, t, _ = _both((x, a, b, gp, gn, eps, rnd), ("diff", "none"))
        np.testing.assert_array_equal(j, t)
        assert np.all(t == np.round(t))


@pytest.mark.parametrize("effects", ["all", "none"])
@pytest.mark.parametrize("per_chip_x,per_chip_g", LAYOUTS)
def test_diff_and_binary_match_reference(per_chip_x, per_chip_g, effects):
    arrs = _case(2, per_chip_x, per_chip_g)
    j, t, _ = _both(arrs, ("diff", effects))
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    jb, tb, margin = _both(arrs, ("binary", effects))
    n, ok = tref.near_tie_flips(torch.tensor(jb), torch.tensor(tb),
                                margin)
    print(f"near-tie binary flips: {n} of {tb.size}")
    assert ok and n <= 0.001 * tb.size


def test_single_chip_matches_reference():
    x, ep, en, gp, gn, eps, rnd = _case(3, False, False)
    args = (x, ep[0], en[0], gp, gn, eps[0], rnd[0])
    for output in ("diff", "binary"):
        j = np.asarray(jref.irc_mvm_ref(*map(jnp.asarray, args),
                                        _params(jref, output, "all")))
        t, margin = tref.irc_mvm_ref(*map(torch.from_numpy, args),
                                     _params(tref, output, "all"),
                                     margin=True)
        assert t.shape == (B, N)
        if output == "diff":
            np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=0)
        else:
            assert tref.near_tie_flips(torch.tensor(j), t, margin)[1]


def test_against_pallas_interpret():
    """One tiny case against the Pallas kernel itself (interpret mode)."""
    from repro.kernels.ops import irc_mvm_chips as pallas_chips
    rng = np.random.default_rng(4)
    c, b, r, n = 2, 8, 64, 16
    x = (rng.random((c, b, r)) < 0.5).astype(np.float32)
    gp = (rng.random((r, n)) < 0.3).astype(np.float32)
    gn = (rng.random((r, n)) < 0.3).astype(np.float32)
    ep = (gp * np.exp(0.4 * rng.standard_normal((c, r, n)))).astype(
        np.float32)
    en = (gn * np.exp(0.4 * rng.standard_normal((c, r, n)))).astype(
        np.float32)
    eps = rng.standard_normal((c, b, n)).astype(np.float32)
    rnd = (rng.random((c, b, n)) < 0.5).astype(np.float32)
    arrs = (x, ep, en, gp, gn, eps, rnd)
    p = _params(jref, "diff", "all")
    j = np.asarray(pallas_chips(*map(jnp.asarray, arrs), p, interpret=True))
    t = ops.irc_mvm_chips(*map(torch.from_numpy, arrs),
                          _params(tref, "diff", "all"))
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=0)


def test_cpu_tensor_uses_plain_version_without_counting():
    x, ep, en, gp, gn, eps, rnd = map(torch.from_numpy,
                                      _case(5, True, False))
    ops.reset_launches()
    p = tref.IrcEpilogueParams()
    out = ops.irc_mvm_chips(x, ep, en, gp, gn, eps, rnd, p)
    torch.testing.assert_close(
        out, tref.irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd, p),
        rtol=0, atol=0)
    single = ops.irc_mvm(x[0], ep[0], en[0], gp, gn, eps[0], rnd[0], p)
    assert single.shape == (B, N)
    assert ops.LAUNCHES == {"irc_mvm_chips": 0, "irc_mvm": 0,
                            "ternary_matmul": 0, "flash_attention": 0,
                            "xla_fma": 0, "xla_erf_inv": 0, "xla_exp": 0}


def test_shape_checks_raise():
    x, ep, en, gp, gn, eps, rnd = map(torch.from_numpy,
                                      _case(6, False, False))
    p = tref.IrcEpilogueParams()
    with pytest.raises(ValueError, match="x must be"):
        ops.irc_mvm_chips(x[:, :-1], ep, en, gp, gn, eps, rnd, p)
    with pytest.raises(ValueError, match="gp/gn"):
        ops.irc_mvm_chips(x, ep, en, gp[:-1], gn, eps, rnd, p)
    with pytest.raises(ValueError, match="eps_sa"):
        ops.irc_mvm_chips(x, ep, en, gp, gn, eps[:, :-1], rnd, p)


def test_cuda_request_raises_when_kernel_cannot_load(monkeypatch):
    """A CUDA operand never reaches the plain version: if the kernel cannot
    be built or loaded the call raises and counts nothing."""
    x, ep, en, gp, gn, eps, rnd = map(torch.from_numpy,
                                      _case(7, False, False))

    def no_kernel():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ops, "_check", lambda *a: torch.device("cuda"))
    monkeypatch.setattr(kern, "load", no_kernel)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.irc_mvm_chips(x, ep, en, gp, gn, eps, rnd,
                          tref.IrcEpilogueParams())
    assert ops.LAUNCHES["irc_mvm_chips"] == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the shared build step raises before it makes any
    directory."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(nvb, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(nvb.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(nvb.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvb.build(kern.SOURCE)
    assert not (tmp_path / "build").exists()


def test_epilogue_flags_and_near_tie_helper():
    assert kern.epilogue_flags(tref.IrcEpilogueParams()) == 15
    assert kern.epilogue_flags(tref.IrcEpilogueParams(output="diff",
                                                      **OFF)) == 16
    a = torch.tensor([1.0, 0.0, 1.0])
    b = torch.tensor([1.0, 1.0, 0.0])
    assert tref.near_tie_flips(a, a, torch.zeros(3)) == (0, True)
    assert tref.near_tie_flips(a, b, torch.tensor([5.0, 1e-5, 1e-4])) == (
        2, True)
    assert tref.near_tie_flips(a, b, torch.tensor([0.0, 1e-5, 1.0])) == (
        2, False)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("per_chip_x,per_chip_g", LAYOUTS)
def test_cuda_kernel_matches_plain_version(cuda_device, per_chip_x,
                                           per_chip_g):
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in _case(8, per_chip_x, per_chip_g)]
    for output in ("diff", "binary"):
        p = _params(tref, output, "all")
        ops.reset_launches()
        got = ops.irc_mvm_chips(*arrs, p)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["irc_mvm_chips"] == 1
        want, margin = tref.irc_mvm_chips_ref(*arrs, p, margin=True)
        if output == "diff":
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            assert tref.near_tie_flips(got, want, margin)[1]
