"""The port's IRC MVM: its plain PyTorch version against the JAX package's
kernel oracle (`repro.kernels.ref`), the dispatch of `repro_torch.kernels.ops`,
and — on a machine with a card — the CUDA kernel against the plain version.

Same numpy inputs on both sides, for every layout (shared / per-chip word
lines x shared / per-chip placement planes) and both outputs.  Counts are
exact; `output="diff"` agrees within 1e-4 (the two sides sum the 32-row
blocks and the 18 IR blocks in different float32 orders); binary outputs are
equal except at near-ties, which are counted.  Ragged shapes (`RAGGED`) hold
the same contract where R, B and N are off the CUDA kernel's tiles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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


def _case(seed, per_chip_x, per_chip_g, shape=(C, B, R, N)):
    """Detector-like operands: 32 bias rows, ternary 20/60/20 placement,
    log-normal effective planes with the HRS leak, word lines at 0.5;
    `shape` is (chips, word-line rows, planes' rows, columns)."""
    C, B, R, N = shape
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


def _both(arrs, params_kw, jit=False):
    output, effects = params_kw
    p = _params(jref, output, effects)
    oracle = (jax.jit(lambda *a: jref.irc_mvm_chips_ref(*a, p)) if jit
              else lambda *a: jref.irc_mvm_chips_ref(*a, p))
    j = np.asarray(oracle(*map(jnp.asarray, arrs)))
    t, margin = tref.irc_mvm_chips_ref(*map(torch.from_numpy, arrs),
                                       _params(tref, output, effects),
                                       margin=True)
    return j, t.numpy(), margin


LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
# (C, B, R, N, per-chip x, per-chip g) across the CUDA kernel's tile edges:
# 10, 19 and 32 IR blocks (the 18/19 step between its two instantiations,
# the 1,024-row limit), word-line rows off its 32-row tile, and column
# counts off its 32-column tile
RAGGED = [(2, 33, 300, 100, True, False), (3, 17, 600, 60, False, True),
          (1, 15, 1000, 100, True, True), (2, 31, 1024, 64, False, False)]


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


@pytest.mark.parametrize("c,b,r,n,per_chip_x,per_chip_g", RAGGED)
def test_ragged_counts_exact(c, b, r, n, per_chip_x, per_chip_g):
    """The counts at the ragged shapes: exact integers on both sides."""
    x, ep, en, gp, gn, eps, rnd = _case(9, per_chip_x, per_chip_g,
                                        (c, b, r, n))
    zeros = np.zeros_like(ep)
    for a, z in ((np.broadcast_to(gp, ep.shape).copy(), zeros),
                 (zeros, np.broadcast_to(gn, en.shape).copy())):
        j, t, _ = _both((x, a, z, gp, gn, eps, rnd), ("diff", "none"))
        np.testing.assert_array_equal(j, t)
        assert np.all(t == np.round(t))


@pytest.mark.parametrize("effects", ["all", "none"])
@pytest.mark.parametrize("c,b,r,n,per_chip_x,per_chip_g", RAGGED)
def test_ragged_diff_and_binary_match_reference(c, b, r, n, per_chip_x,
                                                per_chip_g, effects):
    """The plain version against the JAX oracle, jitted as the reference's
    sweeps run it, where R is not a multiple of the IR block and B and N
    are off every tile.  (Eager and jitted JAX differ from each other by
    up to 2e-4 at R = 1,000 with the nonlinearity on: eager JAX sums the
    32-row blocks in another order.)"""
    arrs = _case(10, per_chip_x, per_chip_g, (c, b, r, n))
    j, t, _ = _both(arrs, ("diff", effects), jit=True)
    assert t.shape == (c, b, n)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    jb, tb, margin = _both(arrs, ("binary", effects), jit=True)
    n_flips, ok = tref.near_tie_flips(torch.tensor(jb), torch.tensor(tb),
                                      margin)
    assert ok and n_flips <= 0.001 * tb.size


@pytest.mark.parametrize("r", [77, 572, 1000])
def test_one_row_or_column_sums_as_in_a_batch(r):
    """An output does not depend on how many word-line rows or columns
    share the call: one row or one column (the matrix-vector paths of
    torch and cuBLAS) gives the bits it gets among 3 rows or 60 columns,
    the ascending block order that XLA's dot and the CUDA kernel keep."""
    x, ep, en, gp, gn, eps, rnd = map(torch.from_numpy,
                                      _case(11, True, False, (2, 3, r, 60)))
    row = (slice(None), slice(0, 1))
    col = (slice(None), slice(None), slice(0, 1))
    for output in ("diff", "binary"):
        p = _params(tref, output, "all")
        three = tref.irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd, p)
        one_row = tref.irc_mvm_chips_ref(
            x[row].contiguous(), ep, en, gp, gn, eps[row].contiguous(),
            rnd[row].contiguous(), p)
        assert torch.equal(one_row, three[row])
        one_col = tref.irc_mvm_chips_ref(
            x, ep[col].contiguous(), en[col].contiguous(),
            gp[:, :1].contiguous(), gn[:, :1].contiguous(),
            eps[col].contiguous(), rnd[col].contiguous(), p)
        assert torch.equal(one_col, three[col])


def test_counts_of_any_word_lines_are_one_ascending_chain():
    """Counts of word lines that are not all 0 or 1: the plain version takes
    them as one fused multiply-add chain from +0 over R in ascending order,
    the CUDA kernel's order, whatever order the backend's matmul sums in;
    {0,1} word lines keep the matmul, exact in any order."""
    from repro_torch import xla_order as xo
    rng = np.random.default_rng(12)
    g = torch.from_numpy((rng.random((300, 7)) < 0.3).astype(np.float32))
    for x in (torch.from_numpy(rng.random((2, 9, 300)).astype(np.float32)),
              torch.from_numpy((rng.random((2, 9, 300)) < 0.5)
                               .astype(np.float32))):
        want = torch.zeros((2, 9, 7))
        for r in range(300):
            want = xo.fma_plain(x[..., r:r + 1], g[r:r + 1], want)
        assert torch.equal(tref._counts(x, g), want)


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
                            "xla_fma": 0, "xla_erf_inv": 0, "xla_exp": 0,
                            "threefry": 0}


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


def test_k1_launches_count_by_design_and_tile(monkeypatch):
    """A launch on the card counts once in LAUNCHES and once in
    K1_LAUNCHES under the kernel's design and the tile it ran at: the
    tile asked for, or for none the tuning table's (here the default);
    the plain version on the CPU counts in neither."""
    arrs = list(map(torch.from_numpy, _case(12, True, False)))
    p = tref.IrcEpilogueParams()
    ops.reset_launches()
    ops.irc_mvm_chips(*arrs, p)
    assert sum(ops.K1_LAUNCHES.values()) == 0
    tiles = []
    monkeypatch.setattr(ops, "_check", lambda *a: torch.device("cuda"))
    monkeypatch.setattr(kern, "load", lambda: None)
    monkeypatch.setattr(kern, "launch_chips",
                        lambda *a: tiles.append(a[-1]))
    monkeypatch.setattr(ops, "k1_tile",
                        lambda dev, C, B, N, R, tile=None: tile
                        or kern.DEFAULT_TILE)
    for tile in (None, *kern.TILES, kern.TILES[0]):
        ops.irc_mvm_chips(*arrs, p, tile=tile)
    ops.irc_mvm(arrs[0][0], arrs[1][0], arrs[2][0], *arrs[3:5], arrs[5][0],
                arrs[6][0], p)
    assert tiles == [kern.DEFAULT_TILE, *kern.TILES, kern.TILES[0],
                     kern.DEFAULT_TILE]
    want = {f"{kern.DESIGN}/{bm}x{tm}": 0 for bm, tm in kern.TILES}
    for t in tiles:
        want[f"{kern.DESIGN}/{t[0]}x{t[1]}"] += 1
    assert ops.K1_LAUNCHES == want
    assert ops.LAUNCHES["irc_mvm_chips"] == len(kern.TILES) + 2
    assert ops.LAUNCHES["irc_mvm"] == 1
    ops.reset_launches()
    assert set(ops.K1_LAUNCHES.values()) == {0}


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
@pytest.mark.parametrize("tile", kern.TILES)
@pytest.mark.parametrize("per_chip_g", [False, True])
def test_cuda_kernel_matches_plain_version_off_bits(cuda_device,
                                                    per_chip_g, tile):
    """Word lines in [0, 1): the kernel's FFMA chains (currents and counts)
    and the plain version's give the same bits, at every row tile."""
    x, ep, en, gp, gn, eps, rnd = [
        torch.from_numpy(a).to(cuda_device)
        for a in _case(13, True, per_chip_g)]
    x = torch.rand(x.shape, device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(13))
    for output in ("diff", "binary"):
        p = _params(tref, output, "all")
        got = ops.irc_mvm_chips(x, ep, en, gp, gn, eps, rnd, p, tile=tile)
        want = tref.irc_mvm_chips_ref(x, ep, en, gp, gn, eps, rnd, p)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def _check_cuda_case(arrs, tile):
    """Counts exact, diff and binary outputs bit-identical to the plain
    version at row tile `tile`, one launch a call, counted at that tile."""
    x, ep, en, gp, gn, eps, rnd = arrs
    counts = _params(tref, "diff", "none")
    zeros = torch.zeros_like(ep)
    for a, z, g, sign in ((gp.expand(ep.shape).contiguous(), zeros, gp, 1.0),
                          (zeros, gn.expand(en.shape).contiguous(), gn,
                           -1.0)):
        got = ops.irc_mvm_chips(x, a, z, gp, gn, eps, rnd, counts, tile=tile)
        assert torch.equal(got, sign * (x @ g).expand(got.shape))
    for output in ("diff", "binary"):
        p = _params(tref, output, "all")
        ops.reset_launches()
        got = ops.irc_mvm_chips(*arrs, p, tile=tile)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["irc_mvm_chips"] == 1
        assert ops.K1_LAUNCHES[f"{kern.DESIGN}/{tile[0]}x{tile[1]}"] == 1
        want = tref.irc_mvm_chips_ref(*arrs, p)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", kern.TILES)
@pytest.mark.parametrize("shape", [(C, B, R, N)]
                         + [tuple(case[:4]) for case in RAGGED])
@pytest.mark.parametrize("per_chip_x,per_chip_g", LAYOUTS)
def test_cuda_kernel_matches_plain_version(cuda_device, per_chip_x,
                                           per_chip_g, shape, tile):
    """On the card the kernel adds and rounds in the plain version's order:
    counts and diff bit-identical, binary outputs equal, at every row
    tile."""
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in _case(8, per_chip_x, per_chip_g, shape)]
    _check_cuda_case(arrs, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", kern.TILES)
def test_cuda_kernel_matches_plain_version_layer_layout(cuda_device, tile):
    """The macro layer's layout: many dies (64) on one batch of 256 shared
    word lines, per-die effective planes, shared placement planes."""
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in _case(9, False, False, (64, 256, R, N))]
    _check_cuda_case(arrs, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", kern.TILES)
@pytest.mark.parametrize("per_chip_x", [False, True])
def test_cuda_kernel_signed_and_nonfinite_planes(cuda_device, per_chip_x,
                                                 tile):
    """Effective planes with negative values (the QAT path's deviation
    planes) take the bit path and match the plain version bit for bit;
    an inf or a NaN in a plane row where some word lines are 0 (0 * inf is
    NaN in the chain) sends its IR block to the FFMA chain, and the outputs
    match too, NaNs where the plain version's are."""
    x, ep, en, gp, gn, eps, rnd = [
        torch.from_numpy(a).to(cuda_device)
        for a in _case(11, per_chip_x, False)]
    g = torch.Generator(cuda_device).manual_seed(11)
    sign = torch.where(torch.rand(ep.shape, device=cuda_device, generator=g)
                       < 0.5, -1.0, 1.0)
    signed = (ep * sign, en * sign.flip(-1))
    for output in ("diff", "binary"):
        for effects in ("all", "none"):
            p = _params(tref, output, effects)
            got = ops.irc_mvm_chips(x, *signed, gp, gn, eps, rnd, p,
                                    tile=tile)
            want = tref.irc_mvm_chips_ref(x, *signed, gp, gn, eps, rnd, p)
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    ep_bad, en_bad = ep.clone(), en.clone()
    ep_bad[0, 100, 7] = float("inf")
    en_bad[-1, 300, 50] = float("nan")
    ep_bad[-1, 571, 59] = float("-inf")
    assert bool((x[..., 100] == 0).any()) and bool((x[..., 300] == 0).any())
    for output in ("diff", "binary"):
        p = _params(tref, output, "none")
        got = ops.irc_mvm_chips(x, ep_bad, en_bad, gp, gn, eps, rnd, p,
                                tile=tile)
        want = tref.irc_mvm_chips_ref(x, ep_bad, en_bad, gp, gn, eps, rnd, p)
        assert bool(want.isnan().any()) == (output == "diff")
        torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
