"""The die-sampling kernel's host side (`repro_torch.kernels.ops`'s
threefry entry points, `kernels/threefry.py`) and, on the card, the kernel
(`csrc/threefry.cu`) against the plain int64 path (`prng.*_plain`) bit for
bit under both schemes.  On the CPU every entry point takes the plain path
and counts no launch; the card's checks skip here."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_scheme(request):
    with prng.threefry_partitionable(request.param):
        yield request.param


def _draws(key, shape):
    """(entry point call, plain call) of every draw."""
    return [(lambda: prng.random_bits(key, shape),
             lambda: prng.random_bits_plain(key, shape)),
            (lambda: prng.uniform(key, shape, -0.3, 2.5),
             lambda: prng.uniform_plain(key, shape, -0.3, 2.5)),
            (lambda: prng.normal(key, shape, 0.7),
             lambda: prng.normal_plain(key, shape, 0.7)),
            (lambda: prng.lognormal(key, shape, 0.4245),
             lambda: prng.lognormal_plain(key, shape, 0.4245)),
            (lambda: prng.bernoulli(key, 0.3, shape),
             lambda: prng.bernoulli_plain(key, 0.3, shape))]


def _same(a, b):
    if a.dtype == torch.float32:
        return b.dtype == a.dtype and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_uniform_and_normal_constants_are_float32_roundings():
    lo, span = prng.uniform_consts(-0.3, 2.5)
    assert lo == float(np.float32(-0.3))
    assert span == float(np.float32(np.float32(2.5) - np.float32(-0.3)))
    assert prng.uniform_consts(prng.NORMAL_LO, 1.0)[1] == 2.0
    assert prng.normal_factor(1.0) == float(np.float32(np.sqrt(2)))
    assert prng.normal_factor(0.4245) == float(
        np.float32(np.float32(0.4245) * np.float32(np.sqrt(2))))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_cpu_entry_points_are_the_plain_path(threefry_scheme, lead):
    key = prng.fold_in(prng.PRNGKey(9, device="cpu"),
                       torch.arange(int(np.prod(lead))).reshape(lead))
    ops.reset_launches()
    for call, plain in _draws(key, (5, 3)):
        got = call()
        assert got.shape == lead + (5, 3) and _same(got, plain())
    assert _same(prng.split(key, 5), prng.split_plain(key, 5))
    assert _same(prng.fold_in(key, 4), prng.fold_in_plain(key, 4))
    ids = torch.arange(3)
    assert _same(prng.fold_in(key[..., None, :], ids),
                 prng.fold_in_plain(key[..., None, :], ids))
    assert sum(ops.LAUNCHES.values()) == 0


def test_key_rows_are_views_where_they_can_be():
    key = prng.PRNGKey(1, device="cpu")
    rows = ops._key_rows(key, (5,))
    assert rows.shape == (5, 2) and rows.stride() == (0, 1)
    keys = prng.split(prng.fold_in(key, torch.arange(4)), 3)[:, 2, :]
    rows = ops._key_rows(keys, (4,))
    assert rows.stride() == (6, 1) and rows.data_ptr() == keys.data_ptr()
    rows = ops._key_rows(keys[:, None, :], (4, 3))
    assert rows.shape == (12, 2) and rows.is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("n_keys", [1, 4])
def test_kernel_matches_plain_version_on_the_card(threefry_scheme, n_keys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    root = prng.PRNGKey(3, device=dev)
    keys = prng.fold_in(root, torch.arange(n_keys, device=dev))
    ops.reset_launches()
    calls = 0
    for shape in ((1,), (7,), (572, 60), (636, 1), (1001,)):
        for call, plain in _draws(keys, shape):
            assert _same(call(), plain())
            calls += 1
    for num in (2, 3, 5):
        assert _same(prng.split(keys, num), prng.split_plain(keys, num))
        calls += 1
    ids = torch.arange(6, device=dev)
    for k, d in ((keys, 7), (root, ids), (keys[:, None, :], ids)):
        assert _same(prng.fold_in(k, d), prng.fold_in_plain(k, d))
        calls += 1
    assert ops.LAUNCHES["threefry"] == calls


def _smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_smoke_loader import chip_smoke
    return chip_smoke()


@pytest.mark.parametrize("mode,partitionable,n_keys,shape,ms,pipe", [
    ("normal", True, 4, (294912, 60), 0.22850, "issue"),
    ("bernoulli", True, 4, (294912, 60), 0.18195, "alu"),
    ("normal", False, 4, (294912, 60), 0.15656, "issue"),
    ("lognormal", True, 512, (572, 60), 0.06461, "issue"),
    ("bits", False, 4, (294912, 60), 0.16904, "bytes")])
def test_threefry_bound_is_per_pipe(mode, partitionable, n_keys, shape, ms,
                                    pipe):
    """`chip_smoke.threefry_bound_ms`: the largest of the pipes' times for
    the instructions a word needs, and of its bytes."""
    smoke = _smoke()
    n = int(np.prod(shape))
    got, by, got_pipe = smoke.threefry_bound_ms(mode, n_keys, n,
                                                partitionable)
    assert got == pytest.approx(ms, rel=1e-4) and got_pipe == pipe
    assert by == ("bytes" if pipe == "bytes" else "operations")
    work = smoke.threefry_work(mode, partitionable)
    per_word = (sum(work.values()) / smoke.PIPE_RATE["issue"],
                work["alu"] / smoke.PIPE_RATE["alu"])
    if pipe != "bytes":
        assert got == pytest.approx(max(per_word) * n_keys * n
                                    / smoke.SM_CLOCKS_PER_S * 1e3)


def test_sass_helpers_find_the_main_loop():
    """The innermost loop (conditional backward branch) that holds a store
    is the main loop: not a loop around it, a loop inside it without a
    store, or an unconditional jump back from out-of-line code; the block
    that a warp vote guards is marked, in either layout."""
    smoke = _smoke()
    ins = [(0x00, "MOV", None, False), (0x10, "SHF.L.W.U32.HI", None, False),
           (0x20, "VOTE.ANY", None, False), (0x30, "BRA", 0x50, True),
           (0x40, "BRA", 0x70, False), (0x50, "MUFU.RSQ", None, False),
           (0x60, "FSEL", None, False), (0x70, "MUFU.RCP", None, False),
           (0x80, "BRA", 0x70, True), (0x90, "STG.E.128", None, False),
           (0xa0, "BRA", 0x10, True), (0xb0, "FFMA", None, False),
           (0xc0, "BRA", 0xb0, True), (0xd0, "BRA", 0x00, True),
           (0xe0, "IMAD", None, False), (0xf0, "BRA", 0x20, False),
           (0x100, "EXIT", None, False)]
    loop = smoke.sass_loop(ins)
    assert [op for op, _ in loop] == [
        "SHF.L.W.U32.HI", "VOTE.ANY", "BRA", "BRA", "MUFU.RSQ", "FSEL",
        "MUFU.RCP", "BRA", "STG.E.128", "BRA"]
    assert [op for op, v in loop if v] == ["MUFU.RSQ", "FSEL"]
    # a vote guard that skips its block
    ins2 = [(0x00, "VOTE.ANY", None, False), (0x10, "BRA", 0x40, True),
            (0x20, "MUFU.RSQ", None, False), (0x30, "FFMA", None, False),
            (0x40, "STG.E", None, False), (0x50, "BRA", 0x00, True)]
    assert [op for op, v in smoke.sass_loop(ins2) if v] == [
        "MUFU.RSQ", "FFMA"]
    classes, heads = smoke.sass_classes([op for op, _ in loop] + ["S2R"])
    assert classes == {"alu": 2, "control": 5, "mufu/cvt": 2, "memory": 1,
                       "other": 1}
    assert heads["BRA"] == 4 and smoke.sass_loop(ins[:3]) == []


def test_sass_classes_put_viadd_on_the_fma_pipe():
    """VIADD, sm_90's 32-bit add, issues on the FMA pipe with IMAD; IADD3
    and LOP3 on the ALU pipe."""
    classes, heads = _smoke().sass_classes(["VIADD", "IMAD.IADD", "IADD3",
                                            "LOP3.LUT", "VIADD"])
    assert classes == {"fma": 3, "alu": 2} and heads["VIADD"] == 2


@pytest.mark.parametrize("registers,warps", [(28, 64), (32, 64), (40, 48),
                                             (64, 32), (72, 24), (128, 16),
                                             (255, 8)])
def test_occupancy_from_registers(registers, warps):
    assert _smoke().occupancy_warps(registers) == warps


def test_layout_sizes_cover_every_residue():
    """Phase 3's draw sizes meet the kernel's groups of counters at every
    offset: each residue modulo twice its counters per thread once."""
    smoke = _smoke()
    from repro_torch.kernels import threefry as kern
    words = smoke.threefry_words(kern.SOURCE)
    assert words >= 1 and words % 4 == 0
    sizes = smoke.threefry_layout_n(words)
    assert sorted(n % (2 * words) for n in sizes) == list(range(2 * words))
