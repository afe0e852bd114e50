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
