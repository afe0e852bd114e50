"""Bit parity of the port's threefry PRNG (`repro_torch.prng`) with
`jax.random` under the partitionable threefry scheme.

Key words, raw bits, uniforms and bernoulli draws must be bit-identical, so
that chip c of the port is the same die as chip c of the JAX package.
Normals go through an f32 `erf_inv` whose `log1p` differs from XLA's in the
last bit on some inputs: they must agree within 1e-6 * max(1, |z|), and the
test reports how many are not bit-identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _partitionable():
    """The port implements jax_threefry_partitionable=True only; with the
    flag off JAX draws other bits from split/bits, so parity is moot."""
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("jax_threefry_partitionable is False: the port "
                    "implements the partitionable threefry scheme only")


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _tkey(seed):
    return prng.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_key_words_match(seed):
    k, tk = jax.random.PRNGKey(seed), _tkey(seed)
    assert np.array_equal(_words(k), tk.numpy())
    for d in (0, 1, 7, 123456, 2**32 - 1):
        assert np.array_equal(_words(jax.random.fold_in(k, d)),
                              prng.fold_in(tk, d).numpy())
    for num in (2, 3, 5):
        assert np.array_equal(_words(jax.random.split(k, num)),
                              prng.split(tk, num).numpy())


def test_vmapped_chip_ids_and_detector_lattice():
    """fold_in over chip ids, then the detector's (layer, group) lattice
    fold_in(fold_in(fold_in(key, c), s*10+b), g), then the 3-way split of
    `sample_chip_planes` and the SA split — all on batched keys."""
    k, tk = jax.random.PRNGKey(11), _tkey(11)
    ids = np.arange(6, dtype=np.uint32)
    jk = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(k, i), 21), 3))(jnp.asarray(ids))
    tk3 = prng.fold_in(prng.fold_in(prng.fold_in(tk, torch.arange(6)), 21), 3)
    assert np.array_equal(_words(jk), tk3.numpy())
    js = jax.vmap(lambda kk: jax.random.split(kk, 3))(jk)
    assert np.array_equal(_words(js), prng.split(tk3, 3).numpy())
    jsa = jax.vmap(jax.random.split)(js[:, 2])
    assert np.array_equal(_words(jsa), prng.split(prng.split(tk3, 3)[:, 2])
                          .numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (128, 60)])
def test_bits_uniform_bernoulli_exact(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    tk = prng.fold_in(_tkey(3), 9)
    assert np.array_equal(np.asarray(jax.random.bits(k, shape)).astype(
        np.int64), prng.random_bits(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(k, shape)),
                          prng.uniform(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.bernoulli(k, 0.5, shape)),
                          prng.bernoulli(tk, 0.5, shape).numpy())


def test_batched_keys_match_vmap():
    k, tk = jax.random.PRNGKey(5), _tkey(5)
    jk = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(4))
    tks = prng.fold_in(tk, torch.arange(4))
    jb = jax.vmap(lambda kk: jax.random.bernoulli(kk, 0.5, (6, 7)))(jk)
    assert np.array_equal(np.asarray(jb), prng.bernoulli(tks, 0.5, (6, 7))
                          .numpy())
    ju = jax.vmap(lambda kk: jax.random.uniform(kk, (9,)))(jk)
    assert np.array_equal(np.asarray(ju), prng.uniform(tks, (9,)).numpy())


def test_normals_within_tolerance_and_report_mismatches():
    k, tk = jax.random.PRNGKey(17), _tkey(17)
    z = np.asarray(jax.random.normal(k, (200_000,)))
    tz = prng.normal(tk, (200_000,)).numpy()
    err = np.abs(z - tz)
    assert np.all(err <= 1e-6 * np.maximum(1.0, np.abs(z)))
    n_diff = int(np.sum(z != tz))
    print(f"normals not bit-identical: {n_diff} of {z.size}")
    assert n_diff < 0.05 * z.size
    jk = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(3))
    jz = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (50, 60)))(jk))
    tzb = prng.normal(prng.fold_in(tk, torch.arange(3)), (50, 60)).numpy()
    assert np.all(np.abs(jz - tzb) <= 1e-6 * np.maximum(1.0, np.abs(jz)))


def test_prngkey_defaults_to_the_card():
    if torch.cuda.is_available():
        assert prng.PRNGKey(0).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prng.PRNGKey(0)
