"""Bit parity of the port's threefry PRNG (`repro_torch.prng`) with
`jax.random`, under both threefry schemes.

Key words, raw bits, uniforms and bernoulli draws must be bit-identical, so
that chip c of the port is the same die as chip c of the JAX package.
Normals go through XLA's float32 `erf_inv`: they must agree within
1e-6 * max(1, |z|), and the test counts those that are not bit-identical
(0 today).  Every parity test runs once per scheme, JAX set with
`jax.threefry_partitionable(flag)` and the port with its own context
manager; the original scheme (jax 0.4.x's default) pads odd draws and lays
out `split`'s counters differently, so it has cases of its own.  (On the
CPU every draw takes the plain int64 path: `tests/test_torch_threefry.py`.)"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_scheme(request):
    """Both packages on one threefry scheme for the test."""
    with jax.threefry_partitionable(request.param), \
            prng.threefry_partitionable(request.param):
        yield request.param


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _tkey(seed):
    return prng.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_key_words_match(threefry_scheme, seed):
    k, tk = jax.random.PRNGKey(seed), _tkey(seed)
    assert np.array_equal(_words(k), tk.numpy())
    for d in (0, 1, 7, 123456, 2**32 - 1):
        assert np.array_equal(_words(jax.random.fold_in(k, d)),
                              prng.fold_in(tk, d).numpy())
    for num in (1, 2, 3, 5):
        assert np.array_equal(_words(jax.random.split(k, num)),
                              prng.split(tk, num).numpy())


def test_vmapped_chip_ids_and_detector_lattice(threefry_scheme):
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


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (3, 5), (2, 3, 4),
                                   (128, 60)])
def test_bits_uniform_bernoulli_exact(threefry_scheme, shape):
    """Odd and even word counts, and one word: the original scheme pads an
    odd count with one counter."""
    k = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    tk = prng.fold_in(_tkey(3), 9)
    assert np.array_equal(np.asarray(jax.random.bits(k, shape)).astype(
        np.int64), prng.random_bits(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(k, shape)),
                          prng.uniform(tk, shape).numpy())
    assert np.array_equal(
        np.asarray(jax.random.uniform(k, shape, minval=-0.3, maxval=2.5)),
        prng.uniform(tk, shape, -0.3, 2.5).numpy())
    got = prng.bernoulli(tk, 0.5, shape)
    assert got.dtype == torch.float32
    assert np.array_equal(np.asarray(jax.random.bernoulli(k, 0.5, shape)),
                          got.numpy())


@pytest.mark.parametrize("n_keys", [1, 4])
def test_batched_keys_match_vmap(threefry_scheme, n_keys):
    k, tk = jax.random.PRNGKey(5), _tkey(5)
    jk = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(n_keys))
    tks = prng.fold_in(tk, torch.arange(n_keys))
    jb = jax.vmap(lambda kk: jax.random.bernoulli(kk, 0.5, (6, 7)))(jk)
    assert np.array_equal(np.asarray(jb), prng.bernoulli(tks, 0.5, (6, 7))
                          .numpy())
    ju = jax.vmap(lambda kk: jax.random.uniform(kk, (9,)))(jk)
    assert np.array_equal(np.asarray(ju), prng.uniform(tks, (9,)).numpy())
    jbits = jax.vmap(lambda kk: jax.random.bits(kk, (5, 3)))(jk)
    assert np.array_equal(np.asarray(jbits).astype(np.int64),
                          prng.random_bits(tks, (5, 3)).numpy())


def test_normals_within_tolerance_and_report_mismatches(threefry_scheme):
    k, tk = jax.random.PRNGKey(17), _tkey(17)
    z = np.asarray(jax.random.normal(k, (200_001,)))
    tz = prng.normal(tk, (200_001,)).numpy()
    err = np.abs(z - tz)
    assert np.all(err <= 1e-6 * np.maximum(1.0, np.abs(z)))
    n_diff = int(np.sum(z != tz))
    print(f"normals not bit-identical: {n_diff} of {z.size}")
    assert n_diff == 0      # XLA CPU's log1p and a correctly rounded sqrt
    jk = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(3))
    jz = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (50, 60)))(jk))
    tzb = prng.normal(prng.fold_in(tk, torch.arange(3)), (50, 60)).numpy()
    np.testing.assert_array_equal(tzb, jz)


def test_lognormal_is_the_jitted_variation_mask(threefry_scheme):
    """`lognormal(key, shape, sigma)` is the reference's jitted
    exp(sigma * normal): sigma folded into the normal's sqrt(2)."""
    from repro.core import nonideal as jni
    k = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    tk = prng.fold_in(_tkey(4), 2)
    want = np.asarray(jax.jit(lambda kk: jni.sample_variation_mask(
        kk, (33, 7), 0.4245))(k))
    got = prng.lognormal(tk, (33, 7), 0.4245).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_draw_checks_and_empty_draws():
    tk = _tkey(1)
    with pytest.raises(ValueError, match="int64 tensor"):
        prng.split(tk.int())
    with pytest.raises(ValueError, match="unknown draw"):
        ops.threefry_draw(tk, (3,), "gamma")
    with pytest.raises(NotImplementedError, match="words under one key"):
        prng.check_words(2**32)
    with prng.threefry_partitionable(False):
        with pytest.raises(NotImplementedError):
            prng.check_words(2**32 - 1)
    assert prng.uniform(tk, (0, 3)).shape == (0, 3)


def test_scheme_setting_default_context_and_restore():
    """Default True (jax >= 0.5's default) unless the environment says
    otherwise; the context manager restores the earlier setting, also
    after an exception; `set_threefry_partitionable` sets it for good."""
    env = os.environ.get(prng.SCHEME_ENV)
    assert prng.is_partitionable() == (env is None or prng._env_flag())
    before = prng.is_partitionable()
    with prng.threefry_partitionable(not before):
        assert prng.is_partitionable() is (not before)
        with prng.threefry_partitionable(before):
            assert prng.is_partitionable() is before
        assert prng.is_partitionable() is (not before)
    assert prng.is_partitionable() is before
    with pytest.raises(KeyError):
        with prng.threefry_partitionable(not before):
            raise KeyError("inside")
    assert prng.is_partitionable() is before
    try:
        prng.set_threefry_partitionable(False)
        assert not prng.is_partitionable()
        prng.set_threefry_partitionable(True)
        assert prng.is_partitionable()
    finally:
        prng.set_threefry_partitionable(before)


@pytest.mark.parametrize("value, want", [("0", False), ("false", False),
                                         ("Off", False), ("1", True),
                                         ("yes", True), ("t", True)])
def test_scheme_from_the_environment(monkeypatch, value, want):
    monkeypatch.setenv(prng.SCHEME_ENV, value)
    assert prng._env_flag() is want
    monkeypatch.delenv(prng.SCHEME_ENV)
    assert prng._env_flag() is True
    monkeypatch.setenv(prng.SCHEME_ENV, "maybe")
    with pytest.raises(ValueError, match="invalid truth value"):
        prng._env_flag()


def test_environment_sets_the_scheme_at_import():
    """One environment puts both packages on one scheme: a fresh process
    with the variable off starts on the original scheme."""
    code = ("import jax; from repro_torch import prng; "
            "print(prng.is_partitionable(), "
            "jax.config.jax_threefry_partitionable)")
    env = dict(os.environ, JAX_THREEFRY_PARTITIONABLE="0",
               PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["False", "False"]


def test_prngkey_defaults_to_the_card():
    if torch.cuda.is_available():
        assert prng.PRNGKey(0).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prng.PRNGKey(0)
