"""The die sampling's float tails on their whole input domain.

Every draw but raw bits reads only a word's top 23 bits, so each tail has
2^23 inputs.  `prng.tail_plain` (the port's plain tails, which the card's
kernel is held against bit for bit) is held here, on all of them, against
a jitted jnp transcription of `jax.random`'s uniform and normal tails, of
the device-variation mask `jnp.exp(sigma * normal)`
(`src/repro/core/nonideal.py:64-65`) and of the measured backend's mask
`jnp.interp(norm.cdf(normal), xp, fp)` (`src/repro/device/measured.py:98-
100`); the transcription is tied to JAX itself on the bits of real keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import nonideal  # noqa: E402
from repro.device import MeasuredDeviceModel  # noqa: E402
from repro_torch import prng  # noqa: E402

torch.set_num_threads(2)

SIGMA = 0.4245
N_MANT = 1 << 23


def _uniform_tail(bits, minval, maxval):
    """`jax.random._uniform` from its 32-bit words on (float32)."""
    minval = lax.convert_element_type(minval, jnp.float32)
    maxval = lax.convert_element_type(maxval, jnp.float32)
    float_bits = lax.shift_right_logical(bits, jnp.array(32 - 23,
                                                         jnp.uint32))
    float_bits = lax.bitwise_or(float_bits, jnp.asarray(
        np.array(1.0, np.float32).view(np.uint32), dtype=jnp.uint32))
    floats = lax.bitcast_convert_type(float_bits, jnp.float32) - jnp.array(
        1.0, jnp.float32)
    return lax.max(minval, floats * (maxval - minval) + minval)


def _normal_tail(bits):
    """`jax.random._normal_real` from its words on."""
    lo = np.nextafter(np.array(-1.0, np.float32), np.array(0.0, np.float32),
                      dtype=np.float32)
    u = _uniform_tail(bits, lo, np.array(1.0, np.float32))
    return lax.mul(np.array(np.sqrt(2), np.float32), lax.erf_inv(u))


def _bernoulli_tail(p):
    return lambda bits: (_uniform_tail(bits, 0.0, 1.0)
                         < jnp.float32(p)).astype(jnp.float32)


MEASURED = MeasuredDeviceModel.from_file()


def _measured_tail(bits):
    """`MeasuredDeviceModel.variation_mask` from its words on."""
    return MEASURED.variation_factor(
        jax.scipy.stats.norm.cdf(_normal_tail(bits))).astype(jnp.float32)


# (id, tail, tail_plain arguments, transcription of words, jax on a key)
CASES = [
    ("normal", "normal", dict(scale=1.0), _normal_tail,
     lambda k, s: jax.random.normal(k, s)),
    ("normal_sigma", "normal", dict(scale=SIGMA),
     lambda b: SIGMA * _normal_tail(b),
     lambda k, s: SIGMA * jax.random.normal(k, s)),
    ("lognormal_mask", "lognormal", dict(scale=SIGMA),
     lambda b: jnp.exp(SIGMA * _normal_tail(b)),
     lambda k, s: nonideal.sample_variation_mask(k, s, SIGMA)),
    ("uniform", "uniform", dict(minval=-0.3, maxval=2.5),
     lambda b: _uniform_tail(b, -0.3, 2.5),
     lambda k, s: jax.random.uniform(k, s, jnp.float32, -0.3, 2.5)),
    ("bernoulli_0.5", "bernoulli", dict(p=0.5), _bernoulli_tail(0.5),
     lambda k, s: jax.random.bernoulli(k, 0.5, s).astype(jnp.float32)),
    ("bernoulli_0.3", "bernoulli", dict(p=0.3), _bernoulli_tail(0.3),
     lambda k, s: jax.random.bernoulli(k, 0.3, s).astype(jnp.float32)),
    ("measured_mask", "measured",
     dict(table=(MEASURED.var_q, MEASURED.var_factor)), _measured_tail,
     lambda k, s: MEASURED.variation_mask(k, s)),
]
# bernoulli at p on and around the edges of its integer threshold
EDGE_P = [0.0, 1.0, 1 - 2**-24, 2**-23, 2**-24, 0.75]


def _differ(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    return int(np.sum(got.view(np.uint32) != want.view(np.uint32)))


def _all_words():
    """Every 23-bit mantissa k as the word k << 9."""
    return np.arange(N_MANT, dtype=np.uint32) << np.uint32(9)


def _tail_plain(words, tail, kw):
    """`prng.tail_plain` on numpy words, in four slices."""
    parts = [prng.tail_plain(torch.from_numpy(w.astype(np.int64)), tail,
                             **kw) for w in np.array_split(words, 4)]
    return torch.cat(parts).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_transcription_is_jax_random(case):
    """The transcription of a tail, on `jax.random.bits` of real keys,
    gives what `jax.random` draws from the same keys (each under one
    jit, both threefry schemes)."""
    _, _, _, on_words, on_key = case
    shape = (3, 4096)
    for flag in (True, False):
        with jax.threefry_partitionable(flag):
            for seed in (0, 2024):
                key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
                bits = jax.jit(lambda k: jax.random.bits(k, shape))(key)
                assert bits.dtype == jnp.uint32
                want = jax.jit(lambda k: on_key(k, shape))(key)
                assert _differ(jax.jit(on_words)(bits), want) == 0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tail_plain_is_jax_on_every_input(case):
    """`prng.tail_plain` on all 2^23 inputs of the tail, bit for bit."""
    _, tail, kw, on_words, _ = case
    words = _all_words()
    want = jax.jit(on_words)(words)
    n = _differ(_tail_plain(words, tail, kw), want)
    assert n == 0, f"{n} of 2^23 inputs differ"


@pytest.mark.parametrize("p", EDGE_P)
def test_bernoulli_tail_at_edges_of_p(p):
    words = _all_words()
    want = jax.jit(_bernoulli_tail(p))(words)
    assert _differ(_tail_plain(words, "bernoulli", dict(p=p)), want) == 0


def test_tails_ignore_the_low_nine_bits():
    """The word's low 9 bits never reach a float tail."""
    rng = np.random.default_rng(20)
    k = rng.integers(0, N_MANT, 50_000, dtype=np.uint32)
    low = rng.integers(1, 512, k.size, dtype=np.uint32)
    for _, tail, kw, _, _ in CASES:
        a = _tail_plain(k << np.uint32(9), tail, kw)
        b = _tail_plain((k << np.uint32(9)) | low, tail, kw)
        assert _differ(a, b) == 0, tail


def test_plain_draws_are_tails_of_the_bits():
    """Each `*_plain` draw is `tail_plain` of `random_bits_plain`."""
    key = prng.fold_in(prng.PRNGKey(5, device="cpu"), torch.arange(3))
    shape = (7, 5)
    table = (MEASURED.var_q, MEASURED.var_factor)
    bits = prng.random_bits_plain(key, shape)
    pairs = [(prng.uniform_plain(key, shape, -0.3, 2.5),
              prng.tail_plain(bits, "uniform", minval=-0.3, maxval=2.5)),
             (prng.normal_plain(key, shape, 0.7),
              prng.tail_plain(bits, "normal", scale=0.7)),
             (prng.lognormal_plain(key, shape, SIGMA),
              prng.tail_plain(bits, "lognormal", scale=SIGMA)),
             (prng.bernoulli_plain(key, 0.3, shape),
              prng.tail_plain(bits, "bernoulli", p=0.3)),
             (prng.measured_plain(key, shape, table),
              prng.tail_plain(bits, "measured", table=table))]
    for got, want in pairs:
        assert _differ(got.numpy(), want.numpy()) == 0
    assert torch.equal(prng.tail_plain(bits, "bits"), bits)
    with pytest.raises(ValueError, match="unknown draw"):
        prng.tail_plain(bits, "poisson")
    with pytest.raises(ValueError, match="table"):
        prng.tail_plain(bits, "measured")
    with pytest.raises(ValueError, match="2 to 32"):
        prng.tail_plain(bits, "measured", table=([0.5], [1.0]))
    with pytest.raises(ValueError, match="2 to 32"):
        prng.tail_plain(bits, "measured", table=([0.1, 0.5], [1.0]))


def test_measured_tail_takes_any_table():
    """Another table of the most points the kernel holds (32), with a
    repeated quantile (an interval of width 0) and factors below 0: the
    tail is still the jnp transcription on every input."""
    xp = np.concatenate([np.linspace(0.0005, 0.4, 15), [0.4],
                         np.linspace(0.45, 0.9995, 16)]).astype(np.float32)
    fp = (np.cumsum(np.random.default_rng(3).random(32)) - 3.0).astype(
        np.float32)
    words = _all_words()[::8]
    want = jax.jit(lambda b: jnp.interp(jax.scipy.stats.norm.cdf(
        _normal_tail(b)), xp, fp))(words)
    got = _tail_plain(words, "measured", dict(table=(xp, fp)))
    assert _differ(got, want) == 0


def _smoke_tables():
    """{name: (xp, fp) float32} of every table `chip_smoke.py` holds the
    card's measured tail on: the packaged one and `MEASURED_TABLES`."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_smoke_loader import chip_smoke
    tables = {"packaged": (MEASURED.var_q, MEASURED.var_factor),
              **chip_smoke().MEASURED_TABLES}
    return {name: tuple(np.float32(t) for t in prng.check_table(table))
            for name, table in tables.items()}


TABLE_NAMES = ("packaged", "two points", "32 points", "float32 ties",
               "ends inside")


def _words_near(xp, u_of, per_side=4):
    """Words whose u (monotone in the word's 23 bits) lies nearest each
    quantile, `per_side` on each side: a search over every 256th word, then
    over every word of the bracket."""
    coarse = np.arange(0, N_MANT, 256, dtype=np.uint32)
    u = u_of(coarse << np.uint32(9))
    lo = np.clip(np.searchsorted(u, xp) - 1, 0, coarse.size - 1)
    fine = (coarse[lo][:, None] + np.arange(512, dtype=np.uint32)).clip(
        0, N_MANT - 1)
    uf = u_of(fine.ravel() << np.uint32(9)).reshape(fine.shape)
    at = np.array([np.searchsorted(r, q) for r, q in zip(uf, xp)])
    cols = (at[:, None] + np.arange(-per_side, per_side)).clip(0, 511)
    return np.take_along_axis(fine, cols, 1).ravel() << np.uint32(9)


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_measured_tail_on_each_table(name):
    """`prng.tail_plain`'s measured tail on each table the card's kernel is
    held on (`chip_smoke.MEASURED_TABLES`: 2 and 32 points, quantiles equal
    in float32, ends inside the range of u), against jitted
    `jnp.interp(norm.cdf(normal), xp, fp)`: on sampled words, the extreme
    words, and the words whose u lies nearest each quantile."""
    xp, fp = _smoke_tables()[name]
    u_of = jax.jit(lambda b: jax.scipy.stats.norm.cdf(_normal_tail(b)))
    r = np.random.default_rng(27)
    words = np.concatenate([
        r.integers(0, N_MANT, 1 << 16, dtype=np.uint32) << np.uint32(9),
        np.uint32([0, 1 << 9, (N_MANT - 1) << 9, (N_MANT - 2) << 9]),
        _words_near(xp, lambda w: np.asarray(u_of(w)))])
    want = jax.jit(lambda b: jnp.interp(jax.scipy.stats.norm.cdf(
        _normal_tail(b)), xp, fp))(words)
    got = _tail_plain(words, "measured", dict(table=(xp, fp)))
    assert _differ(got, want) == 0


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_interp_on_each_table(name):
    """`xla_order.interp` over each of those tables against jitted
    `jnp.interp`: on every quantile and its two float32 neighbours on
    each side, u sampled in [0, 1] and beyond, and the ends of [0, 1]."""
    from repro_torch import xla_order as xo
    xp, fp = _smoke_tables()[name]
    near = [xp]
    for direction in (np.float32(-np.inf), np.float32(np.inf)):
        v = xp
        for _ in range(2):
            v = np.nextafter(v, direction)
            near.append(v)
    r = np.random.default_rng(28)
    x = np.concatenate(near + [r.random(50_000), r.uniform(-1, 2, 5_000),
                               [0.0, -0.0, 1.0, 1e-30]]).astype(np.float32)
    got = xo.interp(*map(torch.from_numpy, (x, xp, fp)))
    assert _differ(got.numpy(), jax.jit(jnp.interp)(x, xp, fp)) == 0


@pytest.mark.parametrize("table", [
    ((0.5, 0.1, 0.9), (1.0, 2.0, 3.0)),
    ((0.1, float("nan"), 0.9), (1.0, 2.0, 3.0)),
    ((0.1, 0.5), (1.0, float("inf"))),
    ((-3e38, 3e38), (1.0, 2.0)),
    ((0.1, 0.5), (-3e38, 3e38))],
    ids=["decreasing", "nan", "infinite", "x step overflows",
         "f step overflows"])
def test_check_table_refuses_tables_outside_interp_terms(table):
    """Tables on which `jnp.interp` has no defined or finite answer: the
    measured tail refuses them before any draw."""
    with pytest.raises(ValueError, match="do not decrease"):
        prng.check_table(table)
