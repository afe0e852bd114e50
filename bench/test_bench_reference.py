"""The plain references agree with the program at smoke geometry on the
CPU, where both add in the same order: every head output and every SA
decision equal; the frozen threefry copy draws the program's dies."""
import argparse
import time

import numpy as np
import pytest
import torch

from benchkit import main, registry, smoke
from reference import threefry as tf

torch.set_num_threads(2)
SPEC = registry.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    parts = smoke.parts(SPEC, cell)
    args = argparse.Namespace(workload=cell, seed=(1 << 33) + 7,
                              seconds=smoke.seconds(parts), trace=0)
    rec = main.run_cell(SPEC, parts, args,
                        torch.device("cpu"), time.perf_counter())
    assert rec["correct"], rec["checks"]
    # the same order of adds on both sides here: not a single element apart
    assert all(c["value"] == 0.0 for c in rec["checks"].values()), \
        rec["checks"]


def test_threefry_copy_draws_the_programs_bits():
    from repro_torch import prng
    key = tf.key((1 << 33) + 5)
    ids = torch.arange(40, dtype=torch.int64)
    assert torch.equal(tf.fold_in(key, ids), prng.fold_in_plain(key, ids))
    k = tf.fold_in(key, 3)
    with prng.threefry_partitionable(True):
        assert torch.equal(tf.split(k, 3), prng.split_plain(k, 3))
        assert torch.equal(tf.words(k, 0, 4096),
                           prng.random_bits_plain(k, (4096,)))
        assert torch.equal(tf.bernoulli_half(k, 0, 4096),
                           prng.bernoulli_plain(k, 0.5, (4096,)))
        z = tf.normal(k, 0, 4096, scale=0.5)
        zp = prng.normal_plain(k, (4096,), scale=0.5)
        ln = tf.lognormal(k, (64, 64), 0.4245)
        lnp = prng.lognormal_plain(k, (64, 64), 0.4245)
        table = ((0.01, 0.1, 0.5, 0.9, 0.99), (0.4, 0.6, 1.0, 1.5, 2.2))
        ms = tf.measured(k, (64, 64), *table)
        msp = prng.measured_plain(k, (64, 64), table)
    # float64 tails rounded once against XLA's float32 erf_inv polynomial,
    # which is off by up to ~1.6e-6 relative in the normal's tails
    for a, b in ((z, zp), (ln, lnp), (ms, msp)):
        assert torch.allclose(a, b, rtol=5e-6, atol=1e-7)


def test_slices_of_a_draw_are_slices_of_its_words():
    k = tf.fold_in(tf.key(11), 2)
    whole = tf.normal(k, 0, 6000)
    assert torch.equal(torch.cat([tf.normal(k, 0, 2500),
                                  tf.normal(k, 2500, 6000)]), whole)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from reference import irc
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265], dtype=torch.float32)
    y = irc.tf32(x)
    assert y[:2].tolist() == [1.0, 1.0 + 2 ** -10]
    assert y[2].item() == 1.0                   # a tie rounds to even
    assert y[3].item() == 1.0 + 2 ** -9
    bits = y.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())
    assert np.isclose(y[4].item(), -3.14159265, rtol=2 ** -10)


def test_the_layer_follows_the_configured_fractions():
    parts = smoke.parts(SPEC, "layer-macro-all")
    parts["config"]["ternary_fractions"] = [0.1, 0.8, 0.1]
    args = argparse.Namespace(workload="layer-macro-all", seed=(1 << 33) + 8,
                              seconds=smoke.seconds(parts), trace=0)
    rec = main.run_cell(SPEC, parts, args,
                        torch.device("cpu"), time.perf_counter())
    assert all(c["value"] == 0.0 for c in rec["checks"].values()), \
        rec["checks"]
