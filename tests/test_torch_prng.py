"""The port's threefry PRNG (`maelstrom_tpu_torch/prng.py`, the plain
version of kernel K7) against `jax.random` (jax 0.9.0, partitionable
threefry), over several seeds and shapes: a scalar, (7,), (64, 4, 4) and
one of more than 65,536 elements. Tolerance: exact for keys, splits,
fold_in, bits, uniforms and randints; exponential floats within 1 ulp
(the two `log1p`s differ), and their latency rounds equal at means 3 and
10."""

from __future__ import annotations

import hashlib

import jax
import numpy as np
import pytest
import torch

from maelstrom_tpu.net import tpu as JT
from maelstrom_tpu_torch import prng
from maelstrom_tpu_torch.net import tpu as PT

SEEDS = [0, 7, 23, 123_456, 2**31 - 1]
SHAPES = [(), (7,), (64, 4, 4), (70_001,)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_match_jax(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    assert pk.dtype == torch.uint32
    np.testing.assert_array_equal(np.asarray(jk), pk.numpy())
    for n in (2, 4, 5, 7):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, n)),
                                      prng.split(pk, n).numpy())
    # split keys split again, as the round splits its subkeys
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(jax.random.split(jk, 5)[1], 4)),
        prng.split(prng.split(pk, 5)[1], 4).numpy())
    for d in (0, 17, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(jk, d)),
                                      prng.fold_in(pk, d).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_randint_match_jax(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, shape)),
                                  prng.random_bits(pk, shape).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(pk, shape).numpy())
    ranges = ((0, 60), (3, 1000), (-5, 2**31 - 1), (4, 4))
    for lo, hi in ranges[1:2] if len(shape) == 1 and shape[0] > 1000 \
            else ranges:
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, shape, lo, hi)),
            prng.randint(pk, shape, lo, hi).numpy())
    u = prng.uniform(pk, shape)
    p = torch.tensor(0.3, dtype=torch.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape) < 0.3),
        prng.bernoulli_below(pk, shape, p).numpy())
    assert u.dtype == torch.float32 and bool(((u >= 0) & (u < 1)).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_exponential_and_latency_rounds_match_jax(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    je = np.asarray(jax.random.exponential(jk, shape)).reshape(-1)
    pe = prng.exponential(pk, shape).numpy().reshape(-1)
    ulps = np.abs(je.view(np.int32).astype(np.int64)
                  - pe.view(np.int32).astype(np.int64))
    assert ulps.max(initial=0) <= 1
    for dist in ("uniform", "exponential"):
        for mean, scale in ((3.0, 1.0), (10.0, 1.0), (5.0, 2.5))[
                :2 if shape == (70_001,) else 3]:
            cfg = dict(n_nodes=4, latency_mean_rounds=mean,
                       latency_dist=dist)
            ref = JT.draw_latency_rounds(JT.NetConfig(**cfg), jk,
                                         np.float32(scale), shape)
            got = PT.draw_latency_rounds(
                PT.NetConfig(**cfg), pk,
                torch.tensor(scale, dtype=torch.float32), shape)
            np.testing.assert_array_equal(np.asarray(ref), got.numpy())
            assert got.dtype == torch.int32


def test_batched_draws_match_single_draws():
    """`prng.draws` hashes several subkeys' streams in one pass; each
    row equals the single draw from its key."""
    keys = prng.split(prng.PRNGKey(3, "cpu"), 4)
    scale = torch.tensor(1.0)
    p = torch.tensor(0.25)
    specs = [("mask", p), None, ("latency", "exponential", 3.0, scale),
             ("latency", "uniform", 5.0, scale)]
    got = prng.draws(keys, 1000, specs)
    assert got[1] is None
    assert torch.equal(got[0], prng.bernoulli_below(keys[0], (1000,), p))
    for i in (2, 3):
        assert torch.equal(got[i], prng.latency_rounds(keys[i], (1000,),
                                                       *specs[i][1:]))


def test_prng_pins_match_jax():
    """Re-derives chip_smoke.py's PINNED_PRNG (K7 is held against them on
    the card) from jax.random, and holds the port's plain version to
    them."""
    import chip_smoke
    n = chip_smoke.PRNG_PIN_N
    jk, pk = jax.random.PRNGKey(42), prng.PRNGKey(42, "cpu")
    one = torch.ones((), dtype=torch.float32)
    arrays = {
        "bits": (np.asarray(jax.random.bits(jk, (n,))),
                 prng.random_bits(pk, (n,)).numpy()),
        "uniform_rounds": (
            np.asarray(JT.draw_latency_rounds(JT.NetConfig(
                n_nodes=1, latency_mean_rounds=5.0, latency_dist="uniform"),
                jk, np.float32(1.0), (n,))),
            prng.latency_rounds(pk, (n,), "uniform", 5.0, one).numpy()),
        "exponential_rounds": (
            np.asarray(JT.draw_latency_rounds(JT.NetConfig(
                n_nodes=1, latency_mean_rounds=3.0,
                latency_dist="exponential"), jk, np.float32(1.0), (n,))),
            prng.latency_rounds(pk, (n,), "exponential", 3.0,
                                one).numpy())}
    for name, (ref, got) in arrays.items():
        np.testing.assert_array_equal(ref, got)
        a = ref.astype("<u4" if name == "bits" else "<i4")
        digest = hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                ).hexdigest()
        assert digest == chip_smoke.PINNED_PRNG[name], name
