"""RNG: Threefry correctness and protocol layout."""

import numpy as np
import jax.numpy as jnp

from ndtpso_slam.ops import rng
from oracle import threefry2x32_np, uniform_pairs_np


def test_threefry_matches_numpy_oracle():
    key = (np.uint32(0xDEADBEEF), np.uint32(0x12345678))
    ctr = np.arange(64, dtype=np.uint32)
    jx0, jx1 = rng.threefry2x32(key, ctr, np.zeros_like(ctr))
    nx0, nx1 = threefry2x32_np(key, ctr, np.zeros_like(ctr))
    np.testing.assert_array_equal(np.asarray(jx0), nx0)
    np.testing.assert_array_equal(np.asarray(jx1), nx1)


def test_threefry_matches_jax_reference_prng():
    # Independent check against jax's own threefry2x32 (also 20 rounds).
    from jax._src import prng as jax_prng

    key = jnp.array([42, 99], dtype=jnp.uint32)
    c0 = np.arange(8, dtype=np.uint32)
    c1 = np.arange(100, 108, dtype=np.uint32)
    ours = rng.threefry2x32((key[0], key[1]), c0, c1)
    theirs = jax_prng.threefry_2x32(key, jnp.concatenate([c0, c1]))
    np.testing.assert_array_equal(np.asarray(ours[0]), np.asarray(theirs[:8]))
    np.testing.assert_array_equal(np.asarray(ours[1]), np.asarray(theirs[8:]))


def test_uniform_range_and_determinism():
    key = (np.uint32(7), np.uint32(13))
    u0, u1 = rng.uniform_pairs(key, np.arange(10000, dtype=np.uint32))
    u0, u1 = np.asarray(u0), np.asarray(u1)
    assert u0.min() >= 0.0 and u0.max() < 1.0
    assert 0.45 < u0.mean() < 0.55
    assert 0.45 < u1.mean() < 0.55
    v0, _ = rng.uniform_pairs(key, np.arange(10000, dtype=np.uint32))
    np.testing.assert_array_equal(u0, np.asarray(v0))
    n0, n1 = uniform_pairs_np(key, np.arange(10000, dtype=np.uint32))
    np.testing.assert_allclose(u0, n0.astype(np.float32), rtol=0, atol=0)


def test_protocol_layout_disjoint():
    g, p = rng.pso_init_pairs(30)
    it0 = np.asarray(rng.pso_iter_pairs(0, 30))
    it1 = np.asarray(rng.pso_iter_pairs(1, 30))
    all_ctrs = np.concatenate([g.ravel(), p.ravel(), it0.ravel(), it1.ravel()])
    assert len(np.unique(all_ctrs)) == all_ctrs.size  # no counter reuse
    assert it1.min() == it0.max() + 1
