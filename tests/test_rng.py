"""RNG ports and statistical quality.

The parity references here are independent pure-Python reimplementations of
the published algorithms (xorshift13/17/5, PCG hash, Tausworthe), checked
against the jnp ports — mirroring how the reference validates RNGs only by
eyeballing histograms (examples/visualize_rng.cpp); we assert chi-square
bounds instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stock_market_monte_carlo_jax.ops import rng as r

M32 = 0xFFFFFFFF


def _xorshift_py(y):
    # Liao 2020, as in the reference kernels (src/simulations.cu:70-76)
    y ^= (y << 11) & M32
    y &= M32
    y ^= y >> 7
    y ^= y >> 12
    return y & M32


def _xorshift_gm_py(x):
    x ^= (x << 13) & M32
    x ^= x >> 17
    x ^= (x << 5) & M32
    return x & M32


def _pcg_py(x):
    # rand_pcg hashes its *input* (the LCG advance is dead code because the
    # C++ takes the state by value — src/simulations.cu:62-67)
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return ((word >> 22) ^ word) & M32


def test_xorshift_port_matches_python_reference():
    xs = np.asarray([1, 2, 12345, 0xDEADBEEF, 0x7FFFFFFF], np.uint32)
    got, _ = r.xorshift_step(jnp.asarray(xs))
    want = [_xorshift_py(int(x)) for x in xs]
    np.testing.assert_array_equal(np.asarray(got, np.int64), want)


def test_xorshift_gm_port():
    xs = np.asarray([1, 99, 0xABCDEF01], np.uint32)
    got, _ = r.xorshift_gm_step(jnp.asarray(xs))
    want = [_xorshift_gm_py(int(x)) for x in xs]
    np.testing.assert_array_equal(np.asarray(got, np.int64), want)


def test_xorshf96_is_pure_hash():
    # y/z reset every call in the reference, so equal inputs map to equal
    # outputs (documented quirk)
    a = r.xorshf96(jnp.asarray([7, 7, 123], jnp.uint32))
    assert int(a[0]) == int(a[1])
    x = 123
    x ^= (x << 16) & M32
    x ^= x >> 5
    x ^= (x << 1) & M32
    want = (x ^ 362436069 ^ 521288629) & M32
    assert int(a[2]) == want


def test_hybrid_taus_simple_variants():
    st2 = jnp.asarray([[129, 257]], jnp.uint32)
    new2, u2 = r.hybrid_taus_simple_step(st2)
    assert new2.shape == (1, 2) and 0 <= float(u2[0]) < 1
    new1, u1 = r.hybrid_taus_simplest_step(jnp.asarray([129], jnp.uint32))
    assert 0 <= float(u1[0]) < 1


def test_pcg_hash_port_matches_python_reference():
    xs = np.asarray([0, 1, 2, 999, 0xCAFEBABE], np.uint32)
    got = r.pcg_hash(jnp.asarray(xs))
    want = [_pcg_py(int(x)) for x in xs]
    np.testing.assert_array_equal(np.asarray(got, np.int64), want)


def test_xorshift_stream_reproduces_reference_kernel_recipe():
    # state0 = pcg(tid+1); then xorshift chain (src/simulations.cu:140-146)
    lane = np.uint32(41)
    stream = np.asarray(
        r.xorshift_stream(jnp.asarray([lane + 1]), 5)[0], np.int64
    )
    s = _pcg_py(int(lane) + 1)
    want = []
    for _ in range(5):
        s = _xorshift_py(s)
        want.append(s)
    np.testing.assert_array_equal(stream, want)


def test_hybrid_taus_uniformity():
    n = 1 << 14
    state = jnp.stack(
        [
            r.pcg_hash(jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(k * 7919 + 129))
            for k in range(4)
        ],
        axis=-1,
    )
    # Taus components need state >= 128 to avoid degenerate lock-in
    state = jnp.maximum(state, jnp.uint32(128))
    us = []
    for _ in range(8):
        state, u = r.hybrid_taus_step(state)
        us.append(np.asarray(u))
    u = np.concatenate(us)
    assert u.min() >= 0 and u.max() < 1
    counts, _ = np.histogram(u, bins=64, range=(0, 1))
    expected = u.size / 64
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 63 + 5 * np.sqrt(2 * 63)


def test_xorshift_uniformity_chi2():
    n = 1 << 16
    bits = np.asarray(
        r.xorshift_stream(jnp.arange(1, n + 1, dtype=jnp.uint32), 4)
    )
    u = bits.astype(np.float64) * 2.0**-32
    counts, _ = np.histogram(u, bins=128, range=(0, 1))
    expected = u.size / 128
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 127 + 6 * np.sqrt(2 * 127)


def test_bootstrap_index_mapping_matches_reference():
    # idx = n * (u32 * 2^-32) (src/simulations.cu:148)
    bits = jnp.asarray([0, 1 << 31, M32], jnp.uint32)
    idx = np.asarray(r.bootstrap_index_from_bits(bits, 1127))
    assert idx[0] == 0
    assert idx[1] == 1127 // 2
    assert idx[2] == 1126  # clamped to table size


def test_path_tile_keys_deterministic_and_distinct():
    k = jax.random.key(0)
    a = r.path_tile_keys(k, jnp.uint32(0), 4)
    b = r.path_tile_keys(k, jnp.uint32(2), 4)
    da = jax.random.key_data(a)
    db = jax.random.key_data(b)
    np.testing.assert_array_equal(da[2], db[0])  # overlap at tile 2
    assert not np.array_equal(da[0], da[1])
