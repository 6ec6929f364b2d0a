"""Sharding invariance: same seed => same results on 1 vs 8 devices.

The reference cannot make this promise (per-thread clock/random_device
seeding, src/simulations.cpp:45,100; per-tid PCG on GPU). Counter-based
keying by global path position makes it hold here exactly for final values
and to reduction-order rounding for the merged statistics.
"""

import jax.numpy as jnp
import numpy as np

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE

GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)
OPTS = EngineOptions(chunk_paths=KEY_TILE)


def test_final_values_identical_1_vs_8_devices(mesh8):
    n, t = 8 * KEY_TILE, 24
    single = smmc.simulate_final_values(GAUSS, n, t, seed=6, options=OPTS)
    sharded = smmc.simulate_final_values(
        GAUSS, n, t, seed=6, options=OPTS, mesh=mesh8
    )
    np.testing.assert_array_equal(single, sharded)


def test_stats_match_1_vs_8_devices(mesh8):
    n, t = 8 * KEY_TILE, 36
    a = smmc.simulate_stats(GAUSS, n, t, seed=6, options=OPTS,
                            target_amount=5000.0)
    b = smmc.simulate_stats(GAUSS, n, t, seed=6, options=OPTS, mesh=mesh8,
                            target_amount=5000.0)
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-6)
    # centered power sums: the psum reduction-order jitter no longer
    # gets amplified by the s2/n - mean^2 cancellation
    np.testing.assert_allclose(a.std, b.std, rtol=1e-6)
    assert a.moments.min == b.moments.min
    assert a.moments.max == b.moments.max
    assert a.count_below == b.count_below
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)


def test_sharded_ragged_count(mesh8):
    n, t = 8 * KEY_TILE + 777, 12
    a = smmc.simulate_stats(GAUSS, n, t, seed=1, options=OPTS)
    b = smmc.simulate_stats(GAUSS, n, t, seed=1, options=OPTS, mesh=mesh8)
    assert b.moments.n == n
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-6)
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)


def test_sharded_final_values_ragged(mesh8):
    n, t = 2 * KEY_TILE + 999, 12
    single = smmc.simulate_final_values(GAUSS, n, t, seed=2, options=OPTS)
    sharded = smmc.simulate_final_values(
        GAUSS, n, t, seed=2, options=OPTS, mesh=mesh8
    )
    assert sharded.shape == (n,)
    np.testing.assert_array_equal(single, sharded)


def test_historical_sharded(mesh8, historical_table):
    m = smmc.HistoricalBootstrap(jnp.asarray(historical_table))
    n, t = 8 * KEY_TILE, 24
    a = smmc.simulate_stats(m, n, t, seed=3, options=OPTS)
    b = smmc.simulate_stats(m, n, t, seed=3, options=OPTS, mesh=mesh8)
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-6)


def test_stats_only_sharded_matches_single(mesh8):
    """histogram=False over a mesh: the psum of zero histograms must not
    disturb the merged moments, and they must equal the single-device
    stats-only run exactly."""
    n, t = 8 * KEY_TILE, 24
    opts = EngineOptions(chunk_paths=KEY_TILE, histogram=False)
    single = smmc.simulate_stats(GAUSS, n, t, seed=9, target_amount=900.0,
                                 options=opts)
    sharded = smmc.simulate_stats(GAUSS, n, t, seed=9, target_amount=900.0,
                                  options=opts, mesh=mesh8)
    assert sharded.histogram_counts is None
    # psum reduction order differs from the host merge: bit-equality holds
    # for finals (see above); centered power sums keep the std extraction
    # well-conditioned against the f32 psum's reassociation jitter
    np.testing.assert_allclose(sharded.mean, single.mean, rtol=1e-6)
    assert sharded.moments.count_below == single.moments.count_below
    np.testing.assert_allclose(sharded.std, single.std, rtol=1e-6)
