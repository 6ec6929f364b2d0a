"""GPU validation at sizes the CPU mesh cannot afford.

Every test here carries the ``gpu`` marker and the ``gpu`` fixture, which
skips unless the first JAX device is a GPU. Run them on the card with

    SMMC_TEST_ON_DEVICE=1 python -m pytest -m gpu tests/ -q -p no:cacheprovider

(chip_smoke.py runs exactly that, in its own process, after its phases).
"""

import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def _opts(**kw):
    from stock_market_monte_carlo_jax.config import EngineOptions

    kw.setdefault("chunk_paths", 2**21)
    return EngineOptions(**kw)


def _table_moments(table, t):
    g = 1.0 + np.asarray(table, np.float64) / 100.0
    mean_a = 1000.0 * g.mean() ** t
    var_a = 1000.0**2 * ((g * g).mean() ** t - g.mean() ** (2 * t))
    return mean_a, var_a


def test_gaussian_analytic_moments():
    import stock_market_monte_carlo_jax as smmc

    n, t = 2**22, 360
    res = smmc.simulate_stats(smmc.GaussianReturns(), n, t, seed=3,
                              options=_opts())
    mean_a = 1000 * 1.005**t
    m1, s1 = 1.005, 10 / 12 / 100
    std_a = mean_a * np.sqrt(((m1 * m1 + s1 * s1) / (m1 * m1)) ** t - 1)
    # 5 sigma of the sample mean; the std of 2^22 near-lognormal finals
    # carries ~4e-4 relative MC error
    assert abs(res.mean - mean_a) < 5 * std_a / np.sqrt(n)
    assert abs(res.std - std_a) / std_a < 5e-3


def test_historical_matches_table_moments(historical_table):
    import jax.numpy as jnp

    import stock_market_monte_carlo_jax as smmc

    m = smmc.HistoricalBootstrap(jnp.asarray(historical_table))
    n, t = 2**22, 360
    res = smmc.simulate_stats(m, n, t, seed=2, options=_opts())
    mean_a, var_a = _table_moments(historical_table, t)
    assert abs(res.mean - mean_a) < 5 * np.sqrt(var_a / n)


def test_chunk_invariance_gpu():
    """Tile-keyed streams: the draws do not depend on the chunk size. On
    the card the compiled month product's association depends on the chunk
    shape, so per-path finals agree to the float32 rounding of a t-month
    product (t * 2^-24 relative), not bit for bit as on the CPU."""
    import stock_market_monte_carlo_jax as smmc

    n, t = 2**16, 24
    a = smmc.simulate_final_values(
        smmc.GaussianReturns(), n, t, seed=9, options=_opts(chunk_paths=2**14),
    )
    b = smmc.simulate_final_values(
        smmc.GaussianReturns(), n, t, seed=9, options=_opts(chunk_paths=2**16),
    )
    np.testing.assert_allclose(a, b, rtol=t * 2.0**-24, atol=0)


def test_power_sum_extraction_well_conditioned(historical_table):
    """std and kurtosis extracted from the device's centered power sums
    must match float64 statistics of the IDENTICAL finals to <= 1e-5
    (ref contract: the reduceBlock mean/variance pipeline,
    benchmark_mc_gpu_reduceBlock.cpp:7-26)."""
    import jax.numpy as jnp

    import stock_market_monte_carlo_jax as smmc

    n, t = 2**22, 360  # 2 chunks of 2^21
    for model in (smmc.GaussianReturns(),
                  smmc.HistoricalBootstrap(jnp.asarray(historical_table))):
        res = smmc.simulate_stats(model, n, t, seed=13, options=_opts(),
                                  keep_final_values=True)
        f = np.asarray(res.final_values, np.float64)
        mean, std = f.mean(), f.std(ddof=0)
        assert abs(res.mean / mean - 1) < 1e-5, model.kind
        assert abs(res.std / std - 1) < 1e-5, model.kind
        kurt = float(((f - mean) ** 4).mean() / std**4)
        assert abs(res.moments.kurtosis / kurt - 1) < 1e-4, model.kind


def test_gpu_meets_1e3_bar_against_oracle():
    """BASELINE.md's tolerance demonstrated directly: mean/std/quantiles
    within 1e-3 of the independent FFT-convolution oracle
    (ops/analytic.py) at 2^24 paths."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.ops import analytic as an

    n, t = 2**24, 360
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    mean_a, std_a = an.final_value_moments(0.5, 10 / 12, t, 1000.0)
    want_q = an.final_value_quantiles(0.5, 10 / 12, t, 1000.0, qs)
    res = smmc.simulate_stats(smmc.GaussianReturns(), n, t, seed=17,
                              options=_opts(chunk_paths=2**24))
    assert abs(res.mean - mean_a) / mean_a < 1e-3
    assert abs(res.std - std_a) / std_a < 1e-3
    got_map = res.quantiles(qs)
    got = np.asarray([got_map[q] for q in qs])
    np.testing.assert_allclose(got, want_q, rtol=1e-3)


def test_historical_strategy_matches_closed_form(historical_table):
    """Bootstrap draws composed with a fixed-percent withdrawal: under a
    constant keep k the mean final value is v0 (k m1)^T and the mean
    withdrawn total v0 m1 (1-k) ((k m1)^T - 1) / (k m1 - 1), with m1 the
    table's exact mean growth."""
    import jax.numpy as jnp

    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
    )

    m = smmc.HistoricalBootstrap(jnp.asarray(historical_table))
    n, t = 2**22, 120
    res = smmc.simulate_stats(m, n, t, seed=5,
                              strategy=FixedPercentWithdrawal(0.5),
                              options=_opts())
    k = float(np.float32(1.0) - np.float32(0.5) / np.float32(100.0))
    m1 = float((1.0 + np.asarray(historical_table, np.float64) / 100).mean())
    mean_a = 1000.0 * (k * m1) ** t
    assert abs(res.mean - mean_a) < 5 * res.std / np.sqrt(n)
    ewd = 1000.0 * m1 * (1 - k) * ((k * m1) ** t - 1) / (k * m1 - 1)
    # the per-path withdrawn total is a smooth average over months, so its
    # MC error at 2^22 paths is far below 1e-3
    assert abs(res.moments.total_withdrawn / n - ewd) / ewd < 1e-3


def test_terminal_law_parity():
    """Terminal law on the card: one normal draw per path through the
    fitted quantile function must reproduce the FFT oracle's moments and
    quantiles within MC bars, and repeat bit for bit with the same seed."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.ops import analytic

    n, t = 2**22, 360
    g = smmc.GaussianReturns()
    res = smmc.simulate_stats(g, n, t, seed=11,
                              options=_opts(terminal_law=True))
    mean_cf, std_cf = analytic.final_value_moments(
        float(g.mean_pct), float(g.std_pct), t, 1000.0)
    assert abs(res.mean - mean_cf) < 5 * std_cf / np.sqrt(n)
    assert abs(res.std - std_cf) / std_cf < 5e-3
    qs = (0.01, 0.05, 0.5, 0.95, 0.99)
    oq = analytic.final_value_quantiles(
        float(g.mean_pct), float(g.std_pct), t, 1000.0, qs)
    sq = res.quantiles(qs)
    for q, want in zip(qs, oq):
        assert abs(sq[q] / want - 1.0) < 3e-3, (q, sq[q], want)
    res2 = smmc.simulate_stats(g, n, t, seed=11,
                               options=_opts(terminal_law=True))
    np.testing.assert_array_equal(res2.histogram_counts,
                                  res.histogram_counts)


def test_seed_segmentation_law():
    """Segmented terminal-law run: segment 0 reproduces the unsegmented
    prefix, the merged run carries exact counts, and the mean sits within
    MC noise of the exact bootstrap-law mean."""
    import stock_market_monte_carlo_jax as smmc

    hist = smmc.HistoricalBootstrap.from_csv()
    seg = 2 * 2**21
    n = 5 * 2**21 + 12345  # 3 segments, ragged tail
    o = _opts(terminal_law=True, seed_segment_paths=seg)
    r = smmc.simulate_stats(hist, n, 360, seed=7, target_amount=2000.0,
                            options=o)
    assert r.moments.n == n
    assert r.histogram_counts.sum() == n
    r0 = smmc.simulate_stats(hist, seg, 360, seed=7, target_amount=2000.0,
                             options=_opts(terminal_law=True))
    rest = np.asarray(r.histogram_counts) - np.asarray(r0.histogram_counts)
    assert (rest >= 0).all() and rest.sum() == n - seg
    table = np.asarray(hist.returns_pct, np.float64)
    exact_mean = 1000.0 * (1.0 + table.mean() / 100.0) ** 360
    assert abs(r.mean - exact_mean) < 6 * r.std / np.sqrt(n)


def test_hostile_big_table():
    """A 32,749-row heavy-tailed table (near the 2^15 index-map bound):
    mean and second moment must match the closed forms
    E[V_T] = v0 E[g]^T, E[V_T^2] = v0^2 E[g^2]^T within MC tolerance."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.data._synthetic import (
        hostile_monthly_returns,
    )

    table = hostile_monthly_returns(32749)
    model = smmc.HistoricalBootstrap(table)
    n, t = 2**22, 60
    res = smmc.simulate_stats(model, n, t, seed=17, options=_opts())
    mean_a, var_a = _table_moments(table, t)
    assert abs(res.mean - mean_a) < 6 * np.sqrt(var_a / n), (
        res.mean, mean_a)
    # heavy tails: the second moment has a huge MC variance — compare the
    # std loosely (the law-level cross-checks run on the CPU against the
    # FFT oracle, tests/test_hostile_table.py)
    assert abs(res.std - np.sqrt(var_a)) / np.sqrt(var_a) < 0.25
    assert res.histogram_counts.sum() == n
