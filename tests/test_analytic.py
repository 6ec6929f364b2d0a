"""The FFT-convolution oracle (ops/analytic.py): exact final-value
distribution for the Gaussian market — the independent CPU reference the
1e-3 statistical-parity bar is asserted against."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.ops import analytic as an


def test_oracle_moments_match_closed_form():
    """FFT-grid mean/std must reproduce the closed-form moments to ~1e-6
    over short and long horizons."""
    for t in (1, 12, 360):
        values, cdf = an.final_value_distribution(0.5, 10 / 12, t, 1000.0)
        pmf = np.diff(np.concatenate([[0.0], cdf]))
        mean = float((values * pmf).sum())
        second = float((values**2 * pmf).sum())
        std = np.sqrt(second - mean * mean)
        mean_a, std_a = an.final_value_moments(0.5, 10 / 12, t, 1000.0)
        assert abs(mean - mean_a) / mean_a < 1e-6, t
        assert abs(std - std_a) / std_a < 1e-5, t


def test_power_sum_extraction_well_conditioned():
    """Centered power sums (engine.analytic_moment_shift): std/skew/kurt
    extracted from the packed device sums must match float64 statistics of
    the IDENTICAL final values to ~1e-6 — the uncentered accumulation had
    a 1e-4 std floor (f32 reassociation noise amplified ~40-600x by the
    s2/n - mean^2 cancellation)."""
    from stock_market_monte_carlo_jax.config import EngineOptions
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
    )

    n, t = 8192 * 8, 360  # multi-chunk so cross-chunk merging is covered
    opts = EngineOptions(chunk_paths=8192)
    cases = [
        (smmc.GaussianReturns(), None),
        (smmc.GaussianReturns(), FixedPercentWithdrawal(0.5)),
        (smmc.HistoricalBootstrap.from_csv(), None),
    ]
    for model, strategy in cases:
        kw = {} if strategy is None else {"strategy": strategy}
        res = smmc.simulate_stats(model, n, t, seed=11, options=opts,
                                  keep_final_values=True, **kw)
        f = np.asarray(res.final_values, np.float64)
        mean, std = f.mean(), f.std(ddof=0)
        assert abs(res.mean / mean - 1) < 1e-6
        assert abs(res.std / std - 1) < 1e-6
        skew = float(((f - mean) ** 3).mean() / std**3)
        kurt = float(((f - mean) ** 4).mean() / std**4)
        assert abs(res.moments.skew - skew) < 1e-5 * max(abs(skew), 1.0)
        assert abs(res.moments.kurtosis / kurt - 1) < 1e-5


def test_oracle_t1_is_shifted_normal():
    """One month: V = v0*(1 + r/100), quantiles are exactly normal."""
    import jax.numpy as jnp

    from stock_market_monte_carlo_jax.ops.normal import normal_icdf

    qs = [0.01, 0.25, 0.5, 0.75, 0.99]
    got = an.final_value_quantiles(0.5, 10 / 12, 1, 1000.0, qs)
    z = np.asarray(normal_icdf(jnp.asarray(qs, jnp.float32)), np.float64)
    want = 1000.0 * (1 + (0.5 + 10 / 12 * z) / 100.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_oracle_grid_convergence():
    """Doubling the grid changes 360-month quantiles by < 1e-5 rel —
    the oracle's own error is far below the 1e-3 parity bar."""
    qs = [0.05, 0.5, 0.95]
    a = np.asarray([
        _q(qs, n_grid=1 << 14)
    ]).ravel()
    b = np.asarray([
        _q(qs, n_grid=1 << 15)
    ]).ravel()
    np.testing.assert_allclose(a, b, rtol=3e-5)


def _q(qs, n_grid):
    values, cdf = an.final_value_distribution(0.5, 10 / 12, 360, 1000.0,
                                              n_grid=n_grid)
    logv = np.log(values)
    out = []
    for q in qs:
        j = int(np.searchsorted(cdf, q))
        out.append(np.exp(logv[j]))
    return out


def test_engine_meets_1e3_bar_against_oracle():
    """CPU engine (XLA threefry) at 2^21 paths: mean/std/quantiles within
    1e-3 of the independent oracle (BASELINE.md north-star tolerance).
    The GPU is held to the same bar in tests/test_gpu.py."""
    n, t = 1 << 20, 120
    res = smmc.simulate_stats(smmc.GaussianReturns(), n, t, seed=11)
    mean_a, std_a = an.final_value_moments(0.5, 10 / 12, t, 1000.0)
    assert abs(res.mean - mean_a) / mean_a < 1e-3
    assert abs(res.std - std_a) / std_a < 1.5e-3
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    want = an.final_value_quantiles(0.5, 10 / 12, t, 1000.0, qs)
    got_map = res.quantiles(qs)
    got = np.asarray([got_map[q] for q in qs])
    # MC noise at 2^20 paths; the strict 1e-3 bar runs at 2^24 on the GPU
    # (tests/test_gpu.py::test_gpu_meets_1e3_bar_against_oracle)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_oracle_rejects_depletable_market():
    with pytest.raises(ValueError, match="non-negligible"):
        an.log_growth_pdf_grid(0.0, 20.0)


def test_engine_ks_statistic_vs_oracle_cdf():
    """Kolmogorov-Smirnov: the empirical CDF of engine finals vs the
    oracle's exact CDF. D_n must be inside the 1% critical band
    c(0.01)/sqrt(n) = 1.63/sqrt(n) — a whole-distribution check, stronger
    than moment/quantile spot checks."""
    n, t = 1 << 18, 60
    res = smmc.simulate_stats(smmc.GaussianReturns(), n, t, seed=21,
                              keep_final_values=True)
    finals = np.sort(res.final_values.astype(np.float64))
    values, cdf = an.final_value_distribution(0.5, 10 / 12, t, 1000.0)
    # oracle CDF evaluated at each sorted final (right-continuous step)
    pos = np.searchsorted(values, finals, side="right") - 1
    pos = np.clip(pos, 0, len(cdf) - 1)
    f_oracle = cdf[pos]
    ecdf_hi = np.arange(1, n + 1) / n
    ecdf_lo = np.arange(0, n) / n
    d = max(np.max(np.abs(ecdf_hi - f_oracle)),
            np.max(np.abs(f_oracle - ecdf_lo)))
    crit = 1.63 / np.sqrt(n)   # alpha = 0.01
    assert d < crit, (d, crit)
