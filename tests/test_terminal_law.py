"""Terminal-law sampler (EngineOptions(terminal_law=True)).

The fit is validated against the deterministic FFT oracles
(ops/analytic.py) on the host; engine statistics are validated at full
fidelity (tile-keyed threefry normals).

Reference: no analog — the reference benchmarks only month-loop kernels
(README.md:66-75); this is the framework's algorithmic upgrade
(ops/terminal_law.py module docstring)."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine import engine as eng
from stock_market_monte_carlo_jax.models.strategies import (
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
)
from stock_market_monte_carlo_jax.ops import analytic
from stock_market_monte_carlo_jax.ops import terminal_law as tlaw

GAUSS = smmc.GaussianReturns()
LAW = EngineOptions(terminal_law=True)


# ---------------------------------------------------------------------------
# Host fit vs the FFT oracles.
# ---------------------------------------------------------------------------


def test_fit_matches_oracle_quantiles():
    """The float32 kernel replica of the fitted quantile function must
    track the FFT oracle to ~1e-6 in log space across the full reachable
    z range — including |z| ~ 5 (p ~ 3e-7), far past any histogram."""
    fit = tlaw.fit_terminal_law(GAUSS, smmc.NoWithdrawal(), 360, 1000.0)
    assert fit.max_err < 2e-5
    assert 1 <= fit.degree < tlaw.LAW_D
    values, cdf = analytic.final_value_distribution(
        float(GAUSS.mean_pct), float(GAUSS.std_pct), 360, 1000.0
    )
    for p in (1e-6, 1e-4, 0.01, 0.5, 0.99, 1 - 1e-4):
        z = float(tlaw.norm_icdf64(p))
        got = fit.scale * np.exp(float(tlaw.clenshaw_f32(
            fit.coefs, np.float32(z / tlaw.LAW_ZMAX)
        )))
        want = analytic.quantiles_from_cdf(values, cdf, [p])[0]
        assert abs(got / want - 1.0) < 5e-5, (p, got, want)


def test_fit_historical_and_rejections():
    h = smmc.HistoricalBootstrap.from_csv()
    fit = tlaw.fit_terminal_law(h, smmc.NoWithdrawal(), 240, 1000.0)
    assert fit.max_err < 2e-5
    # a 1-month bootstrap law is a step function: must refuse, not
    # silently return a smoothed fake
    with pytest.raises(ValueError, match="not .*smooth|step function"):
        tlaw.fit_terminal_law(h, smmc.NoWithdrawal(), 1, 1000.0)
    # 100% withdrawal: every final exactly 0, no law to fit
    with pytest.raises(ValueError, match="keep"):
        tlaw.fit_terminal_law(
            GAUSS, FixedPercentWithdrawal(100.0), 12, 1000.0
        )


def test_fit_cache_and_strategy_shift():
    """Keep-fraction schedules shift the law by a constant in log space:
    the fitted quantile function must equal the no-strategy one scaled by
    prod(keep)."""
    f0 = tlaw.fit_terminal_law(GAUSS, smmc.NoWithdrawal(), 120, 1000.0)
    assert tlaw.fit_terminal_law(
        GAUSS, smmc.NoWithdrawal(), 120, 1000.0
    ) is f0  # cached
    fs = tlaw.fit_terminal_law(
        GAUSS, FixedPercentWithdrawal(0.25), 120, 1000.0
    )
    keep_prod = (1.0 - 0.25 / 100.0) ** 120
    # the two fits run independent lstsq solves; ~1e-7 relative noise
    assert fs.scale / f0.scale == pytest.approx(keep_prod, rel=1e-5)
    np.testing.assert_allclose(fs.coefs, f0.coefs, atol=2e-6)


# ---------------------------------------------------------------------------
# Engine statistics (XLA backend: full-fidelity draws on CPU).
# ---------------------------------------------------------------------------


def test_law_stats_match_closed_form():
    n, t = 1 << 20, 360
    res = smmc.simulate_stats(GAUSS, n, t, seed=3, target_amount=3000.0,
                              options=LAW)
    m = res.moments
    mean_cf, std_cf = analytic.final_value_moments(
        float(GAUSS.mean_pct), float(GAUSS.std_pct), t, 1000.0
    )
    # MC noise: se(mean) = std/sqrt(n) ~ 0.93; 5 sigma bars
    assert abs(m.mean - mean_cf) < 5 * std_cf / np.sqrt(n)
    assert abs(m.std / std_cf - 1.0) < 5 / np.sqrt(2 * n) + 1e-4
    # quantiles vs the oracle law (histogram resolution ~ bin width)
    qs = (0.01, 0.05, 0.5, 0.95, 0.99)
    oq = analytic.final_value_quantiles(
        float(GAUSS.mean_pct), float(GAUSS.std_pct), t, 1000.0, qs
    )
    sq = np.array([res.quantiles(qs)[q] for q in qs])
    np.testing.assert_allclose(sq, oq, rtol=5e-3)
    # count-below is an exact CDF evaluation of the same law
    values, cdf = analytic.final_value_distribution(
        float(GAUSS.mean_pct), float(GAUSS.std_pct), t, 1000.0
    )
    p_below = float(np.interp(np.log(3000.0), np.log(values), cdf))
    se = np.sqrt(p_below * (1 - p_below) / n)
    assert abs(m.count_below / n - p_below) < 5 * se + 1e-6


def test_law_historical_matches_bootstrap_law():
    h = smmc.HistoricalBootstrap.from_csv()
    n, t = 1 << 20, 240
    res = smmc.simulate_stats(h, n, t, seed=7, options=LAW)
    values, cdf = analytic.bootstrap_final_value_distribution(
        np.asarray(h.returns_pct, np.float64), t, 1000.0
    )
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    mean_o = float(np.sum(pmf * values))
    std_o = float(np.sqrt(np.sum(pmf * values**2) - mean_o**2))
    assert abs(res.moments.mean - mean_o) < 5 * std_o / np.sqrt(n)
    qs = (0.05, 0.5, 0.95)
    oq = analytic.quantiles_from_cdf(values, cdf, qs)
    sq = np.array([res.quantiles(qs)[q] for q in qs])
    np.testing.assert_allclose(sq, oq, rtol=5e-3)


def test_law_strategy_finals_match_month_loop():
    """Multiplicative strategy via the terminal law vs the month-loop
    engine: same law, independent draws — agree within MC bars."""
    n, t = 1 << 19, 240
    strat = FixedPercentWithdrawal(0.25)
    nw = EngineOptions(terminal_law=True, track_withdrawn=False)
    a = smmc.simulate_stats(GAUSS, n, t, seed=1, strategy=strat,
                            options=nw)
    b = smmc.simulate_stats(GAUSS, n, t, seed=2, strategy=strat,
                            options=EngineOptions(track_withdrawn=False))
    se = a.moments.std / np.sqrt(n)
    assert abs(a.moments.mean - b.moments.mean) < 6 * se
    assert abs(a.moments.std / b.moments.std - 1.0) < 0.02
    assert a.moments.total_withdrawn == 0.0


def test_law_chunk_and_mesh_invariance(mesh8):
    """Same contract as the month-loop engines: per-path finals identical
    across chunk sizes; sharded stats identical to single-device."""
    n, t = 3 * eng.KEY_TILE + 777, 120
    fa = smmc.simulate_final_values(
        GAUSS, n, t, seed=5,
        options=EngineOptions(terminal_law=True,
                              chunk_paths=eng.KEY_TILE))
    fb = smmc.simulate_final_values(
        GAUSS, n, t, seed=5,
        options=EngineOptions(terminal_law=True,
                              chunk_paths=4 * eng.KEY_TILE))
    np.testing.assert_array_equal(fa, fb)
    r1 = smmc.simulate_stats(GAUSS, n, t, seed=5, options=LAW)
    r2 = smmc.simulate_stats(GAUSS, n, t, seed=5, options=LAW, mesh=mesh8)
    # identical SAMPLE (histogram/extrema exact); moment sums reassociate
    # across the psum merge (float32 partials) — same contract as the
    # month-loop engines (tests/test_sharding.py)
    assert r1.moments.mean == pytest.approx(r2.moments.mean, rel=1e-9)
    assert r1.moments.min == r2.moments.min
    assert r1.moments.max == r2.moments.max
    np.testing.assert_array_equal(r1.histogram_counts,
                                  r2.histogram_counts)


def test_law_rejections():
    with pytest.raises(ValueError, match="track_withdrawn"):
        smmc.simulate_stats(GAUSS, 8192, 12,
                            strategy=FixedPercentWithdrawal(0.25),
                            options=LAW)
    with pytest.raises(ValueError, match="multiplicative"):
        smmc.simulate_stats(GAUSS, 8192, 12,
                            strategy=FixedAmountWithdrawal(amount=1.0),
                            options=EngineOptions(terminal_law=True,
                                                  track_withdrawn=False))
    with pytest.raises(ValueError, match="counter-rng"):
        smmc.simulate_stats(
            smmc.SobolGaussianReturns.create(n_periods=12), 8192, 12,
            options=LAW)
    with pytest.raises(ValueError, match="FINAL"):
        smmc.simulate_bands(GAUSS, 8192, 12, options=LAW)


def test_law_checkpoint_resume(tmp_path):
    """Law runs checkpoint/resume like any other engine config, and the
    fingerprint separates law from month-loop streams."""
    ck = str(tmp_path / "law.npz")
    calls = []

    class Stop(Exception):
        pass

    def interrupt(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise Stop()

    opts = EngineOptions(terminal_law=True, chunk_paths=eng.KEY_TILE)
    with pytest.raises(Stop):
        smmc.simulate_stats(GAUSS, 4 * eng.KEY_TILE, 60, seed=9,
                            options=opts, checkpoint_path=ck,
                            progress=interrupt)
    resumed = smmc.simulate_stats(GAUSS, 4 * eng.KEY_TILE, 60, seed=9,
                                  options=opts, checkpoint_path=ck)
    fresh = smmc.simulate_stats(GAUSS, 4 * eng.KEY_TILE, 60, seed=9,
                                options=opts)
    assert resumed.moments.mean == pytest.approx(fresh.moments.mean,
                                                 rel=1e-12)
    np.testing.assert_array_equal(resumed.histogram_counts,
                                  fresh.histogram_counts)
    # a month-loop run must REFUSE the law checkpoint loudly: the
    # fingerprint's effective-sampler tag separates the streams
    with pytest.raises(ValueError, match="different run"):
        smmc.simulate_stats(
            GAUSS, 4 * eng.KEY_TILE, 60, seed=9,
            options=EngineOptions(chunk_paths=eng.KEY_TILE),
            checkpoint_path=ck)
