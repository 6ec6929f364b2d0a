"""The exact iid-bootstrap FFT law (ops/analytic.
bootstrap_final_value_distribution) — the deterministic oracle the
historical month loop is validated against (at 1e9 paths on the device:
scripts/bootstrap_law_validation.py)."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc


@pytest.fixture(scope="module")
def hist_model():
    return smmc.HistoricalBootstrap.from_csv()


def test_bootstrap_oracle_matches_closed_form_moments(hist_model):
    """The FFT law's mean and second moment must equal the closed forms
    E[V_T] = v0 E[g]^T and E[V_T^2] = v0^2 E[g^2]^T."""
    from stock_market_monte_carlo_jax.ops import analytic as an

    r = np.asarray(hist_model.returns_pct, np.float64)
    t = 240
    v, cdf = an.bootstrap_final_value_distribution(tuple(r), t)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    g = 1 + r / 100
    assert (v * pmf).sum() == pytest.approx(1000 * g.mean() ** t, rel=1e-7)
    assert (v * v * pmf).sum() == pytest.approx(
        1000 ** 2 * (g * g).mean() ** t, rel=1e-7
    )


def test_bootstrap_oracle_grid_convergence(hist_model):
    from stock_market_monte_carlo_jax.ops import analytic as an

    r = np.asarray(hist_model.returns_pct, np.float64)
    qs = (0.01, 0.5, 0.99)
    v1, c1 = an.bootstrap_final_value_distribution(tuple(r), 360)
    v2, c2 = an.bootstrap_final_value_distribution(tuple(r), 360,
                                                   n_grid=1 << 16)
    q1 = an.quantiles_from_cdf(v1, c1, qs)
    q2 = an.quantiles_from_cdf(v2, c2, qs)
    np.testing.assert_allclose(q1, q2, rtol=2e-5)


def test_bootstrap_oracle_rejects_depleting_table():
    from stock_market_monte_carlo_jax.ops import analytic as an

    with pytest.raises(ValueError, match="growth <= 0"):
        an.bootstrap_final_value_distribution((-100.0, 1.0), 12)


def test_engine_historical_matches_bootstrap_law(hist_model):
    """XLA-backend historical run (CPU-executable) vs the law: mean and
    central quantiles inside MC tolerance at 2^17 paths."""
    from stock_market_monte_carlo_jax.ops import analytic as an

    n, t = 1 << 17, 120
    res = smmc.simulate_stats(hist_model, n, t, seed=11)
    r = np.asarray(hist_model.returns_pct, np.float64)
    v, cdf = an.bootstrap_final_value_distribution(tuple(r), t)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    mean_law = (v * pmf).sum()
    var_law = (v * v * pmf).sum() - mean_law ** 2
    assert res.mean == pytest.approx(
        mean_law, abs=5 * np.sqrt(var_law / n)
    )
    q_law = an.quantiles_from_cdf(v, cdf, (0.05, 0.5, 0.95))
    q_mc = res.quantiles((0.05, 0.5, 0.95))
    for p_, w in zip((0.05, 0.5, 0.95), q_law):
        assert q_mc[p_] == pytest.approx(w, rel=2e-2)
