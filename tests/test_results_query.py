"""Post-hoc distribution queries on SimulationResult (the 'slider')."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc

GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)


@pytest.fixture(scope="module")
def result():
    return smmc.simulate_stats(GAUSS, 200_000, 120, seed=9,
                               keep_final_values=True)


def test_prob_below_amount_matches_exact(result):
    finals = result.final_values
    hist_only = smmc.SimulationResult(
        n_paths=result.n_paths, n_periods=result.n_periods,
        initial_capital=result.initial_capital, moments=result.moments,
        histogram_spec=result.histogram_spec,
        histogram_counts=result.histogram_counts,
    )
    for q in (0.05, 0.25, 0.5, 0.9):
        amount = float(np.quantile(finals, q))
        exact = float((finals < amount).mean())
        approx = hist_only.prob_below_amount(amount)
        assert abs(approx - exact) < 2e-3, (q, exact, approx)


def test_prob_below_amount_extremes(result):
    assert result.prob_below_amount(-5.0) == 0.0
    assert result.prob_below_amount(0.0) == 0.0
    assert result.prob_below_amount(1e12) == 1.0
    # property (fraction below configured target) still works
    res_t = smmc.simulate_stats(GAUSS, 20_000, 12, seed=1,
                                target_amount=1050.0)
    assert res_t.prob_below == res_t.count_below / res_t.n_paths


def test_prob_below_monotone(result):
    hist_only = smmc.SimulationResult(
        n_paths=result.n_paths, n_periods=result.n_periods,
        initial_capital=result.initial_capital, moments=result.moments,
        histogram_spec=result.histogram_spec,
        histogram_counts=result.histogram_counts,
    )
    xs = np.linspace(result.moments.min * 0.5, result.moments.max * 1.5, 64)
    ps = [hist_only.prob_below_amount(float(x)) for x in xs]
    assert all(b >= a - 1e-12 for a, b in zip(ps, ps[1:]))
    assert ps[0] == 0.0 or ps[0] < 1e-6
    assert ps[-1] == 1.0
