"""Replicated-RQMC error estimation (engine/rqmc.py).

Reference: Sobol is vendored but never wired in (src/simulations.cu:
136-137 TODO) and no error estimation exists anywhere; here replicated
digital-shift randomizations give valid confidence intervals that
shrink at the QMC rate."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.engine.rqmc import _t_critical


def test_t_table_values():
    assert _t_critical(10, 0.95) == pytest.approx(2.228)
    assert _t_critical(1, 0.99) == pytest.approx(63.657)
    assert _t_critical(100, 0.95) == pytest.approx(1.96, abs=1e-3)
    with pytest.raises(ValueError, match="confidence"):
        _t_critical(5, 0.5)
    with pytest.raises(ValueError, match="replicates"):
        _t_critical(0, 0.95)


def test_rqmc_ci_covers_analytic_and_beats_pseudo():
    """The Sobol RQMC interval must cover the closed-form mean, and its
    replicate-to-replicate spread must sit well below equal-cost
    pseudo-random batching (the QMC rate advantage)."""
    t, n, reps = 12, 2**14, 8
    analytic = 1000.0 * (1 + 0.5 / 100.0) ** t
    sob = smmc.SobolGaussianReturns.create(n_periods=t)
    est = smmc.rqmc_estimate(sob, n, t, replicates=reps, seed=3)
    assert est.ci_lo <= analytic <= est.ci_hi
    assert est.replicate_means.shape == (reps,)
    # equal-cost pseudo-random batching
    pse = smmc.rqmc_estimate(smmc.GaussianReturns(), n, t,
                             replicates=reps, seed=3)
    assert est.sem < pse.sem / 4  # measured ~30-300x; 4x is a safe floor
    assert pse.ci_lo <= analytic <= pse.ci_hi  # valid there too
    assert "CI" in str(est)


def test_rqmc_prob_below_and_rejections():
    t, n = 12, 2**13
    g = smmc.GaussianReturns()
    est = smmc.rqmc_estimate(g, n, t, replicates=4, statistic="prob_below",
                             target_amount=1030.0, seed=1)
    assert 0.0 < est.mean < 1.0
    assert est.ci_hi - est.ci_lo > 0
    with pytest.raises(ValueError, match="target_amount"):
        smmc.rqmc_estimate(g, n, t, statistic="prob_below")
    with pytest.raises(ValueError, match="replicates"):
        smmc.rqmc_estimate(g, n, t, replicates=1)
    with pytest.raises(ValueError, match="statistic"):
        smmc.rqmc_estimate(g, n, t, statistic="median")
