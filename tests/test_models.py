import jax
import jax.numpy as jnp
import numpy as np

from stock_market_monte_carlo_jax.models.market import (
    GaussianReturns,
    HistoricalBootstrap,
)


def test_gaussian_sample_moments():
    m = GaussianReturns(mean_pct=0.5, std_pct=2.0)
    r = m.sample_returns_pct(jax.random.key(0), (200_000,))
    r = np.asarray(r)
    # CLT bounds: se(mean) = 2/sqrt(2e5) ~ 0.0045
    assert abs(r.mean() - 0.5) < 5 * 2.0 / np.sqrt(r.size)
    assert abs(r.std() - 2.0) < 0.02


def test_gaussian_defaults_match_reference():
    # examples/monte_carlo_simulated.cpp:11-13
    m = GaussianReturns()
    assert np.isclose(float(m.mean_pct), 6.0 / 12)
    assert np.isclose(float(m.std_pct), 10.0 / 12)


def test_bootstrap_draws_only_table_values(historical_table):
    m = HistoricalBootstrap(jnp.asarray(historical_table))
    r = np.asarray(m.sample_returns_pct(jax.random.key(1), (10_000,)))
    table = set(np.asarray(historical_table).tolist())
    assert all(v in table for v in r.tolist())


def test_bootstrap_is_uniform_over_indices(historical_table):
    # chi-square on index frequencies via value matching
    m = HistoricalBootstrap(jnp.asarray(historical_table))
    n = 400_000
    r = np.asarray(m.sample_returns_pct(jax.random.key(2), (n,)))
    # count hits per table entry (values are distinct in the synthetic table)
    table = np.asarray(historical_table)
    assert len(np.unique(table)) == len(table)
    idx = np.searchsorted(np.sort(table), r)
    counts = np.bincount(idx, minlength=len(table))
    expected = n / len(table)
    chi2 = ((counts - expected) ** 2 / expected).sum()
    dof = len(table) - 1
    # p ~ 1e-6 bound: chi2 < dof + 5*sqrt(2*dof)
    assert chi2 < dof + 5 * np.sqrt(2 * dof)


def test_models_are_pytrees(historical_table):
    g = GaussianReturns(0.4, 1.1)
    leaves, treedef = jax.tree_util.tree_flatten(g)
    g2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert float(g2.mean_pct) == 0.4

    h = HistoricalBootstrap(jnp.asarray(historical_table))
    leaves, treedef = jax.tree_util.tree_flatten(h)
    assert len(leaves) == 1
    h2 = jax.tree_util.tree_unflatten(treedef, leaves)
    np.testing.assert_array_equal(
        np.asarray(h2.returns_pct), np.asarray(h.returns_pct)
    )
