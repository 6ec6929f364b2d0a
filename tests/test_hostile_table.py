"""Adversarial returns-table fixtures (VERDICT r4 item 4).

Every published cross-check so far ran on the benign 1127-row synthetic
S&P-like table. These tests re-run the exact-law oracle chain and the
bootstrap sampler on HOSTILE tables — heavy tails
(t(2.5) body, kurtosis ~26), sticky crash clusters, pinned -85%/+120%
months, and table sizes far from 1127 on both sides (n=97; n=32749
near the 2^15-1 exact-index-map bound,
engine._validate_run) — flushing out latent table-shape assumptions of
the kind the reference hard-codes (its 1127-row shared-memory buffer,
/root/reference/src/simulations.cu:123, would silently corrupt on any
other table).
"""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.data._synthetic import (
    hostile_monthly_returns,
)
from stock_market_monte_carlo_jax.data.loader import (
    HOSTILE_CSV,
    read_historical_returns,
)
from stock_market_monte_carlo_jax.ops import analytic as an

SIZES = (97, 32749)


@pytest.fixture(scope="module", params=SIZES)
def hostile_model(request):
    return smmc.HistoricalBootstrap(hostile_monthly_returns(request.param))


def test_vendored_csv_matches_generator():
    """The checked-in fixture is the generator's n=97 output exactly
    (regeneration path: data/_synthetic.write_hostile_csv)."""
    vendored = read_historical_returns(HOSTILE_CSV)
    np.testing.assert_allclose(
        vendored, hostile_monthly_returns(97).astype(np.float32), rtol=0
    )


def test_fixture_is_actually_hostile():
    for n in SIZES:
        r = hostile_monthly_returns(n)
        assert r.min() <= -85.0 and r.max() >= 120.0
        assert (r > -100.0).all()  # growth strictly positive
        kurt = ((r - r.mean()) ** 4).mean() / r.std() ** 4
        assert kurt > 10.0, f"n={n}: tails not heavy (kurt {kurt:.1f})"
        runs = "".join("n" if x < 0 else "p" for x in r).split("p")
        assert max(len(s) for s in runs) >= 8, "no negative clusters"


def test_fft_oracle_closed_form_moments_hostile(hostile_model):
    """The exact T-fold-convolution FFT law must reproduce the closed
    forms E[V_T] = v0 E[g]^T and E[V_T^2] = v0^2 E[g^2]^T on a
    heavy-tailed declining table too (same contract as
    tests/test_bootstrap_law.py on the benign fixture).

    Hostile-table finding (this fixture's first catch, root-caused):
    recovering the pmf as ``diff(cdf)`` loses upper-tail cells once the
    float64 cdf is within ~1e-16 of 1 (cumsum absorption) — and on this
    heavy-tailed table the SECOND moment draws ~5e-5 of its mass from
    exactly that region at T=60 (the mean is bulk-dominated and exact
    to 1e-6; every quantile contract is likewise unaffected — quantiles
    live in cdf bulk). Finer grids make it WORSE (the same tail mass
    spreads over more cells that each fall below the absorption
    threshold: measured -4.5e-5 at 2^15, -9e-5 at 2^17, -1.8e-4 at
    2^19), proving it is the cdf representation, not deposition error.
    Asserted at the documented band so a real regression still fails."""
    r = np.asarray(hostile_model.returns_pct, np.float64)
    t = 60
    v, cdf = an.bootstrap_final_value_distribution(tuple(r), t)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    g = 1 + r / 100
    assert (v * pmf).sum() == pytest.approx(1000 * g.mean() ** t, rel=1e-6)
    assert (v * v * pmf).sum() == pytest.approx(
        1000 ** 2 * (g * g).mean() ** t, rel=2e-4
    )


def test_engine_matches_fft_law_hostile(hostile_model):
    """XLA-backend month-loop run vs the exact law: mean within MC
    tolerance, central quantiles close, on both hostile sizes."""
    n, t = 1 << 17, 60
    res = smmc.simulate_stats(hostile_model, n, t, seed=23)
    r = np.asarray(hostile_model.returns_pct, np.float64)
    v, cdf = an.bootstrap_final_value_distribution(tuple(r), t)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    mean_law = (v * pmf).sum()
    var_law = (v * v * pmf).sum() - mean_law ** 2
    assert res.mean == pytest.approx(
        mean_law, abs=6 * np.sqrt(var_law / n)
    )
    q_law = an.quantiles_from_cdf(v, cdf, (0.1, 0.5, 0.9))
    q_mc = res.quantiles((0.1, 0.5, 0.9))
    for p_, w in zip((0.1, 0.5, 0.9), q_law):
        assert q_mc[p_] == pytest.approx(w, rel=5e-2)


def test_terminal_law_refuses_hostile_short_horizon(hostile_model):
    """At T=60 the hostile law (a -85% atom convolved only 60 times) is
    too rough for the degree-47 Chebyshev quantile fit: the fit's
    self-validation must REFUSE with the documented error — never
    silently sample a bad fit (ops/terminal_law.fit_terminal_law)."""
    with pytest.raises(ValueError, match="fit error .* exceeds tol"):
        smmc.simulate_stats(
            hostile_model, 8192, 60, seed=31,
            options=EngineOptions(terminal_law=True),
        )


def test_terminal_law_sampler_hostile_long_horizon(hostile_model):
    """At T=240 the 240-fold convolution smooths even the hostile law
    enough for the fit's own <=2e-4 log-space gate; terminal statistics
    must then agree with the month-loop engine within MC tolerance."""
    n, t = 1 << 17, 240
    law = smmc.simulate_stats(
        hostile_model, n, t, seed=31,
        options=EngineOptions(terminal_law=True),
    )
    loop = smmc.simulate_stats(hostile_model, n, t, seed=31)
    # same law, independent draws; the hostile table DECLINES (~-2%/mo
    # mean), so compare medians/quartiles (the mean at T=240 is
    # dominated by the extreme tail and has huge MC variance)
    q_a = law.quantiles((0.25, 0.5, 0.75))
    q_b = loop.quantiles((0.25, 0.5, 0.75))
    for p_ in (0.25, 0.5, 0.75):
        assert q_a[p_] == pytest.approx(q_b[p_], rel=8e-2)


def test_chunk_invariance_hostile_big_table():
    """Chunk-size invariance must hold with the 32749-row table."""
    model = smmc.HistoricalBootstrap(hostile_monthly_returns(32749))
    kw = dict(n_periods=13, seed=5, target_amount=500.0)
    a = smmc.simulate_stats(model, 3 * 8192 + 11,
                            options=EngineOptions(chunk_paths=8192), **kw)
    b = smmc.simulate_stats(model, 3 * 8192 + 11,
                            options=EngineOptions(chunk_paths=2 * 8192),
                            **kw)
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    # per-path streams are chunk-invariant EXACTLY (histogram above and
    # finals below); the f32 in-chunk moment sums associate differently
    # at different chunk sizes, so moments match to f32 tolerance, not
    # bit-for-bit (same contract as the engine's documented invariant)
    fa = smmc.simulate_final_values(
        model, 2 * 8192, kw["n_periods"], seed=kw["seed"],
        options=EngineOptions(chunk_paths=8192))
    fb = smmc.simulate_final_values(
        model, 2 * 8192, kw["n_periods"], seed=kw["seed"],
        options=EngineOptions(chunk_paths=2 * 8192))
    np.testing.assert_array_equal(fa, fb)
    assert a.mean == pytest.approx(b.mean, rel=1e-7)
    assert a.std == pytest.approx(b.std, rel=1e-5)
    assert a.count_below == b.count_below
    assert a.moments.min == b.moments.min
    assert a.moments.max == b.moments.max


def test_table_bound_rejected_above_2pow15():
    """The exact integer bootstrap index map supports < 2^15 rows; a
    33000-row table must be refused loudly, never silently wrapped
    (engine._validate_run)."""
    model = smmc.HistoricalBootstrap(
        np.ones(1 << 15, np.float32)  # exactly 2^15: first illegal size
    )
    with pytest.raises(ValueError, match="32767"):
        smmc.simulate_stats(model, 8192, 12, seed=1)
