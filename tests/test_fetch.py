"""Data-fetch parsing against recorded response shapes (no network).

The transform half of the S&P500 fetcher (ref: python/get_data.py:33-68)
is exercised on DataFrames shaped exactly like yfinance responses — both
the legacy flat-column form and the modern ticker-level MultiIndex form
that once broke the ``Date,returns`` CSV schema — and its output is
round-tripped through the loader the engines consume.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from stock_market_monte_carlo_jax.data.fetch import (  # noqa: E402
    monthly_returns_from_daily,
)
from stock_market_monte_carlo_jax.data.loader import (  # noqa: E402
    read_historical_returns,
)


def _daily_frame(multiindex: bool):
    """A ^GSPC-shaped daily frame: 3 months of business days, Adj Close
    growing 1% per month deterministically."""
    idx = pd.bdate_range("2021-01-01", "2021-03-31", name="Date")
    month_no = (idx.year - 2021) * 12 + idx.month - 1
    adj = 100.0 * 1.01 ** month_no
    cols = ["Open", "High", "Low", "Close", "Adj Close", "Volume"]
    data = {c: adj for c in cols[:-1]} | {"Volume": np.ones(len(idx))}
    df = pd.DataFrame(data, index=idx)
    df["Close"] = adj * 2.0  # wrong values: must prefer 'Adj Close'
    if multiindex:
        df.columns = pd.MultiIndex.from_product(
            [df.columns, ["^GSPC"]], names=["Price", "Ticker"]
        )
    return df


@pytest.mark.parametrize("multiindex", [False, True])
def test_monthly_returns_schema_and_values(tmp_path, multiindex):
    daily = _daily_frame(multiindex)
    df_daily, df_monthly, returns = monthly_returns_from_daily(daily)
    # schema: single 'returns' column, monthly PeriodIndex named Date,
    # leading NaN row (ref CSV: Date,returns with empty first value)
    assert list(returns.columns) == ["returns"]
    assert returns.index.name == "Date"
    assert np.isnan(returns.iloc[0, 0])
    # deterministic 1%-per-month input -> 1.0 returns
    np.testing.assert_allclose(returns.iloc[1:, 0], 1.0, rtol=1e-9)
    # 'Adj Close' preferred over the poisoned 'Close'
    assert float(df_daily.iloc[0, 0]) == pytest.approx(100.0)

    # the CSV the fetcher writes round-trips through the engine loader
    out = tmp_path / "sp.csv"
    returns.to_csv(out)
    first = out.read_text().splitlines()[:2]
    assert first[0] == "Date,returns"
    assert first[1].endswith(",")           # the leading NaN row
    table = read_historical_returns(str(out))
    assert table.shape == (2,)
    np.testing.assert_allclose(table, 1.0, rtol=1e-6)


def test_close_fallback_when_no_adj_close():
    daily = _daily_frame(False).drop(columns=["Adj Close"])
    _, _, returns = monthly_returns_from_daily(daily)
    np.testing.assert_allclose(returns.iloc[1:, 0], 1.0, rtol=1e-9)


def _load_onboard_module():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "onboard_real_data.py")
    spec = importlib.util.spec_from_file_location("onboard_real_data", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_e2e_fetch_to_engine_pipeline(tmp_path):
    """End-to-end on a recorded-response-shaped fixture: daily frame ->
    monthly_returns_from_daily -> CSV (fetcher schema) -> loader ->
    engine -> stats validated against the exact bootstrap FFT law — the
    full pipe a first networked machine exercises via
    scripts/onboard_real_data.py (ref: get_data.py:11-72 feeding
    simulations.cu:123)."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.ops import analytic as an

    # 150 months of business days with S&P-like noisy monthly levels:
    # deterministic, but NOT constant — the e2e check needs real variance
    rng = np.random.default_rng(42)
    idx = pd.bdate_range("1990-01-01", "2002-06-30", name="Date")
    month_no = (idx.year - 1990) * 12 + idx.month - 1
    level = 100.0 * np.cumprod(
        1.0 + 0.005 + 0.04 * rng.standard_normal(month_no.max() + 1))
    adj = level[month_no]
    cols = ["Open", "High", "Low", "Close", "Adj Close", "Volume"]
    daily = pd.DataFrame({c: adj for c in cols[:-1]}
                         | {"Volume": np.ones(len(idx))}, index=idx)
    daily.columns = pd.MultiIndex.from_product(
        [daily.columns, ["^GSPC"]], names=["Price", "Ticker"])

    _, _, returns = monthly_returns_from_daily(daily)
    out = tmp_path / "SP500_monthly_returns.csv"
    returns.to_csv(out)

    table = read_historical_returns(str(out))
    assert table.shape == (149,)  # leading NaN row dropped

    # onboarding validation + law cross-check on the fixture table
    onboard = _load_onboard_module()
    report = []
    assert onboard.validate_table(table, report), report
    assert onboard.cross_check_law(table, 1 << 17, 60, report), report

    # and the plain engine surface on the same table
    model = smmc.HistoricalBootstrap(table)
    res = smmc.simulate_stats(model, 1 << 16, 60, seed=3)
    v, cdf = an.bootstrap_final_value_distribution(tuple(
        np.asarray(table, np.float64)), 60)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    law_mean = float((v * pmf).sum())
    assert abs(res.mean - law_mean) / law_mean < 0.02


def test_onboard_rejects_garbage_table():
    """The onboarding validator must hard-fail the failure modes that
    would silently corrupt kernels: NaN rows, fraction-vs-percent
    confusion, depleting months, too-short tables."""
    onboard = _load_onboard_module()

    bad_tables = [
        np.array([np.nan] + [1.0] * 200, np.float32),       # NaN
        np.array([95.0, -95.0] * 100, np.float32),          # |r| >= 90
        np.array([-100.0] + [1.0] * 200, np.float32),       # growth <= 0
        np.array([1.0] * 50, np.float32),                   # too short
    ]
    for t in bad_tables:
        report = []
        assert not onboard.validate_table(t, report), (t[:3], report)

    report = []
    good = np.asarray(read_historical_returns(), np.float32)
    assert onboard.validate_table(good, report), report
