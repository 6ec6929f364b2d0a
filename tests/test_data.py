import math
import os

import numpy as np
import pytest

from stock_market_monte_carlo_jax.data.loader import (
    SYNTHETIC_CSV,
    default_returns_path,
    read_historical_returns,
)


def test_synthetic_fixture_loads(historical_table):
    # table size mirrors the reference's ~1127-row S&P500 table
    # (src/simulations.cu:123 hard-codes 1127)
    # 94y of monthly prices -> 1127 usable pct_change rows,
    # the reference table size (src/simulations.cu:123)
    assert len(historical_table) == 94 * 12 - 1
    assert historical_table.dtype == np.float32
    assert np.all(np.isfinite(historical_table))
    # S&P500-like moments (percent/month)
    assert 0.1 < historical_table.mean() < 1.0
    assert 3.0 < historical_table.std() < 7.0


def test_loader_skips_nan_and_blank_rows(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("Date,returns\n1928-01,\n1928-02,1.5\n1928-03,nan\n"
                 "1928-04,-2.25\n")
    r = read_historical_returns(str(p))
    np.testing.assert_allclose(r, [1.5, -2.25])


def test_loader_ignores_extra_columns(tmp_path):
    # matches io::CSVReader<1> ignore_extra_column behavior
    # (src/simulations.cpp:84-85)
    p = tmp_path / "r.csv"
    p.write_text("Date,other,returns\n1928-02,9,1.0\n1928-03,9,2.0\n")
    np.testing.assert_allclose(read_historical_returns(str(p)), [1.0, 2.0])


def test_loader_missing_column_raises(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("Date,foo\n1928-02,1.0\n")
    with pytest.raises(ValueError, match="returns"):
        read_historical_returns(str(p))


def test_default_path_env_override(tmp_path, monkeypatch):
    p = tmp_path / "x.csv"
    p.write_text("Date,returns\n1928-02,1.0\n")
    monkeypatch.setenv("SMMC_RETURNS_CSV", str(p))
    assert default_returns_path() == str(p)
    monkeypatch.delenv("SMMC_RETURNS_CSV")
    monkeypatch.chdir(tmp_path)
    assert default_returns_path() == SYNTHETIC_CSV
    os.makedirs(tmp_path / "data")
    (tmp_path / "data" / "SP500_monthly_returns.csv").write_text(
        "Date,returns\n1928-02,1.0\n"
    )
    assert default_returns_path() == os.path.join(
        "data", "SP500_monthly_returns.csv"
    )


def test_synthetic_generator_is_deterministic():
    from stock_market_monte_carlo_jax.data import _synthetic

    a = _synthetic.synthetic_monthly_returns()
    b = _synthetic.synthetic_monthly_returns()
    np.testing.assert_array_equal(a, b)
    assert not math.isnan(a.mean())
