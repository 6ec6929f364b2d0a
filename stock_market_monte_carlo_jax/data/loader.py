"""Historical monthly-returns loading.

Schema-compatible with the reference pipeline: ``python/get_data.py`` writes
``data/SP500_monthly_returns.csv`` with header ``Date,returns`` where
``returns`` is the monthly percent change of the S&P500 monthly-mean close
(reference: python/get_data.py:58-70); the C++ loader reads only the
``returns`` column (src/simulations.cpp:83-93).

Because the reference's data file is gitignored and this environment has no
network egress, a deterministic *synthetic* stand-in with S&P500-like moments
is vendored for hermetic tests and demos (see ``_synthetic.py`` for its
generator). Point ``read_historical_returns`` at a real CSV for production
use, or run ``smmc get-data`` on a machine with network access.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SYNTHETIC_CSV = os.path.join(_PKG_DIR, "sp500_monthly_returns_synthetic.csv")
# Adversarial stress fixture (heavy tails, crash clusters, pinned -85%
# and +120% months, n=97 — below one 128-lane tile): see
# data/_synthetic.hostile_monthly_returns and tests/test_hostile_table.py
HOSTILE_CSV = os.path.join(_PKG_DIR, "hostile_monthly_returns.csv")
# The reference's hard-coded location (examples/benchmark_mc_cpu.cpp:25).
REFERENCE_CSV_RELPATH = os.path.join("data", "SP500_monthly_returns.csv")


def default_returns_path() -> str:
    """Resolve the returns CSV like the reference binaries would.

    An explicit ``$SMMC_RETURNS_CSV`` wins, then
    ``./data/SP500_monthly_returns.csv`` relative to the CWD (the
    reference's convention), then the vendored synthetic snapshot.
    """
    env = os.environ.get("SMMC_RETURNS_CSV")
    if env:
        return env
    if os.path.exists(REFERENCE_CSV_RELPATH):
        return REFERENCE_CSV_RELPATH
    return SYNTHETIC_CSV


def read_historical_returns(path: Optional[str] = None) -> np.ndarray:
    """Read the ``returns`` column (percent) from a monthly-returns CSV.

    Matches the reference loader's contract (src/simulations.cpp:83-93):
    only the ``returns`` column is consumed, extra columns are ignored.
    Non-numeric / empty rows (the leading NaN that ``pct_change`` produces,
    python/get_data.py:59) are skipped. Returns float32.
    """
    if path is None:
        path = default_returns_path()

    # Fast native CSV reader when the C++ extension is built; falls back to
    # the pure-Python csv module.
    try:
        from stock_market_monte_carlo_jax.native import native_read_returns

        out = native_read_returns(path)
        if out is not None and len(out):
            return out
    except (ImportError, IOError):
        # fall through to the Python reader, which raises precise errors
        pass

    values = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        try:
            col = header.index("returns")
        except ValueError:
            raise ValueError(
                f"CSV {path!r} has no 'returns' column (header={header!r})"
            )
        for row in reader:
            if len(row) <= col:
                continue
            try:
                v = float(row[col])
            except ValueError:
                continue
            if math.isnan(v):
                continue
            values.append(v)
    if not values:
        raise ValueError(f"CSV {path!r} contains no parseable returns")
    return np.asarray(values, dtype=np.float32)
