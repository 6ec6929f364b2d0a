"""One-command real-data onboarding: fetch/validate/cross-check/bench.

The reference's whole point is simulating REAL S&P500 monthly returns
(ref: python/get_data.py:11-72 writes data/SP500_monthly_returns.csv; the
table drives every kernel, src/simulations.cu:123). This environment has
zero network egress, so the framework ships a synthetic stand-in — this
script is the bridge for the FIRST NETWORKED machine: it takes a real
table from Yahoo (or a user-supplied CSV), validates it against the
schema and statistical envelope the kernels assume, cross-checks the
simulator against the exact iid-bootstrap FFT law ON THE REAL TABLE, and
writes a report. After it passes, every CLI/API run picks the table up
via SMMC_RETURNS_CSV or ./data/SP500_monthly_returns.csv
(data/loader.default_returns_path).

Usage:
  python scripts/onboard_real_data.py --fetch            # Yahoo download
  python scripts/onboard_real_data.py --csv my_table.csv # bring your own
  ... [--bench] [--n-paths N] [--report onboard_report.md]

Exit status: 0 = onboarded (report says where the table landed),
2 = validation failed (report says exactly which check and why).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# Statistical envelope for a plausible monthly percent-return table.
# Derived from the reference's own dataset (S&P500 1928-2021 monthly:
# mean ~0.6%/mo, std ~4.5%/mo, extremes ~[-30%, +50%], 1127 rows) with
# generous slack so other indices/date ranges onboard cleanly; hard
# failures are reserved for tables the kernels cannot run correctly.
ROWS_HARD_MIN = 120          # < 10 years cannot support T=360 bootstrap
ROWS_SOFT_RANGE = (500, 3000)
ABS_RETURN_HARD_MAX = 90.0   # |r| >= 90%/month: almost surely bad parse
ABS_RETURN_SOFT_MAX = 35.0
MEAN_SOFT_RANGE = (-1.0, 3.0)
STD_SOFT_RANGE = (0.5, 12.0)


def _fail(report, msg):
    report.append(f"- **FAIL** {msg}")
    return False


def _warn(report, msg):
    report.append(f"- WARN {msg}")
    return True


def _ok(report, msg):
    report.append(f"- ok {msg}")
    return True


def validate_table(returns: np.ndarray, report: list) -> bool:
    """Schema + envelope checks; every rule appends a report line."""
    good = True
    n = len(returns)
    report.append(f"- rows: {n}")
    if n < ROWS_HARD_MIN:
        good &= _fail(report, f"only {n} rows (< {ROWS_HARD_MIN}); "
                              "too short to bootstrap 30-year horizons")
    elif not ROWS_SOFT_RANGE[0] <= n <= ROWS_SOFT_RANGE[1]:
        _warn(report, f"row count {n} outside the expected "
                      f"{ROWS_SOFT_RANGE} band (reference table: 1127)")
    if not np.all(np.isfinite(returns)):
        good &= _fail(report, "table contains NaN/inf after parsing")
        return good
    amax = float(np.abs(returns).max(initial=0.0))
    if amax >= ABS_RETURN_HARD_MAX:
        good &= _fail(report, f"|return| up to {amax:.1f}%/month — "
                              "almost surely percent/fraction confusion "
                              "or a parsing bug")
    elif amax > ABS_RETURN_SOFT_MAX:
        _warn(report, f"extreme month {amax:.1f}% (largest real S&P "
                      "month is ~+51% in 1932/33)")
    if np.any(returns <= -100.0):
        good &= _fail(report, "a month with growth <= 0 (r <= -100%): "
                              "log-growth math (terminal law, analytic "
                              "bands) is undefined")
    mean, std = float(returns.mean()), float(returns.std())
    report.append(f"- moments: mean {mean:.4f}%/mo, std {std:.4f}%/mo, "
                  f"min {returns.min():.2f}, max {returns.max():.2f}")
    if not MEAN_SOFT_RANGE[0] <= mean <= MEAN_SOFT_RANGE[1]:
        _warn(report, f"monthly mean {mean:.3f}% outside "
                      f"{MEAN_SOFT_RANGE} (S&P500 1928-2021: ~0.6%)")
    if not STD_SOFT_RANGE[0] <= std <= STD_SOFT_RANGE[1]:
        _warn(report, f"monthly std {std:.3f}% outside {STD_SOFT_RANGE} "
                      "(S&P500 1928-2021: ~4.5%)")
    if good:
        _ok(report, "schema + envelope checks passed")
    return good


def cross_check_law(returns: np.ndarray, n_paths: int, n_periods: int,
                    report: list) -> bool:
    """Simulate on the REAL table and compare mean/std/quantiles to the
    exact iid-bootstrap FFT law (ops/analytic) — the same oracle the
    sampler was validated against at 1e9 paths on the synthetic table
    (scripts/bootstrap_law_validation.py)."""
    import jax

    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.ops import analytic as an

    backend = jax.default_backend()
    report.append(f"- cross-check backend: {backend}, {n_paths:,} paths "
                  f"x {n_periods} months")

    v, cdf = an.bootstrap_final_value_distribution(
        tuple(np.asarray(returns, np.float64)), n_periods)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    law_mean = float((v * pmf).sum())
    law_m2 = float((v * v * pmf).sum())
    law_std = math.sqrt(max(law_m2 - law_mean ** 2, 0.0))

    model = smmc.HistoricalBootstrap(np.asarray(returns, np.float32))
    t0 = time.perf_counter()
    res = smmc.simulate_stats(model, n_paths, n_periods, seed=20260819)
    dt = time.perf_counter() - t0

    se = law_std / math.sqrt(n_paths)
    zscore = abs(res.mean - law_mean) / se if se else 0.0
    rel_std = abs(res.std - law_std) / law_std if law_std else 0.0
    report.append(f"- law mean {law_mean:,.2f} vs MC {res.mean:,.2f} "
                  f"({zscore:.2f} MC standard errors)")
    report.append(f"- law std {law_std:,.2f} vs MC {res.std:,.2f} "
                  f"(rel err {rel_std:.2e})")

    qs = (0.01, 0.25, 0.5, 0.75, 0.99)
    law_q = an.quantiles_from_cdf(v, cdf, qs)
    mc_q = list(res.quantiles(qs).values())
    worst = max(abs(m - l) / l for m, l in zip(mc_q, law_q))
    report.append("- quantiles p1/p25/p50/p75/p99: law "
                  + "/".join(f"{x:,.0f}" for x in law_q) + " vs MC "
                  + "/".join(f"{x:,.0f}" for x in mc_q)
                  + f" (worst rel {worst:.2e})")
    report.append(f"- simulate_stats wall: {dt:.3f} s "
                  f"({n_paths / dt:,.0f} paths/s)")

    good = True
    if zscore > 6.0:
        good = _fail(report, f"MC mean is {zscore:.1f} standard errors "
                             "from the exact law — sampler/table mismatch")
    if rel_std > 0.02:
        good = _fail(report, f"MC std off by {rel_std:.1%} vs the law")
    if worst > 0.02:
        good = _fail(report, f"a central quantile is off by {worst:.1%}")
    if good:
        _ok(report, "simulator matches the exact bootstrap law on this "
                    "table")
    return good


def maybe_bench(returns: np.ndarray, report: list) -> None:
    """Headline-style timing on the real table (GPU only; informational)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        report.append("- bench skipped (no GPU in this process)")
        return
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions

    model = smmc.HistoricalBootstrap(np.asarray(returns, np.float32))
    opts = EngineOptions(chunk_paths=2 ** 24, terminal_law=True)
    n, t = 100_000_000, 360
    smmc.simulate_stats(model, 2 ** 24, t, seed=1, options=opts)  # warm
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        smmc.simulate_stats(model, n, t, seed=7, options=opts)
        best = min(best, time.perf_counter() - t0)
    report.append(f"- bench (real table, terminal-law {n:,} x {t}): "
                  f"{best:.3f} s = {n / best / 1e9:.2f} B paths/s on "
                  f"{jax.devices()[0].device_kind}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csv", help="existing monthly-returns CSV "
                                  "(Date,returns schema)")
    ap.add_argument("--fetch", action="store_true",
                    help="download ^GSPC from Yahoo (needs network + "
                         "yfinance) to data/SP500_monthly_returns.csv")
    ap.add_argument("--bench", action="store_true",
                    help="also run the 100M x 360 terminal-law bench on "
                         "the real table (GPU)")
    ap.add_argument("--n-paths", type=int, default=1 << 21,
                    help="MC paths for the law cross-check (default 2^21)")
    ap.add_argument("--n-periods", type=int, default=360)
    ap.add_argument("--report", default="onboard_report.md")
    args = ap.parse_args()

    report = ["# Real-data onboarding report", ""]
    if args.csv:
        csv_path = args.csv
    elif args.fetch:
        from stock_market_monte_carlo_jax.data.fetch import fetch_sp500

        csv_path = fetch_sp500()
    else:
        from stock_market_monte_carlo_jax.data.loader import (
            SYNTHETIC_CSV,
            default_returns_path,
        )

        csv_path = default_returns_path()
        if csv_path == SYNTHETIC_CSV:
            print("No real table found. Pass --csv PATH, or --fetch on a "
                  "networked machine with yfinance installed, or set "
                  "SMMC_RETURNS_CSV / place the file at "
                  "./data/SP500_monthly_returns.csv")
            return 2
    report.append(f"- source: `{csv_path}`")

    from stock_market_monte_carlo_jax.data.loader import (
        read_historical_returns,
    )

    try:
        returns = read_historical_returns(csv_path)
    except Exception as e:
        report.append(f"- **FAIL** CSV unreadable: {type(e).__name__}: {e}")
        returns = None

    good = returns is not None
    if good:
        good = validate_table(returns, report)
    if good:
        good = cross_check_law(returns, args.n_paths, args.n_periods,
                               report)
    if good and args.bench:
        maybe_bench(returns, report)

    if good:
        report.append("")
        report.append("**Onboarded.** Make it the default for every run "
                      "with either:")
        report.append(f"  - `export SMMC_RETURNS_CSV={os.path.abspath(csv_path)}`")
        report.append("  - or copy it to `./data/SP500_monthly_returns.csv` "
                      "(the reference's convention)")
    text = "\n".join(report) + "\n"
    print(text)
    with open(args.report, "w") as f:
        f.write(text)
    print(f"report written to {args.report}")
    return 0 if good else 2


if __name__ == "__main__":
    raise SystemExit(main())
