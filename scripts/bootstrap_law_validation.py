"""Deep validation of the historical sampler vs the exact bootstrap law.

Runs the historical 360-month config at 1e9 paths through the month loop
and compares histogram quantiles and P(final < x) against the EXACT
iid-bootstrap FFT law (ops/analytic.bootstrap_final_value_distribution)
— a fully independent float64 oracle with no Monte Carlo noise. 1e9
paths resolve p = 1e-5 with ~10k tail hits (rel std err ~1%).

Usage (one GPU, exclusive): python scripts/bootstrap_law_validation.py
"""

import sys
import time

import numpy as np

import jax


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit("requires a GPU")
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions
    from stock_market_monte_carlo_jax.ops import analytic as an

    n, t, v0 = 1_000_000_000, 360, 1000.0
    h = smmc.HistoricalBootstrap.from_csv()
    ps = [1e-5, 1e-4, 1e-3, 0.01, 0.5, 0.99, 1 - 1e-3, 1 - 1e-4, 1 - 1e-5]

    print("computing the exact bootstrap law (FFT)...")
    r = tuple(np.asarray(h.returns_pct, np.float64))
    vb, cb = an.bootstrap_final_value_distribution(r, t, v0)
    q_law = an.quantiles_from_cdf(vb, cb, ps)
    x_tail = float(q_law[1])  # the 1e-4 quantile

    t0 = time.time()
    res = smmc.simulate_stats(
        h, n, t, initial_capital=v0, seed=20260817,
        target_amount=x_tail,
        options=EngineOptions(chunk_paths=2**24),
    )
    el = time.time() - t0
    q_mc = res.quantiles(ps)
    print(f"\n== historical month loop: 1e9x360 in {el:.2f}s "
          f"({n / el / 1e6:.0f}M paths/s) ==")
    g = 1 + np.asarray(r) / 100
    mean_cf = v0 * g.mean() ** t
    print(f"mean rel err vs closed form: {res.mean / mean_cf - 1:+.2e}")
    for p_, w in zip(ps, q_law):
        got = q_mc[p_]
        print(f"p={p_:9.2e} mc={got:10.2f} law={w:10.2f} "
              f"rel={(got / w - 1):+.2e}")
    p_below = res.count_below / n
    p_law = float(np.interp(x_tail, vb, cb))
    print(f"P(final < {x_tail:.1f}): mc={p_below:.3e} "
          f"law={p_law:.3e} ratio={p_below / p_law:.4f} "
          f"(binomial rel se {np.sqrt((1 - p_law) / (p_law * n)):.1%})")


if __name__ == "__main__":
    main()
