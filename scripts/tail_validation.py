"""Extreme-tail validation on the GPU: the 1e9-path Gaussian month loop
against the exact normal-law oracle.

Runs the flagship Gaussian config (360 months) at 1e9 paths and compares
deep-tail histogram quantiles and P(final < x) against the deterministic
law of ops/analytic.final_value_distribution. 1e9 paths resolve p = 1e-5
with ~10k tail hits (rel std err ~1%).

Usage (one GPU, exclusive):  python scripts/tail_validation.py
"""

import sys
import time

import numpy as np

import jax


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit("requires a GPU")
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.ops import analytic as an

    n, t, v0 = 1_000_000_000, 360, 1000.0
    mean, std = 0.5, 10 / 12
    ps = [1e-5, 1e-4, 1e-3, 0.5, 1 - 1e-3, 1 - 1e-4, 1 - 1e-5]

    print("computing the deterministic law (CF + FFT)...")
    vn, cn = an.final_value_distribution(mean, std, t, v0)
    want = an.quantiles_from_cdf(vn, cn, ps)
    # target for count-below: the law's 1e-4 quantile
    x_tail = float(want[1])

    t0 = time.time()
    res = smmc.simulate_stats(
        smmc.GaussianReturns(mean_pct=mean, std_pct=std), n, t,
        initial_capital=v0, seed=20260817, target_amount=x_tail,
    )
    el = time.time() - t0
    q_mc = res.quantiles(ps)
    print(f"\n== icdf: 1e9x360 in {el:.2f}s "
          f"({n / el / 1e6:.0f}M paths/s) ==")
    for p_, w in zip(ps, want):
        got = q_mc[p_]
        print(f"p={p_:9.2e} mc={got:10.2f} law={w:10.2f} "
              f"rel={(got / w - 1):+.2e}")
    p_below = res.count_below / n
    p_law = float(np.interp(x_tail, vn, cn))
    print(f"P(final < {x_tail:.1f}): mc={p_below:.3e} "
          f"law={p_law:.3e} ratio={p_below / p_law:.4f} "
          f"(binomial rel se {np.sqrt((1 - p_law) / (p_law * n)):.1%})")


if __name__ == "__main__":
    main()
