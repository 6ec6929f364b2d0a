"""Extended benchmark sweep: one JSON line per BASELINE.json config.

Configs (BASELINE.json "configs"):
 1. Gaussian 360 x 1M final-value-only     (benchmark_mc_cpu_v2 equivalent)
 2. Historical bootstrap 360 x 1M          (monte_carlo_historical)
 3. Store-all-paths v1 with bands 360 x 1M (visualize_returns)
 4. Sobol QMC vs pseudo convergence        (sobol_joekuo upgrade)
 5. 1B paths fused mean/var/histogram      (reduceBlock scale)

`python bench.py` remains the headline single-line benchmark; this sweep is
for the full record. Usage: python bench_all.py [--quick]
"""

import json
import sys
import time

import numpy as np

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.utils.device import device_record


def _line(name, paths, periods, seconds, extra=None):
    rec = {
        "metric": name,
        "value": round(paths / seconds, 1),
        "unit": "paths/s",
        "extra": {"n_paths": paths, "n_periods": periods,
                  "elapsed_s": round(seconds, 4), **(extra or {}),
                  "device": device_record()},
    }
    print(json.dumps(rec), flush=True)


def main():
    quick = "--quick" in sys.argv
    t_mo = 360
    n1 = 1_000_000
    opts = EngineOptions()

    gauss = smmc.GaussianReturns()
    hist = smmc.HistoricalBootstrap.from_csv()

    # warmup/compile with the exact shapes each config dispatches
    # (configs 3/4/6 warm inline just before their timed regions)
    smmc.simulate_final_values(gauss, n1, t_mo, seed=1, options=opts)
    smmc.simulate_stats(hist, n1, t_mo, seed=1, options=opts)

    # 1. Gaussian v2 final-only
    t0 = time.perf_counter()
    r = smmc.simulate_final_values(gauss, n1, t_mo, seed=2, options=opts)
    _line("gaussian_360mo_finals", n1, t_mo, time.perf_counter() - t0,
          {"mean": float(np.mean(r))})

    # 2. Historical bootstrap
    t0 = time.perf_counter()
    res = smmc.simulate_stats(hist, n1, t_mo, seed=2, options=opts)
    _line("historical_360mo_stats", n1, t_mo, time.perf_counter() - t0,
          {"mean": round(res.mean, 2)})

    # 3. v1 store-all-paths (trajectory bands) — capped like the reference
    n3 = 16_384 if quick else 65_536
    _ = np.asarray(smmc.simulate_paths(hist, n3, t_mo, seed=1))  # warm
    t0 = time.perf_counter()
    traj = np.asarray(smmc.simulate_paths(hist, n3, t_mo, seed=3))
    bands = np.percentile(traj, [5, 25, 50, 75, 95], axis=0)
    _line("v1_trajectories_with_bands", n3, t_mo,
          time.perf_counter() - t0,
          {"band_shape": list(bands.shape),
           "median_final": round(float(bands[2, -1]), 1)})

    # 4. Sobol vs pseudo convergence (mean abs error vs analytic, same n)
    t_qmc = 120
    n4 = 2**17
    analytic = (1000.0
                * (1 + float(gauss.mean_pct) / 100.0) ** t_qmc)
    sob = smmc.SobolGaussianReturns.create(n_periods=t_qmc)
    smmc.simulate_stats(sob, n4, t_qmc, seed=1, options=opts)  # warm
    smmc.simulate_stats(gauss, n4, t_qmc, seed=1, options=opts)
    t0 = time.perf_counter()
    r_s = smmc.simulate_stats(sob, n4, t_qmc, seed=4, options=opts)
    dt = time.perf_counter() - t0
    r_p = smmc.simulate_stats(gauss, n4, t_qmc, seed=4, options=opts)
    err_s = abs(r_s.mean - analytic) / analytic
    err_p = abs(r_p.mean - analytic) / analytic
    _line("sobol_qmc_120mo", n4, t_qmc, dt, {
        "qmc_mean_rel_err": float(f"{err_s:.2e}"),
        "pseudo_mean_rel_err": float(f"{err_p:.2e}"),
        "qmc_error_ratio": float(f"{err_s / max(err_p, 1e-12):.3f}"),
    })

    # 5. 1B paths fused reduction (reduceBlock scale), Gaussian month loop
    n5 = 10**8 if quick else 10**9
    # warm at the RUN's shape: the fused dispatch compiles one scan
    # program per (full-block, exact-tail) length pair, and a chunk-
    # shaped warm leaves those compiles inside the timed region
    smmc.simulate_stats(gauss, n5, t_mo, seed=1, options=opts)
    t0 = time.perf_counter()
    res = smmc.simulate_stats(gauss, n5, t_mo, seed=5, options=opts)
    _line("billion_path_fused_hist", n5, t_mo, time.perf_counter() - t0,
          {"mean": round(res.mean, 2), "std": round(res.std, 2),
           "hist_mass": float(res.histogram_counts.sum())})

    # 6. device-side percentile bands at scale (keepdata capability with
    # O(T) host transfer, engine/bands.py)
    n6 = 10**6 if quick else 10**7
    # warm with the EXACT timed shape, so no compile lands inside the
    # timed region
    smmc.simulate_bands(gauss, n6, t_mo, seed=1)  # warm
    t0 = time.perf_counter()
    b = smmc.simulate_bands(gauss, n6, t_mo, seed=6)
    _line("trajectory_bands_device", n6, t_mo, time.perf_counter() - t0,
          {"median_final": round(float(b.band(0.5)[-1]), 1),
           "host_transfer_bytes": int(b.month_hist.nbytes)})

    # 7. CDF band mode (band_mode="cdf"): config 6's capability via
    # counts below 32 analytic thresholds per month + probit inversion
    smmc.simulate_bands(gauss, n6, t_mo, seed=1,
                        band_mode="cdf")  # warm (exact timed shape)
    t0 = time.perf_counter()
    c = smmc.simulate_bands(gauss, n6, t_mo, seed=6, band_mode="cdf")
    _line("trajectory_bands_cdf", n6, t_mo, time.perf_counter() - t0,
          {"median_final": round(float(c.band(0.5)[-1]), 1),
           "host_transfer_bytes": int(c.month_hist.nbytes)})

    # 8. terminal-law sampler (EngineOptions(terminal_law=True)): V_T
    # drawn in ONE step from its exact T-fold-convolution law — the
    # framework's algorithmic upgrade over every month-loop kernel
    # (ops/terminal_law.py). Not like-for-like with the reference's
    # month-loop benchmarks; reported as its own config.
    n8 = n5
    law = EngineOptions(terminal_law=True)
    for name, model in (("gaussian", gauss), ("historical", hist)):
        smmc.simulate_stats(model, n8, t_mo, seed=1,
                            options=law)  # warm + fit AT THE RUN SHAPE
        t0 = time.perf_counter()
        res = smmc.simulate_stats(model, n8, t_mo, seed=8, options=law)
        _line(f"terminal_law_{name}", n8, t_mo,
              time.perf_counter() - t0,
              {"mean": round(res.mean, 2), "std": round(res.std, 2),
               "hist_mass": float(res.histogram_counts.sum())})


if __name__ == "__main__":
    main()
