"""Headline benchmark: 100M paths x 360 months, simulated and reduced to
moments + count-below + a 4096-bin final-value histogram on device.

The reference's benchmark table (README.md:66-75) is measured in
*historical-bootstrap* mode: the reduceBlock kernel samples the S&P table
and runs 100M x 360 in 0.13 s on an RTX 3070 (mean/var only — no
histogram, no count-below, no extrema).

The headline here is the framework's fastest EXACT answer to that same
task: the terminal-law sampler (ops/terminal_law.py) draws each path's
V_T in one step from the exact T-fold-convolution law of the bootstrap
month loop (Chebyshev quantile fit of the FFT law, ~1e-7 log error).
Same statistical task, same output law, far less device arithmetic.
``vs_baseline`` is that rate over the 3070 reduceBlock's 769.2M paths/s.

The month-loop engine — the structurally like-for-like comparison (one
draw + one compound per path-month, exactly what the reference kernel
does) — is timed alongside; its ratios are in ``extra`` under
``vs_baseline_month_loop*``.

Prints ONE JSON line, naming the device it ran on (platform, kind,
count, and the card's name and power limit where nvidia-smi exists).
Usage: python bench.py [n_paths] [n_periods] [--mesh N]

``--mesh N`` runs every workload sharded over an N-device 1-D "paths"
mesh (parallel/mesh.paths_mesh). The JSON then reports ``n_chips = N``
and per-device rates. The plumbing is validated end-to-end on the
virtual 8-device CPU mesh (tests/test_bench_mesh.py; numbers there are
meaningless, shape and fields are the contract).
"""

import json
import sys
import time

BASELINE_PATHS_PER_S = 100_000_000 / 0.13  # RTX 3070 reduceBlock (README)


def main():
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.config import EngineOptions
    from stock_market_monte_carlo_jax.utils.device import (
        device_record,
        gpu_name_and_power_limit,
    )

    argv = list(sys.argv[1:])
    mesh_n = None
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh_n = int(argv[i + 1])
        del argv[i:i + 2]
    n_paths = int(argv[0]) if len(argv) > 0 else 100_000_000
    n_periods = int(argv[1]) if len(argv) > 1 else 360

    mesh = None
    if mesh_n is not None and mesh_n > 1:
        from stock_market_monte_carlo_jax.parallel.mesh import paths_mesh

        mesh = paths_mesh(mesh_n)
    n_chips = 1 if mesh is None else mesh.size

    def timed(model, reps=3, histogram=True, terminal_law=False,
              chunk_paths=2**24, n_override=None):
        # 2^24 is the largest chunk the exact-count invariant allows
        # (config.py: on-device f32 counts stay exact integers)
        opts = EngineOptions(chunk_paths=chunk_paths,
                             histogram=histogram,
                             terminal_law=terminal_law)
        n_run = n_paths if n_override is None else n_override
        # warmup at the FULL run shape: compiles the chunk program AND
        # the fused-scan program the timed reps dispatch (a run of
        # <= fuse_chunks chunks is ONE device dispatch), so no rep pays
        # compile
        smmc.simulate_stats(model, n_run, n_periods, seed=1,
                            target_amount=2000.0, options=opts, mesh=mesh)
        best, res, rep_times = None, None, []
        for _ in range(reps):  # min-of-N
            t0 = time.perf_counter()
            res = smmc.simulate_stats(
                model, n_run, n_periods, seed=7, target_amount=2000.0,
                options=opts, mesh=mesh,
            )
            dt = time.perf_counter() - t0
            rep_times.append(round(dt, 4))
            best = dt if best is None else min(best, dt)
        all_reps.append(rep_times)
        return best, res

    all_reps = []  # per-engine rep times: machine-variance evidence
    hist_model = smmc.HistoricalBootstrap.from_csv()

    # --- headline: terminal-law historical, full stats + histogram ------
    t_law_h, res_law_h = timed(hist_model, terminal_law=True, reps=9)
    t_law_so, _ = timed(hist_model, terminal_law=True, histogram=False,
                        reps=9)
    gauss = smmc.GaussianReturns()
    t_law_g, res_law_g = timed(gauss, terminal_law=True, reps=9)

    # --- 1e9-path law row: the many-chunk regime where fused dispatch
    #     (EngineOptions.fuse_chunks) batches 60 chunks — the rate here is
    #     the sustained throughput, vs the 100M headline which carries the
    #     fixed per-call host cost ------------------------------------------
    t_law_1e9 = None
    if n_paths == 100_000_000:  # only for the standard workload
        t_law_1e9, _ = timed(hist_model, terminal_law=True, reps=2,
                             n_override=1_000_000_000)

    # --- month-loop engines (structurally like-for-like with the
    #     reference kernel: one draw + one compound per path-month) ------
    t_hist, res_hist = timed(hist_model)
    # histogram=False matches the reference reduceBlock's actual contract
    # (mean/variance only, src/simulations.cu:185-247) — the strict
    # like-for-like workload
    t_hist_so, _ = timed(hist_model, histogram=False)
    t_icdf, res = timed(gauss)

    law_rate = n_paths / t_law_h / n_chips
    hist_rate = n_paths / t_hist / n_chips
    gauss_rate = n_paths / t_icdf / n_chips

    analytic_mean = (1000.0
                     * (1 + float(gauss.mean_pct) / 100.0) ** n_periods)
    rel_err = abs(res.mean - analytic_mean) / analytic_mean
    rel_err_law = abs(res_law_g.mean - analytic_mean) / analytic_mean

    print(json.dumps({
        "metric": "paths_per_sec_per_chip_360mo_historical_exact_law_hist",
        "value": round(law_rate, 1),
        "unit": "paths/s/chip",
        # the framework's fastest exact answer to the reference benchmark
        # task (historical bootstrap, full stats + 4096-bin histogram) vs
        # the 3070's 0.13 s mean/var-only reduceBlock
        "vs_baseline": round(law_rate / BASELINE_PATHS_PER_S, 4),
        "extra": {
            "n_paths": n_paths,
            "n_periods": n_periods,
            "sampler": "terminal_law (exact T-fold-convolution bootstrap "
                       "law; validated vs the FFT oracle at 1e9 paths)",
            "elapsed_s_historical_terminal_law": round(t_law_h, 4),
            "elapsed_s_historical_terminal_law_statsonly": round(
                t_law_so, 4),
            "elapsed_s_gaussian_terminal_law": round(t_law_g, 4),
            "terminal_law_mean": round(res_law_h.mean, 2),
            # sustained many-chunk rate (60 fused chunks)
            **({} if t_law_1e9 is None else {
                "elapsed_s_historical_terminal_law_1e9": round(
                    t_law_1e9, 4),
                "terminal_law_1e9_paths_per_sec": round(
                    1_000_000_000 / t_law_1e9, 1),
            }),
            # month-loop engines: the structurally like-for-like rows
            # (per-month draw + compound, as the reference kernel does)
            "elapsed_s_historical_month_loop": round(t_hist, 4),
            "vs_baseline_month_loop": round(
                hist_rate / BASELINE_PATHS_PER_S, 4),
            # stats-only = the reference reduceBlock's exact contract
            # (mean/var, no histogram/count-below surface beyond target)
            "elapsed_s_historical_month_loop_statsonly": round(t_hist_so, 4),
            "vs_baseline_month_loop_statsonly": round(
                (n_paths / t_hist_so / n_chips) / BASELINE_PATHS_PER_S, 4
            ),
            "elapsed_s_gaussian_icdf": round(t_icdf, 4),
            "gaussian_month_loop_paths_per_sec_per_chip": round(
                gauss_rate, 1),
            "vs_baseline_gaussian_month_loop": round(
                gauss_rate / BASELINE_PATHS_PER_S, 4
            ),
            "n_chips": n_chips,  # devices USED (engine is single-device
            #                      without a mesh); visible devices may
            #                      be more

            "device": device_record(),
            "gpu_name_power_limit": gpu_name_and_power_limit(),
            "historical_mean": round(res_hist.mean, 2),
            "gaussian_mean": round(res.mean, 2),
            "gaussian_std": round(res.std, 2),
            "mean_rel_err_vs_analytic_icdf": float(f"{rel_err:.2e}"),
            "mean_rel_err_vs_analytic_terminal_law": float(
                f"{rel_err_law:.2e}"),
            # raw per-rep wall times, order: law hist, law stats-only,
            # law gaussian, law 1e9 (standard workload only), historical
            # month-loop, historical stats-only, icdf
            "rep_times_s": all_reps,
        },
    }))


if __name__ == "__main__":
    main()
