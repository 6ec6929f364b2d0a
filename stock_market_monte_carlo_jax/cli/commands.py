"""Subcommand implementations. Output formats follow the reference
binaries' print conventions (e.g. benchmark_mc_gpu.cpp:74-80's stats block)
so existing eyeballs and scripts keep working."""

from __future__ import annotations

import json
import time

import numpy as np

from stock_market_monte_carlo_jax.config import EngineOptions


def _model_historical(csv=None):
    from stock_market_monte_carlo_jax.models.market import (
        HistoricalBootstrap,
    )

    return HistoricalBootstrap.from_csv(csv)


def _print_stats_block(res, target):
    print(f"n_simulations: {res.n_paths}")
    print(f"All {res.n_paths} simulation done in {res.elapsed_s:.3f} s!")
    print(f"mean: {res.mean:.2f} | std: {res.std:.2f}")
    if res.count_below is not None:
        pct = 100.0 * res.prob_below
        print(
            f"count_below {target:.1f}: {res.count_below} ({pct:.4f}%)"
        )


def _run_benchmark(n_months, n_sims, target=1000.0, mesh=None,
                   keep_trajectories=0, histogram=True,
                   terminal_law=False):
    import stock_market_monte_carlo_jax as smmc

    model = _model_historical()
    res = smmc.run(
        model, n_sims, n_months, initial_capital=1000.0, seed=0,
        target_amount=target,
        options=EngineOptions(histogram=histogram,
                              terminal_law=terminal_law),
        mesh=mesh, keep_trajectories=keep_trajectories,
    )
    _print_stats_block(res, target)
    return res


def benchmark_mc_cpu(args):
    # v1 semantics: trajectories retained (capped like the reference GUIs
    # cap drawn curves) + full stats
    _run_benchmark(args.n_months, args.n_simulations,
                   keep_trajectories=min(args.n_simulations, 256))


def benchmark_mc_cpu_v2(args):
    _run_benchmark(args.n_months, args.n_simulations)


def _mesh(n_devices):
    from stock_market_monte_carlo_jax.parallel import paths_mesh

    try:
        return paths_mesh(n_devices)
    except ValueError as e:
        raise SystemExit(str(e))


def benchmark_mc_gpu(args):
    _run_benchmark(args.n_months, args.n_simulations,
                   mesh=_mesh(args.n_devices))


def benchmark_mc_reduceblock(args):
    # the fused on-device stats path is the default engine; this command
    # exists for argv parity with benchmark_mc_gpu_reduceBlock, including
    # its CLT count-below estimate print (the reference's only option —
    # benchmark_mc_gpu_reduceBlock.cpp:65-70,109-113 — shown here next to
    # the exact on-device count it couldn't compute)
    from stock_market_monte_carlo_jax.ops.normal import count_below_clt

    # histogram=False = the reduceBlock contract exactly: mean/variance
    # only ever leave the device (README.md:75 "compute means on GPU to
    # further reduce data transfer")
    res = _run_benchmark(args.n_months, args.n_simulations,
                         mesh=_mesh(args.n_devices), histogram=False,
                         terminal_law=getattr(args, "terminal_law",
                                              False))
    est = float(np.asarray(count_below_clt(
        1000.0, res.mean, res.std, res.n_paths
    )))
    print(f"count_below 1000.0 (CLT estimate, ref parity): {est:,.0f} "
          f"({100 * est / res.n_paths:.4f}%)")


def benchmark_reduce_mean(args):
    """Host-vs-device mean cross-check (ref: benchmark_reduce_mean.cpp:
    29-43 prints mean_cpu vs mean_gpu as its de-facto correctness test)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    vec = rng.random(args.n, dtype=np.float32)

    t0 = time.perf_counter()
    mean_host = float(vec.mean(dtype=np.float64))
    t_host = time.perf_counter() - t0

    x = jnp.asarray(vec)
    mean_fn = jax.jit(jnp.mean)
    float(mean_fn(x))  # warm
    t0 = time.perf_counter()
    mean_dev = float(mean_fn(x))
    t_dev = time.perf_counter() - t0

    print(f"mean_host: {mean_host:.6f} ({t_host*1e3:.1f} ms)")
    print(f"mean_device: {mean_dev:.6f} ({t_dev*1e3:.1f} ms) "
          f"[{jax.default_backend()}]")
    rel = abs(mean_host - mean_dev) / abs(mean_host)
    print(f"rel_diff: {rel:.2e}")
    if rel > 1e-5:
        raise SystemExit("host/device mean mismatch")


def benchmark_google(args):
    """Repeated benchmark with Google-Benchmark-style JSON output
    (ref: benchmark_mc_gpu_google.cpp + README.md:87-96)."""
    import stock_market_monte_carlo_jax as smmc

    model = _model_historical()
    # untimed warmup: rep 0 would otherwise carry the jit compile,
    # poisoning the mean aggregate and the U-test samples
    # benchmark-compare consumes
    smmc.simulate_stats(model, args.n_simulations, args.n_months, seed=999)
    runs = []
    for rep in range(args.repetitions):
        res = smmc.simulate_stats(
            model, args.n_simulations, args.n_months, seed=rep,
        )
        runs.append(res.elapsed_s)
        print(f"rep {rep}: {res.elapsed_s:.4f} s "
              f"({args.n_simulations / res.elapsed_s:,.0f} paths/s)")
    name = f"mc/{args.n_months}/{args.n_simulations}"
    # Google-Benchmark-shaped: one entry per repetition plus aggregates,
    # so bench/compare.py can run the Mann-Whitney U test on the samples
    # (the reference workflow: --benchmark_repetitions=10 + compare.py,
    # README.md:87-96).
    entries = [
        {
            "name": name, "run_type": "iteration", "repetition_index": i,
            "real_time": float(t), "time_unit": "s",
        }
        for i, t in enumerate(runs)
    ]
    # ddof=1: Google Benchmark's stddev aggregate is the SAMPLE std —
    # consumers of GB-shaped files expect it (population std reads ~5%
    # low at 10 repetitions)
    for agg, val in (("mean", np.mean(runs)), ("median", np.median(runs)),
                     ("stddev",
                      np.std(runs, ddof=1) if len(runs) > 1 else 0.0)):
        entries.append({
            "name": f"{name}_{agg}", "run_type": "aggregate",
            "aggregate_name": agg, "real_time": float(val),
            "time_unit": "s",
        })
    entries[-3]["paths_per_second"] = (
        args.n_simulations / float(np.mean(runs))
    )
    out = {"benchmarks": entries}
    text = json.dumps(out, indent=2)
    if args.benchmark_out:
        with open(args.benchmark_out, "w") as f:
            f.write(text)
        print(f"wrote {args.benchmark_out}")
    else:
        print(text)


def benchmark_compare(args):
    from stock_market_monte_carlo_jax.bench.compare import compare_files

    compare_files(args.baseline, args.contender, plot_path=args.plot)


def benchmark_plot(args):
    """Single-file metric plotter with the reference's option surface
    (ref: python/benchmark_compare.py:39-163 — -m/-t/-r/--logx/--logy)."""
    from stock_market_monte_carlo_jax.bench.compare import plot_metric

    plot_metric(
        args.file, metric=args.metric, transform=args.transform,
        relative_to=args.relative_to, logx=args.logx, logy=args.logy,
        xlabel=args.xlabel, ylabel=args.ylabel, title=args.title,
        output=args.output,
    )


def monte_carlo_simulated(args):
    """Gaussian CSV writer (ref: monte_carlo_simulated.cpp:5-55 — one CSV
    per simulation with Returns/Values rows)."""
    import stock_market_monte_carlo_jax as smmc

    model = smmc.GaussianReturns(mean_pct=args.mean, std_pct=args.std)
    traj = np.asarray(smmc.simulate_paths(
        model, args.n_simulations, args.n_months,
        initial_capital=args.initial_capital, seed=args.seed,
    ))
    _write_sim_csvs(traj, "gaussian", args.out_dir)
    print("Done!")


def monte_carlo_historical(args):
    """Historical CSV writer (ref: monte_carlo_historical.cpp:5-51)."""
    import stock_market_monte_carlo_jax as smmc

    print(f"initial_capital: {args.initial_capital} | "
          f"n_months: {args.n_months} | "
          f"n_simulations: {args.n_simulations}")
    model = _model_historical(args.csv)
    traj = np.asarray(smmc.simulate_paths(
        model, args.n_simulations, args.n_months,
        initial_capital=args.initial_capital, seed=args.seed,
    ))
    _write_sim_csvs(traj, "historical", args.out_dir)
    print("Done!")


def _write_sim_csvs(traj, prefix, out_dir):
    from stock_market_monte_carlo_jax.utils.io import write_data_file

    for i in range(traj.shape[0]):
        values = traj[i]
        returns = (values[1:] / values[:-1] - 1.0) * 100.0
        write_data_file(
            f"{prefix}_{i:05d}.csv", returns, values, out_dir=out_dir,
            verbose=(i < 3 or i == traj.shape[0] - 1),
        )


def visualize(args):
    from stock_market_monte_carlo_jax.viz.live import live_visualize

    live_visualize(
        n_months=args.n_months,
        n_simulations=args.n_simulations,
        model_kind=args.model,
        target=args.target,
        seed=args.seed,
        n_curves=args.curves,
        save=args.save,
        overlay_normal=getattr(args, "overlay_normal", False),
        live=getattr(args, "live", True),
        interactive=(True if getattr(args, "interactive", False) else None),
        live_fan=getattr(args, "live_fan", None),
        fan_frames=getattr(args, "fan_frames", None),
        gui=getattr(args, "gui", False),
    )


def visualize_bands(args):
    """Percentile bands over the horizon for any path count — the keepdata
    GUI fan (visualize_returns_cpu.cpp:372-382) at O(T) host transfer."""
    import stock_market_monte_carlo_jax as smmc
    from stock_market_monte_carlo_jax.engine.progress import TerminalProgress
    from stock_market_monte_carlo_jax.viz.plots import band_chart

    if args.model == "historical":
        model = smmc.HistoricalBootstrap.from_csv()
    else:
        model = smmc.GaussianReturns()
    bands = smmc.simulate_bands(
        model, args.n_simulations, args.n_months,
        seed=args.seed, sample_paths=args.curves,
        progress=TerminalProgress(),
        band_mode=getattr(args, "band_mode", "hist"),
    )
    for q, row in zip(bands.quantile_levels, bands.values):
        print(f"p{int(q * 100):02d} final: {row[-1]:,.2f}")
    band_chart(bands, target=args.target,
               save=args.save or "outputs/visualize_bands.png",
               title=f"{args.model} MC bands")


def visualize_rng(args):
    from stock_market_monte_carlo_jax.viz.plots import rng_histograms

    rng_histograms(save=args.save)


def visualize_distribution(args):
    from stock_market_monte_carlo_jax.viz.plots import distribution_curves

    distribution_curves(mean=args.mean, std=args.std, save=args.save)


def get_data(args):
    from stock_market_monte_carlo_jax.data.fetch import fetch_sp500

    fetch_sp500(args.out)


def plot_returns(args):
    from stock_market_monte_carlo_jax.viz.plots import plot_returns_csv

    plot_returns_csv(args.csv_file, save=args.save)


def plot_many_returns(args):
    from stock_market_monte_carlo_jax.viz.plots import plot_many_returns_dir

    plot_many_returns_dir(
        args.dir, max_n=args.max_n,
        inflation_percent=args.inflation_percent, save=args.save,
    )


def demo_vector_add(args):
    """Device hello-world (ref: examples/example_gpu.cpp + src/gpu.cu)."""
    import jax
    import jax.numpy as jnp

    a = jnp.arange(args.n, dtype=jnp.float32)
    b = jnp.ones((args.n,), jnp.float32)
    out = jax.jit(jnp.add)(a, b)
    ok = bool(jnp.all(out[:16] == a[:16] + 1))
    print(f"vector_add on {jax.default_backend()}: "
          f"{'OK' if ok else 'MISMATCH'} (n={args.n})")


def demo_gui(args):
    """GUI-toolkit showcase (ref: examples/example_imgui.cpp — the stock
    ImGui/ImPlot demo window with a small custom panel)."""
    from stock_market_monte_carlo_jax.viz.demo import demo_gui as run_demo

    win = run_demo()
    print(f"demo window: model={win.model_kind} months={int(win.slider.val)}"
          f" mean={win.result.mean:,.1f} (headless backends return"
          " immediately)")
