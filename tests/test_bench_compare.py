"""Benchmark comparison analysis: Mann-Whitney U test + relative plots
(the reference workflow's benchmark/tools/compare.py + benchmark_compare.py
capabilities, README.md:87-96)."""

import json
import math

import numpy as np
import pytest

from stock_market_monte_carlo_jax.bench.compare import (
    compare_files,
    mann_whitney_u,
)


def test_u_test_known_value():
    # classic worked example: clearly separated samples
    xs = [1.0, 2.0, 3.0, 4.0, 5.0]
    ys = [6.0, 7.0, 8.0, 9.0, 10.0]
    u, p = mann_whitney_u(xs, ys)
    assert u == 0.0
    assert p < 0.02


def test_u_test_identical_distributions():
    rng = np.random.default_rng(0)
    xs = list(rng.normal(10, 1, 30))
    u, p = mann_whitney_u(xs, xs)
    assert p > 0.9


def test_u_test_tie_handling():
    u, p = mann_whitney_u([1.0, 1.0, 2.0], [1.0, 2.0, 2.0])
    assert 0.0 <= p <= 1.0
    u2, p2 = mann_whitney_u([3.0] * 5, [3.0] * 5)
    assert p2 == 1.0  # zero variance -> no evidence


def _write(path, name, samples, extra=None):
    entries = [
        {"name": name, "run_type": "iteration", "repetition_index": i,
         "real_time": float(t), "time_unit": "s"}
        for i, t in enumerate(samples)
    ]
    entries.append({
        "name": f"{name}_median", "run_type": "aggregate",
        "aggregate_name": "median",
        "real_time": float(np.median(samples)), "time_unit": "s",
    })
    if extra:
        entries.extend(extra)
    path.write_text(json.dumps({"benchmarks": entries}))


def test_compare_files_runs_u_test(tmp_path, capsys):
    rng = np.random.default_rng(1)
    base = tmp_path / "base.json"
    cont = tmp_path / "cont.json"
    _write(base, "mc/360/1000000", rng.normal(1.0, 0.01, 10))
    _write(cont, "mc/360/1000000", rng.normal(0.5, 0.01, 10))
    rows = compare_files(str(base), str(cont),
                         plot_path=str(tmp_path / "cmp.png"))
    out = capsys.readouterr().out
    assert len(rows) == 1
    name, bt, ct, speedup, p = rows[0]
    assert speedup == pytest.approx(2.0, rel=0.1)
    assert p is not None and p < 0.01
    assert "*" in out and "Mann-Whitney" in out
    assert (tmp_path / "cmp.png").exists()


def test_compare_files_single_entry_format(tmp_path):
    """Our legacy single-entry format (real_time_median) still parses."""
    for p, t in ((tmp_path / "a.json", 2.0), (tmp_path / "b.json", 1.0)):
        p.write_text(json.dumps({"benchmarks": [{
            "name": "mc/12/1000", "real_time": t, "real_time_median": t,
            "time_unit": "s", "repetitions": 3,
        }]}))
    rows = compare_files(str(tmp_path / "a.json"), str(tmp_path / "b.json"))
    assert rows[0][3] == pytest.approx(2.0)
    assert rows[0][4] is None  # no samples -> no test


def test_benchmark_google_cli_emits_samples(tmp_path, monkeypatch):
    import sys

    from stock_market_monte_carlo_jax.cli.main import main

    out = tmp_path / "bench.json"
    main(["benchmark-google", "12", "20000", "--repetitions", "3",
          "--benchmark_out", str(out)])
    data = json.loads(out.read_text())
    iters = [b for b in data["benchmarks"]
             if b.get("run_type") == "iteration"]
    aggs = [b for b in data["benchmarks"]
            if b.get("run_type") == "aggregate"]
    assert len(iters) == 3
    assert {a["aggregate_name"] for a in aggs} == {
        "mean", "median", "stddev"
    }


def test_repetition_files_use_median_not_first_rep(tmp_path):
    """Regression: files with only per-repetition entries (no aggregates)
    must report the sample median, not the first repetition."""
    import numpy as np

    for p, samples in ((tmp_path / "a.json", [9.0, 1.0, 1.1]),
                       (tmp_path / "b.json", [9.0, 1.0, 1.1])):
        entries = [
            {"name": "mc/1/1", "run_type": "iteration",
             "repetition_index": i, "real_time": t, "time_unit": "s"}
            for i, t in enumerate(samples)
        ]
        p.write_text(json.dumps({"benchmarks": entries}))
    rows = compare_files(str(tmp_path / "a.json"), str(tmp_path / "b.json"))
    assert rows[0][1] == pytest.approx(1.1)   # median, not 9.0


def test_time_unit_normalization(tmp_path, capsys):
    """A nanosecond Google-Benchmark file against our seconds file must
    compare in a common unit (speedups were ~1e9x wrong otherwise)."""

    def write(path, unit, scale):
        entries = [
            {"name": "mc", "run_type": "iteration", "repetition_index": i,
             "real_time": (0.5 + 0.01 * i) * scale, "time_unit": unit}
            for i in range(4)
        ]
        path.write_text(json.dumps({"benchmarks": entries}))

    a = tmp_path / "sec.json"
    b = tmp_path / "nsec.json"
    write(a, "s", 1.0)
    write(b, "ns", 1e9)  # identical timings expressed in ns
    compare_files(str(a), str(b))
    out = capsys.readouterr().out
    # identical distributions: speedup ~1.0x, not 1e9x
    assert "1.00x" in out


def test_missing_time_unit_defaults_by_shape(tmp_path, capsys):
    """Entries without time_unit: Google-Benchmark-shaped entries
    (run_type/aggregate_name) default to GB's nanoseconds; our plain
    format defaults to seconds (ADVICE r2: a GB file missing the field
    was mis-scaled ~1e9x)."""
    gb = tmp_path / "gb.json"
    gb.write_text(json.dumps({"benchmarks": [
        {"name": "mc", "run_type": "iteration", "repetition_index": i,
         "real_time": 2e9}  # 2 s expressed in (implicit) ns
        for i in range(3)
    ]}))
    ours = tmp_path / "ours.json"
    ours.write_text(json.dumps({"benchmarks": [
        {"name": "mc", "real_time": 2.0, "real_time_median": 2.0},
    ]}))
    rows = compare_files(str(gb), str(ours))
    assert rows[0][1] == pytest.approx(2.0)   # ns -> s applied
    assert rows[0][3] == pytest.approx(1.0)   # same time either way


def _write_plot_file(path):
    entries = []
    for size in (100, 1000, 10000):
        entries.append({"name": f"cpu/{size}", "real_time": size * 1.0,
                        "items_per_second": 1e6 / size, "time_unit": "s"})
        entries.append({"name": f"gpu/{size}", "real_time": size * 0.1,
                        "items_per_second": 1e7 / size, "time_unit": "s"})
    entries.append({"name": "gpu/100_mean", "aggregate_name": "mean",
                    "real_time": 999.0, "time_unit": "s"})  # must be skipped
    path.write_text(json.dumps({"benchmarks": entries}))


def test_benchmark_plot_option_parity(tmp_path):
    """The reference plotter's -m/-t/-r/--logx/--logy surface
    (python/benchmark_compare.py:39-93)."""
    from stock_market_monte_carlo_jax.bench.compare import plot_metric

    src = tmp_path / "bench.json"
    _write_plot_file(src)
    out = tmp_path / "plot.png"
    groups = plot_metric(str(src), metric="real_time", transform="",
                         relative_to="cpu", logx=True, logy=True,
                         output=str(out))
    assert out.exists()
    # relative-to-label: cpu normalizes to 1.0, gpu to 0.1 at every size
    assert all(v == pytest.approx(1.0) for v in groups["cpu"].values())
    assert all(v == pytest.approx(0.1) for v in groups["gpu"].values())
    # inverse transform on a different metric
    g2 = plot_metric(str(src), metric="items_per_second",
                     transform="inverse", output=str(tmp_path / "p2.png"))
    assert g2["cpu"][100] == pytest.approx(100 / 1e6)
    # aggregate entries skipped (the 999.0 would have poisoned gpu/100)
    g3 = plot_metric(str(src), metric="real_time",
                     output=str(tmp_path / "p3.png"))
    assert g3["gpu"][100] == pytest.approx(10.0)


def test_benchmark_plot_averages_repetitions(tmp_path):
    """A --benchmark_repetitions file has several iteration entries per
    (label, size); the curve must show their average, not whichever
    repetition came last in the file."""
    from stock_market_monte_carlo_jax.bench.compare import plot_metric

    src = tmp_path / "reps.json"
    entries = [
        {"name": "gpu/100", "run_type": "iteration", "real_time": v,
         "time_unit": "s"}
        for v in (10.0, 12.0, 50.0)   # last rep is a noisy outlier
    ]
    entries.append({"name": "gpu/100_mean", "aggregate_name": "mean",
                    "real_time": 24.0, "time_unit": "s"})
    src.write_text(json.dumps({"benchmarks": entries}))
    g = plot_metric(str(src), metric="real_time",
                    output=str(tmp_path / "p.png"))
    assert g["gpu"][100] == pytest.approx(24.0)


def test_benchmark_plot_cli_and_errors(tmp_path):
    from stock_market_monte_carlo_jax.cli.main import main

    src = tmp_path / "bench.json"
    _write_plot_file(src)
    out = tmp_path / "cli.png"
    main(["benchmark-plot", "-f", str(src), "-m", "real_time",
          "-t", "inverse", "-r", "gpu", "--logx", "--logy",
          "--output", str(out)])
    assert out.exists()
    from stock_market_monte_carlo_jax.bench.compare import plot_metric

    with pytest.raises(SystemExit):
        plot_metric(str(src), metric="no_such_metric")
    with pytest.raises(SystemExit):
        plot_metric(str(src), relative_to="no_such_label")


def test_aggregate_only_entry_skipped(tmp_path, capsys):
    f = tmp_path / "agg.json"
    f.write_text(json.dumps({"benchmarks": [
        {"name": "mc_mean", "run_type": "aggregate",
         "aggregate_name": "mean", "real_time": 1.0, "time_unit": "s"},
        {"name": "ok", "real_time": 2.0, "time_unit": "s",
         "real_time_median": 2.0},
    ]}))
    compare_files(str(f), str(f))
    out = capsys.readouterr().out
    assert "skipped" in out and "ok" in out
