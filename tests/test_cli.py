"""CLI surface tests — argv parity with the reference binaries."""

import json
import os

import numpy as np
import pytest

from stock_market_monte_carlo_jax.cli.main import main


def _run(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_benchmark_mc_cpu_v2(tmp_path, monkeypatch, capsys):
    _, out = _run(["benchmark-mc-cpu-v2", "12", "20000"],
                  tmp_path, monkeypatch, capsys)
    assert "n_simulations: 20000" in out
    assert "mean:" in out and "count_below" in out


def test_benchmark_mc_gpu_single_device(tmp_path, monkeypatch, capsys):
    _, out = _run(["benchmark-mc-gpu", "1", "12", "20000"],
                  tmp_path, monkeypatch, capsys)
    assert "mean:" in out


def test_benchmark_mc_gpu_multi_device(tmp_path, monkeypatch, capsys):
    _, out = _run(["benchmark-mc-gpu", "8", "12", "65536"],
                  tmp_path, monkeypatch, capsys)
    assert "n_simulations: 65536" in out


def test_monte_carlo_historical_writes_csvs(tmp_path, monkeypatch, capsys):
    _, out = _run(["monte-carlo-historical", "1000", "24", "4"],
                  tmp_path, monkeypatch, capsys)
    assert "Done!" in out
    files = sorted(os.listdir(tmp_path / "outputs"))
    assert files == [f"historical_{i:05d}.csv" for i in range(4)]
    text = (tmp_path / "outputs" / "historical_00000.csv").read_text()
    assert text.startswith("Returns,,")
    assert "\nValues," in text


def test_monte_carlo_simulated_defaults(tmp_path, monkeypatch, capsys):
    _, out = _run(
        ["monte-carlo-simulated", "--n-simulations", "3",
         "--n-months", "12"],
        tmp_path, monkeypatch, capsys,
    )
    files = sorted(os.listdir(tmp_path / "outputs"))
    assert files == [f"gaussian_{i:05d}.csv" for i in range(3)]


def test_csv_roundtrip_through_plotting(tmp_path, monkeypatch, capsys):
    _run(["monte-carlo-historical", "1000", "24", "3"],
         tmp_path, monkeypatch, capsys)
    _, out = _run(["plot-many-returns", "--dir", "outputs/"],
                  tmp_path, monkeypatch, capsys)
    assert "Mean capital value" in out
    assert (tmp_path / "outputs" / "MC_capital_overview.png").exists()
    assert (tmp_path / "outputs" / "MC_returns_overview.png").exists()


def test_plot_single_csv(tmp_path, monkeypatch, capsys):
    _run(["monte-carlo-historical", "1000", "12", "1"],
         tmp_path, monkeypatch, capsys)
    _, out = _run(
        ["plot-returns", "--csv_file", "outputs/historical_00000.csv"],
        tmp_path, monkeypatch, capsys,
    )
    assert (tmp_path / "outputs" / "values.png").exists()
    assert (tmp_path / "outputs" / "monthly_returns.png").exists()


def test_benchmark_reduce_mean(tmp_path, monkeypatch, capsys):
    _, out = _run(["benchmark-reduce-mean", "1000000"],
                  tmp_path, monkeypatch, capsys)
    assert "mean_host" in out and "mean_device" in out
    rel = float(out.split("rel_diff:")[1].strip().split()[0])
    assert rel < 1e-5


def test_benchmark_google_and_compare(tmp_path, monkeypatch, capsys):
    _, _ = _run(
        ["benchmark-google", "12", "20000", "--repetitions", "2",
         "--benchmark_out", "a.json"],
        tmp_path, monkeypatch, capsys,
    )
    data = json.loads((tmp_path / "a.json").read_text())
    iters = [b for b in data["benchmarks"]
             if b.get("run_type") == "iteration"]
    assert len(iters) == 2
    _, out = _run(["benchmark-compare", "a.json", "a.json"],
                  tmp_path, monkeypatch, capsys)
    assert "1.00x" in out


def test_visualize(tmp_path, monkeypatch, capsys):
    _, out = _run(
        ["visualize", "12", "20000", "--curves", "10",
         "--save", "viz.png"],
        tmp_path, monkeypatch, capsys,
    )
    assert "quantiles:" in out
    assert (tmp_path / "viz.png").exists()


def test_visualize_rng_and_distribution(tmp_path, monkeypatch, capsys):
    _run(["visualize-rng", "--save", "r.png"], tmp_path, monkeypatch, capsys)
    assert (tmp_path / "r.png").exists()
    _run(["visualize-distribution", "--save", "d.png"],
         tmp_path, monkeypatch, capsys)
    assert (tmp_path / "d.png").exists()


def test_demo_vector_add(tmp_path, monkeypatch, capsys):
    _, out = _run(["demo-vector-add", "--n", "1024"],
                  tmp_path, monkeypatch, capsys)
    assert "OK" in out


def test_get_data_gated(tmp_path, monkeypatch, capsys):
    has_yf = True
    try:
        import yfinance  # noqa: F401
    except ImportError:
        has_yf = False
    if has_yf:
        pytest.skip("yfinance present; network fetch not exercised in tests")
    with pytest.raises(SystemExit, match="yfinance"):
        _run(["get-data"], tmp_path, monkeypatch, capsys)
