"""Live-streaming visualization: the engine's StreamUpdate callback path
and the terminal dashboard (the working analog of the reference's render
loop polling shared stats mid-run, visualize_returns_cpu.cpp:296-434)."""

import io

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE
from stock_market_monte_carlo_jax.viz.live import (
    LiveDashboard,
    query_loop,
    unicode_histogram,
)

GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)


def test_stream_updates_are_exact_partials():
    updates = []
    n = 4 * KEY_TILE
    res = smmc.simulate_stats(
        GAUSS, n, 24, seed=3, target_amount=1200.0,
        options=EngineOptions(chunk_paths=KEY_TILE),
        stream=updates.append,
    )
    assert len(updates) >= 4
    dones = [u.done for u in updates]
    assert dones == sorted(dones) and dones[-1] == n
    # every frame's histogram mass equals its done count
    for u in updates:
        assert u.hist.sum() == u.done
        assert u.moments.n == u.done
    # final frame must agree exactly with the returned result
    np.testing.assert_array_equal(updates[-1].hist, res.histogram_counts)
    assert updates[-1].moments.mean == pytest.approx(res.mean, rel=1e-12)


def test_stream_prob_below_matches_count():
    updates = []
    n = 2 * KEY_TILE
    res = smmc.simulate_stats(
        GAUSS, n, 60, seed=5, target_amount=1500.0,
        options=EngineOptions(chunk_paths=KEY_TILE),
        stream=updates.append, keep_final_values=True,
    )
    u = updates[-1]
    exact = (res.final_values < 1500.0).mean()
    # histogram interpolation: within a bin width of exact
    assert abs(u.prob_below(1500.0) - exact) < 5e-3
    # far-out targets are exact
    assert u.prob_below(1.0) == 0.0
    assert u.prob_below(1e12) == 1.0


def test_live_dashboard_renders_frames():
    out = io.StringIO()
    dash = LiveDashboard(out=out, min_interval_s=0.0)
    n = 4 * KEY_TILE
    smmc.simulate_stats(
        GAUSS, n, 12, seed=1, target_amount=1100.0,
        options=EngineOptions(chunk_paths=KEY_TILE), stream=dash,
    )
    text = out.getvalue()
    assert dash.frames >= 4           # redrew during the run, not just after
    assert "paths" in text and "mean" in text
    assert "P(final <" in text
    assert "hist" in text
    assert "100.0%" in text           # final frame rendered


def test_query_loop_recomputes_targets():
    updates = []
    smmc.simulate_stats(
        GAUSS, 2 * KEY_TILE, 24, seed=2,
        options=EngineOptions(chunk_paths=KEY_TILE),
        stream=updates.append,
    )
    out = io.StringIO()
    query_loop(
        updates[-1],
        inp=io.StringIO("1e12\nnotanum\nq 0.5\nq 7\nhist\nstats\nquit\n"),
        out=out,
    )
    text = out.getvalue()
    assert "P(final < 1,000,000,000,000.00) = 100.0000%" in text
    assert "not a number" in text
    assert "p50 = " in text
    assert "quantile must be in (0,1)" in text
    assert "skew" in text          # stats command
    assert "\u2588" in text or "█" in text   # hist command rendered blocks


def test_unicode_histogram_shapes():
    assert len(unicode_histogram(np.ones(500), width=56)) == 56
    assert unicode_histogram(np.zeros(10)) .strip() == ""
    s = unicode_histogram(np.asarray([1.0, 100.0, 1.0]), width=3)
    assert s[1] == "█"


def test_prob_below_tail_amounts():
    """Amounts beyond the histogram range: overflow/underflow bins count
    whole; never a KeyError or >1/negative probability."""
    updates = []
    res = smmc.simulate_stats(
        GAUSS, KEY_TILE, 12, seed=8,
        options=EngineOptions(chunk_paths=KEY_TILE),
        stream=updates.append, keep_final_values=True,
    )
    u = updates[-1]
    lo, hi = res.histogram_spec.lo, res.histogram_spec.hi
    assert u.prob_below(hi * 10) == 1.0
    assert u.prob_below(lo / 10) == 0.0
    for amt in (lo * 1.01, hi * 0.99, 1000.0, 1234.5):
        p = u.prob_below(amt)
        exact = (res.final_values < amt).mean()
        assert 0.0 <= p <= 1.0
        assert abs(p - exact) < 5e-3, amt


def test_stream_and_result_prob_below_agree():
    """One shared histogram-CDF implementation: the live StreamUpdate and
    the finished SimulationResult answer identically."""
    updates = []
    res = smmc.simulate_stats(
        GAUSS, 2 * KEY_TILE, 36, seed=12,
        options=EngineOptions(chunk_paths=KEY_TILE), stream=updates.append,
    )
    u = updates[-1]
    for amt in (500.0, 1000.0, 1190.7, 5000.0, 1e12):
        assert u.prob_below(amt) == res.prob_below_amount(amt), amt


def test_no_live_interactive_query(monkeypatch, tmp_path):
    """--no-live --interactive still opens the query prompt (regression:
    it was silently skipped without a dashboard)."""
    import matplotlib

    matplotlib.use("Agg")
    from stock_market_monte_carlo_jax.viz.live import live_visualize

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("1e12\nquit\n"))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    live_visualize(12, 20000, model_kind="gaussian", target=1100.0,
                   live=False, interactive=True, save="x.png")
    text = out.getvalue()
    assert "P(final < 1,000,000,000,000.00) = 100.0000%" in text


def test_live_fan_renders_frames_during_run(tmp_path):
    """The graphical fan must update WHILE the run streams: multiple
    chunks -> multiple PNG frames, curves accumulating across frames, the
    final frame drawing the full capped set (the reference GUI's
    during-run fan, visualize_returns_cpu.cpp:372-404)."""
    from stock_market_monte_carlo_jax.viz.live_fan import LiveFanFigure

    fan = LiveFanFigure(
        GAUSS, 24, seed=3, target=1100.0, n_curves=30,
        out_path=str(tmp_path / "fan.png"),
        frames_dir=str(tmp_path / "frames"),
        curves_per_frame=10, min_interval_s=0.0,
    )
    smmc.simulate_stats(
        GAUSS, 3 * KEY_TILE, 24, seed=3, target_amount=1100.0,
        options=EngineOptions(chunk_paths=KEY_TILE), stream=fan,
    )
    fan.close()
    frames = sorted((tmp_path / "frames").iterdir())
    assert len(frames) >= 3          # one per absorbed chunk
    assert (tmp_path / "fan.png").exists()
    assert fan.curves_done == 30     # final frame completed the fan
    # frames grow as curves/histogram fill in (PNG size is a proxy)
    assert frames[0].stat().st_size > 0


def test_live_fan_cli_flag(tmp_path, monkeypatch):
    from stock_market_monte_carlo_jax.cli.main import main

    monkeypatch.chdir(tmp_path)
    main(["visualize", "12", "20000", "--model", "gaussian", "--no-live",
          "--live-fan", str(tmp_path / "live.png"), "--curves", "8"])
    assert (tmp_path / "live.png").exists()
