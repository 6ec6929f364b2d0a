import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine import engine as eng
from stock_market_monte_carlo_jax.models.strategies import (
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
)

GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)


def analytic_gaussian_moments(v0, t, mean_pct, std_pct):
    """E[V_T] and Var[V_T] for i.i.d. Gaussian percent returns.

    V_T = V0 * prod g_i with g ~ N(1+mu/100, (sigma/100)^2):
    E = V0 * m1^T, E[V^2] = V0^2 * (m1^2 + s^2)^T.
    """
    m1 = 1 + mean_pct / 100
    s2 = (std_pct / 100) ** 2
    mean = v0 * m1**t
    second = v0**2 * (m1**2 + s2) ** t
    return mean, second - mean**2


def test_gaussian_mean_matches_analytic():
    n, t = 400_000, 120
    res = smmc.simulate_stats(GAUSS, n, t, initial_capital=1000.0, seed=3)
    mean_a, var_a = analytic_gaussian_moments(1000.0, t, 0.5, 10.0 / 12)
    se = np.sqrt(var_a / n)
    assert abs(res.mean - mean_a) < 5 * se
    assert abs(res.std - np.sqrt(var_a)) / np.sqrt(var_a) < 0.02


def test_numpy_parity_exact():
    """Same growth draws -> numpy compounding must match to float rounding.

    This is the analog of the reference's CPU-vs-GPU mean cross-check
    (examples/benchmark_reduce_mean.cpp:29-43) but exact, per-path.
    """
    n, t = eng.KEY_TILE, 48
    key = jax.random.key(7)
    scr = jax.random.fold_in(key, 0x50B0)
    growth = np.asarray(
        eng.sample_growth(GAUSS, key, scr, jnp.uint32(0), (n, t))
    )
    finals_np = 1000.0 * np.prod(growth.astype(np.float64), axis=1)
    finals = smmc.simulate_final_values(GAUSS, n, t, 1000.0, seed=7)
    np.testing.assert_allclose(finals, finals_np, rtol=2e-5)


def test_v1_v2_consistency():
    """Trajectory endpoint == final value for the same seed/paths."""
    n, t = 64, 60
    traj = np.asarray(smmc.simulate_paths(GAUSS, n, t, 1000.0, seed=11))
    finals = smmc.simulate_final_values(GAUSS, n, t, 1000.0, seed=11)[:n]
    assert traj.shape == (n, t + 1)
    np.testing.assert_allclose(traj[:, 0], 1000.0)
    np.testing.assert_allclose(traj[:, -1], finals, rtol=1e-6)


def test_chunk_invariance():
    """Results must not depend on chunk size (RNG is keyed globally)."""
    n, t = 3 * eng.KEY_TILE, 24
    small = EngineOptions(chunk_paths=eng.KEY_TILE)
    big = EngineOptions(chunk_paths=4 * eng.KEY_TILE)
    fa = smmc.simulate_final_values(GAUSS, n, t, seed=5, options=small)
    fb = smmc.simulate_final_values(GAUSS, n, t, seed=5, options=big)
    np.testing.assert_array_equal(fa, fb)


def test_deferred_absorb_bit_identical():
    """The deferred-absorb fast path (no per-chunk consumers: one
    device fetch for the whole run) must reproduce the per-chunk absorb
    path bit for bit — same f64 merges in the same order, only the
    fetch cadence differs."""
    n, t = 5 * eng.KEY_TILE + 123, 18
    opts = EngineOptions(chunk_paths=eng.KEY_TILE)
    a = smmc.simulate_stats(
        GAUSS, n, t, seed=7, target_amount=1500.0, options=opts
    )  # deferred: no stream/progress/checkpoint/keep_finals
    seen = []
    b = smmc.simulate_stats(
        GAUSS, n, t, seed=7, target_amount=1500.0, options=opts,
        progress=lambda d, total: seen.append(d),
    )  # per-chunk absorb path
    assert len(seen) >= 6  # one per chunk + final: the slow path ran
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    assert a.moments == b.moments  # dataclass eq: every derived stat
    assert a.count_below == b.count_below


def test_ragged_path_count():
    """n_paths not divisible by anything still gives exact counts."""
    n, t = eng.KEY_TILE + 1234, 12
    res = smmc.simulate_stats(GAUSS, n, t, seed=1, target_amount=1e9)
    assert res.moments.n == n
    assert res.count_below == n  # everything is below 1e9
    assert res.histogram_counts.sum() == pytest.approx(n)


def test_histogram_and_quantiles_vs_exact():
    n, t = 200_000, 120
    res = smmc.simulate_stats(
        GAUSS, n, t, seed=9, keep_final_values=True
    )
    finals = res.final_values
    assert finals.shape == (n,)
    # histogram mass conservation
    assert res.histogram_counts.sum() == pytest.approx(n)
    # underflow/overflow empty for this benign config
    assert res.histogram_counts[0] == 0
    assert res.histogram_counts[-1] == 0
    # quantiles from histogram vs exact
    q_hist = eng.red.quantiles_from_histogram(
        res.histogram_spec, res.histogram_counts, [0.05, 0.5, 0.95]
    )
    q_exact = np.quantile(finals, [0.05, 0.5, 0.95])
    np.testing.assert_allclose(q_hist, q_exact, rtol=2e-3)


def test_count_below_exact():
    n, t = 100_000, 60
    target = 1200.0
    res = smmc.simulate_stats(
        GAUSS, n, t, seed=13, target_amount=target, keep_final_values=True
    )
    want = int((res.final_values < target).sum())
    assert res.count_below == want


def test_historical_bootstrap_engine(historical_table):
    m = smmc.HistoricalBootstrap(jnp.asarray(historical_table))
    n, t = 100_000, 240
    res = smmc.simulate_stats(m, n, t, seed=2)
    # E[g] from the table
    g = (100 + historical_table.astype(np.float64)) / 100
    mean_a = 1000.0 * g.mean() ** t
    var_a = 1000.0**2 * ((g**2).mean() ** t - g.mean() ** (2 * t))
    se = np.sqrt(var_a / n)
    assert abs(res.mean - mean_a) < 5 * se


def test_seed_changes_results():
    a = smmc.simulate_final_values(GAUSS, 2048, 12, seed=0)
    b = smmc.simulate_final_values(GAUSS, 2048, 12, seed=1)
    assert not np.allclose(a, b)


def test_progress_callback():
    calls = []
    n = 2 * eng.KEY_TILE
    smmc.simulate_stats(
        GAUSS, n, 12, seed=0,
        options=EngineOptions(chunk_paths=eng.KEY_TILE),
        progress=lambda d, t: calls.append((d, t)),
    )
    assert calls[-1] == (n, n)
    assert [d for d, _ in calls] == sorted(d for d, _ in calls)


def test_run_with_trajectories():
    res = smmc.run(GAUSS, 20_000, 36, seed=0, keep_trajectories=50)
    assert res.trajectories.shape == (50, 37)
    assert "mean" in res.summary()


# ---------------------------------------------------------------------------
# Withdrawal strategies
# ---------------------------------------------------------------------------


def test_fixed_percent_scales_final():
    """V' with keep fraction k: finals scale by k^T vs no withdrawal."""
    n, t = eng.KEY_TILE, 60
    base = smmc.simulate_final_values(GAUSS, n, t, seed=4)
    w = smmc.simulate_final_values(
        GAUSS, n, t, seed=4, strategy=FixedPercentWithdrawal(percent=1.0)
    )
    np.testing.assert_allclose(w, base * 0.99**t, rtol=1e-4)


def test_variable_percent_matches_fixed_when_constant():
    n, t = eng.KEY_TILE, 24
    a = smmc.simulate_final_values(
        GAUSS, n, t, seed=4, strategy=FixedPercentWithdrawal(2.0)
    )
    b = smmc.simulate_final_values(
        GAUSS, n, t, seed=4,
        strategy=VariablePercentWithdrawal(jnp.full((t,), 2.0)),
    )
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_fixed_amount_depletes_and_clamps():
    # zero-return market: V_t = V0 - t*amount until depletion, then 0
    m = smmc.GaussianReturns(mean_pct=0.0, std_pct=0.0)
    t = 30
    traj = np.asarray(
        smmc.simulate_paths(
            m, 4, t, initial_capital=100.0, seed=0,
            strategy=FixedAmountWithdrawal(amount=10.0),
        )
    )
    want = np.maximum(100.0 - 10.0 * np.arange(t + 1), 0.0)
    np.testing.assert_allclose(traj[0], want, atol=1e-5)


def test_fixed_amount_total_withdrawn():
    m = smmc.GaussianReturns(mean_pct=0.0, std_pct=0.0)
    res = smmc.simulate_stats(
        m, eng.KEY_TILE, 5, initial_capital=100.0,
        strategy=FixedAmountWithdrawal(amount=10.0),
    )
    assert res.moments.mean == pytest.approx(50.0)
    assert res.moments.total_withdrawn == pytest.approx(
        50.0 * eng.KEY_TILE, rel=1e-6
    )


def test_withdrawal_cannot_go_negative():
    m = smmc.GaussianReturns(mean_pct=0.0, std_pct=0.0)
    res = smmc.simulate_stats(
        m, eng.KEY_TILE, 50, initial_capital=100.0,
        strategy=FixedAmountWithdrawal(amount=37.0),
    )
    assert res.moments.min == pytest.approx(0.0)
    assert res.moments.mean == pytest.approx(0.0)


def test_full_withdrawal_percent_100_exact():
    """keep == 0 (100% withdrawal): finals are exactly 0 and the whole
    month-1 grown value is reported as withdrawn (no 1/keep division)."""
    t = 3
    key = jax.random.key(2)
    scr = jax.random.fold_in(key, 0x50B0)
    growth = eng.sample_growth(GAUSS, key, scr, jnp.uint32(0),
                               (eng.KEY_TILE, t))
    finals, withdrawn = eng.compound_final(
        growth, 1000.0, FixedPercentWithdrawal(100.0)
    )
    np.testing.assert_array_equal(np.asarray(finals), 0.0)
    np.testing.assert_allclose(
        np.asarray(withdrawn), 1000.0 * np.asarray(growth)[:, 0], rtol=1e-6
    )


def test_percent_withdrawn_matches_serial_reference():
    """The closed-form withdrawn total must equal a serial per-month loop."""
    rng = np.random.default_rng(0)
    g = rng.normal(1.005, 0.03, (64, 12)).astype(np.float32)
    finals, wd = eng.compound_final(
        jnp.asarray(g), 1000.0, FixedPercentWithdrawal(3.0)
    )
    v = np.full(64, 1000.0)
    wsum = np.zeros(64)
    for tt in range(12):
        grown = v * g[:, tt]
        w = grown * 0.03
        v = grown - w
        wsum += w
    np.testing.assert_allclose(np.asarray(finals), v, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(wd), wsum, rtol=1e-5)


def test_percent_out_of_range_rejected():
    with pytest.raises(ValueError, match=r"\[0, 100\]"):
        FixedPercentWithdrawal(120.0)
    with pytest.raises(ValueError, match=r"\[0, 100\]"):
        FixedPercentWithdrawal(-1.0)
    with pytest.raises(ValueError, match=r"\[0, 100\]"):
        VariablePercentWithdrawal(jnp.asarray([1.0, 101.0]))
    FixedPercentWithdrawal(100.0)  # boundary is allowed


def test_short_percent_schedule_rejected():
    """A VariablePercentWithdrawal schedule shorter than the horizon is an
    error on EVERY path (regression: the terminal-law path's static slice
    silently treated the missing months as keep=1.0 and returned wrong
    statistics while the month loop failed on a shape mismatch)."""
    short = VariablePercentWithdrawal(jnp.full((12,), 4.0))
    with pytest.raises(ValueError, match="12 entries.*n_periods=24"):
        smmc.simulate_stats(
            GAUSS, 4096, 24, strategy=short,
            options=EngineOptions(terminal_law=True,
                                  track_withdrawn=False),
        )
    with pytest.raises((ValueError, TypeError)):
        smmc.simulate_stats(
            GAUSS, 4096, 24, strategy=short,
            options=EngineOptions(track_withdrawn=False),
        )


def test_keep_finals_host_memory_guard():
    """Multi-GiB keep_final_values runs must error up front, not
    MemoryError in the final concatenate after minutes of compute."""
    with pytest.raises(ValueError, match="GiB of finals"):
        smmc.simulate_stats(GAUSS, 3 * 10**9, 4, keep_final_values=True)


def test_terminal_law_accepts_large_bootstrap_table():
    """The 2^15-row bootstrap-table limit protects the umulhi index map,
    which the terminal-law path never runs — its FFT oracle handles any
    table size. (The month-loop path still rejects the same table.)"""
    rng = np.random.default_rng(7)
    big = smmc.HistoricalBootstrap(
        returns_pct=jnp.asarray(rng.normal(0.02, 1.0, 40_000), jnp.float32)
    )
    res = smmc.simulate_stats(
        big, 8192, 12, options=EngineOptions(terminal_law=True)
    )
    assert np.isfinite(res.mean) and res.n_paths == 8192
    with pytest.raises(ValueError, match="32767"):
        smmc.simulate_stats(big, 8192, 12)


def test_oversized_n_paths_rejected():
    # Counter-rng models no longer cap n_paths: seed segmentation
    # (EngineOptions.seed_segment_paths, tests/test_segments.py) lifts
    # the old uint32 global-offset error. The hard limits that remain:
    sob = smmc.SobolGaussianReturns.create(4)
    with pytest.raises(ValueError, match="Sobol"):
        smmc.simulate_stats(sob, 2**31 + 8192, 4)
    ref = smmc.HistoricalBootstrap.from_csv(rng="reference")
    with pytest.raises(ValueError, match="reference-parity"):
        smmc.simulate_stats(ref, 2**31 + 8192, 4)
    with pytest.raises(ValueError, match="headroom"):
        smmc.simulate_stats(
            GAUSS, 2**33, 1,
            options=EngineOptions(seed_segment_paths=1 << 32),
        )


def test_full_withdrawal_histogram_underflow_bin():
    """percent=100: all finals are exactly 0 and must land in the underflow
    bin (regression: a sub-float32 spec.lo cast to 0.0f and misfiled the
    zeros into the overflow bin)."""
    res = smmc.simulate_stats(
        GAUSS, 20_000, 24, strategy=FixedPercentWithdrawal(100.0)
    )
    assert res.histogram_counts[0] == 20_000
    assert res.histogram_counts.sum() == 20_000


def test_nonpositive_n_periods_rejected():
    with pytest.raises(ValueError, match="n_periods"):
        smmc.simulate_stats(GAUSS, eng.KEY_TILE, 0)
    with pytest.raises(ValueError, match="n_periods"):
        smmc.simulate_bands(GAUSS, eng.KEY_TILE, -3)


def test_stats_only_mode_matches_full_run():
    """EngineOptions(histogram=False) — the reference reduceBlock's
    mean/var-only contract (src/simulations.cu:185-247) — must produce
    bit-identical moments (same streams; the histogram is pure epilogue)
    and degrade the histogram-backed queries with a clear error."""
    g = smmc.GaussianReturns()
    full = smmc.simulate_stats(
        g, 50_000, 120, seed=11, target_amount=1500.0,
        options=EngineOptions(chunk_paths=eng.KEY_TILE),
    )
    bare = smmc.simulate_stats(
        g, 50_000, 120, seed=11, target_amount=1500.0,
        options=EngineOptions(chunk_paths=eng.KEY_TILE, histogram=False),
    )
    assert bare.mean == full.mean
    assert bare.std == full.std
    assert bare.moments.min == full.moments.min
    assert bare.moments.max == full.moments.max
    assert bare.moments.count_below == full.moments.count_below
    assert bare.histogram_counts is None
    with pytest.raises(ValueError):
        bare.quantiles()
    with pytest.raises(ValueError):
        bare.prob_below_amount(1500.0)
    # exact finals still give quantiles without a histogram
    bare_f = smmc.simulate_stats(
        g, 50_000, 120, seed=11, target_amount=1500.0,
        keep_final_values=True,
        options=EngineOptions(chunk_paths=eng.KEY_TILE, histogram=False),
    )
    q = bare_f.quantiles()
    assert 0 < q[0.5] < q[0.75]


def test_track_withdrawn_false_semantics():
    """track_withdrawn=False reports total_withdrawn == 0.0; the finals'
    statistics must be unaffected."""
    g = smmc.GaussianReturns()
    strat = FixedPercentWithdrawal(0.5)
    full = smmc.simulate_stats(
        g, 40_000, 60, seed=4, strategy=strat,
        options=EngineOptions(chunk_paths=eng.KEY_TILE),
    )
    bare = smmc.simulate_stats(
        g, 40_000, 60, seed=4, strategy=strat,
        options=EngineOptions(chunk_paths=eng.KEY_TILE,
                              track_withdrawn=False),
    )
    assert full.moments.total_withdrawn > 0
    assert bare.moments.total_withdrawn == 0.0
    assert bare.mean == full.mean
    assert bare.std == full.std


def test_odd_histogram_bins_supported():
    """histogram_bins other than the default 4094 (here odd) must still
    work."""
    g = smmc.GaussianReturns()
    r = smmc.simulate_stats(
        g, 20_000, 60, seed=5,
        options=EngineOptions(chunk_paths=eng.KEY_TILE,
                              histogram_bins=1000),
    )
    assert r.histogram_counts.shape == (1002,)
    assert r.histogram_counts.sum() == 20_000
    q = r.quantiles([0.5])
    assert q[0.5] > 0


def test_large_initial_capital_moments_finite():
    """f32 power sums of x^4 overflow past ~3e38; the kernels accumulate
    moments on finals/v0 and the host merge restores absolute units in
    float64, so a $10B initial portfolio must produce finite, correct
    moments (previously kurtosis/skew went inf)."""
    v0 = 1e10
    T = 240
    res = smmc.simulate_stats(
        smmc.GaussianReturns(), 20_000, T, seed=6, initial_capital=v0,
        options=EngineOptions(chunk_paths=eng.KEY_TILE),
    )
    mean_a = v0 * 1.005**T
    assert np.isfinite(res.moments.skew)
    assert np.isfinite(res.moments.kurtosis)
    assert abs(res.mean - mean_a) / mean_a < 0.02
    assert abs(res.moments.kurtosis) < 50


def test_nonpositive_initial_capital_rejected():
    with pytest.raises(ValueError, match="initial_capital"):
        smmc.simulate_stats(smmc.GaussianReturns(), 1000, 12,
                            initial_capital=0.0)


def test_oversized_historical_table_rejected(historical_table):
    """The exact integer bootstrap index map is a 16-bit umulhi split —
    tables with >= 2^15 rows would silently wrap; they must error."""
    big = jnp.tile(jnp.asarray(historical_table), 30)  # 33,810 rows
    with pytest.raises(ValueError, match="at most"):
        smmc.simulate_stats(smmc.HistoricalBootstrap(big), 8192, 12)


def test_sobol_horizon_beyond_model_dims_rejected():
    m = smmc.SobolGaussianReturns.create(n_periods=24)
    with pytest.raises(ValueError, match="Sobol"):
        smmc.simulate_stats(m, 8192, 48)


def test_simulate_paths_bf16_transfer_and_chunked_fetch():
    """Trajectory export: the chunked dispatch returns identical values
    to offset composition, and bfloat16 transfer stays within bf16
    rounding of the float32 export."""
    KEY_TILE = eng.KEY_TILE
    n, t = 2 * KEY_TILE + 100, 18
    full = smmc.simulate_paths(GAUSS, n, t, seed=9)
    assert full.shape == (n, t + 1) and full.dtype == np.float32
    part = smmc.simulate_paths(GAUSS, n - KEY_TILE, t, seed=9,
                               path_offset=KEY_TILE)
    np.testing.assert_array_equal(full[KEY_TILE:], part)
    bf = smmc.simulate_paths(GAUSS, n, t, seed=9, dtype="bfloat16")
    assert bf.dtype == np.float32
    np.testing.assert_allclose(bf, full, rtol=8e-3)  # bf16 has ~8 bits


def test_simulate_paths_unaligned_offset():
    """path_offset needs no KEY_TILE alignment: the dispatch window
    aligns down to the RNG tile and drops the lead rows, so arbitrary
    offsets return exactly the matching slice of the global stream (the
    incremental live-fan consumer relies on this, viz/live_fan.py)."""
    KEY_TILE = eng.KEY_TILE
    t = 7
    full = smmc.simulate_paths(GAUSS, KEY_TILE + 64, t, seed=11)
    for off, k in [(20, 30), (KEY_TILE - 5, 40), (KEY_TILE + 3, 9)]:
        part = smmc.simulate_paths(GAUSS, k, t, seed=11, path_offset=off)
        np.testing.assert_array_equal(full[off:off + k], part)


def test_analytic_moment_shift_edges():
    """Centering constant: exact multiplicative mean for gaussian and
    historical (with keep factors), zero for non-multiplicative
    strategies, and clipped finite for extreme horizons."""
    from stock_market_monte_carlo_jax.engine.engine import (
        analytic_moment_shift,
    )
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedAmountWithdrawal,
        FixedPercentWithdrawal,
        NoWithdrawal,
    )

    g = smmc.GaussianReturns(mean_pct=0.5, std_pct=10 / 12)
    assert analytic_moment_shift(g, NoWithdrawal(), 360) == (
        pytest.approx(1.005**360)
    )
    assert analytic_moment_shift(
        g, FixedPercentWithdrawal(1.0), 12
    ) == pytest.approx((1.005 * 0.99) ** 12)
    # non-multiplicative -> unshifted
    assert analytic_moment_shift(g, FixedAmountWithdrawal(5.0), 360) == 0.0
    # enormous horizon: clipped, never inf/nan
    big = analytic_moment_shift(g, NoWithdrawal(), 100_000)
    assert np.isfinite(big) and big <= 1e30
    # historical: exact table mean
    h = smmc.HistoricalBootstrap.from_csv()
    gmean = 1.0 + np.asarray(h.returns_pct, np.float64).mean() / 100.0
    assert analytic_moment_shift(h, NoWithdrawal(), 24) == (
        pytest.approx(gmean**24)
    )


def test_degenerate_sizes():
    """n_paths=1 and n_periods=1 through the full engine: one masked
    tile, exact counts, a one-path 'distribution'."""
    res = smmc.simulate_stats(GAUSS, 1, 1, seed=4, target_amount=2000.0)
    assert res.moments.n == 1
    assert res.histogram_counts.sum() == 1
    assert res.std == 0.0
    # the single final equals v0 * (1 + r/100) for the seed's one draw
    f = smmc.simulate_final_values(GAUSS, 1, 1, seed=4)
    assert f.shape == (1,)
    assert res.mean == pytest.approx(float(f[0]), rel=1e-6)
    # a prime path count keeps exact accounting
    n_prime = 10007
    r2 = smmc.simulate_stats(GAUSS, n_prime, 7, seed=4,
                             target_amount=2000.0)
    assert r2.moments.n == n_prime
    assert r2.histogram_counts.sum() == n_prime


def test_variable_percent_histogram_spec_centered():
    """A sustained VariablePercentWithdrawal schedule shifts the
    final-value mass by prod(keep); the histogram spec must follow it
    (it used to shift only for FixedPercentWithdrawal, pushing ~all
    variable-schedule mass into the underflow bin and degenerating
    histogram quantiles)."""
    import numpy as np

    from stock_market_monte_carlo_jax.models.strategies import (
        VariablePercentWithdrawal,
    )

    t = 120
    strat = VariablePercentWithdrawal(np.full(t, 3.0, np.float32))
    res = smmc.run(GAUSS, eng.KEY_TILE, t, strategy=strat, seed=3)
    hist = res.histogram_counts
    # mass must land in interior bins, not the under/overflow cells
    assert hist[1:-1].sum() > 0.99 * hist.sum()
    # histogram quantiles must track the exact per-path quantiles
    finals = smmc.simulate_final_values(GAUSS, eng.KEY_TILE, t,
                                        strategy=strat, seed=3)
    q_hist = res.quantiles([0.1, 0.5, 0.9])  # dict: q -> value
    q_exact = np.quantile(finals, [0.1, 0.5, 0.9])
    np.testing.assert_allclose(
        [q_hist[q] for q in (0.1, 0.5, 0.9)], q_exact, rtol=0.02
    )


def test_deferred_flush_bound_identity(monkeypatch):
    """The bounded deferred-absorb flush (every _DEFER_FLUSH_CHUNKS
    dispatches — keeps device memory O(bound) instead of O(n_chunks))
    must be invisible: forcing a tiny bound reproduces the unbounded
    queue bit for bit."""
    n, t = 5 * eng.KEY_TILE + 77, 12
    opts = EngineOptions(chunk_paths=eng.KEY_TILE)
    a = smmc.simulate_stats(GAUSS, n, t, seed=5, target_amount=1500.0,
                            options=opts)  # one flush at the end
    monkeypatch.setattr(eng, "_DEFER_FLUSH_CHUNKS", 2)
    b = smmc.simulate_stats(GAUSS, n, t, seed=5, target_amount=1500.0,
                            options=opts)  # three mid-run flushes
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    assert a.moments == b.moments


def test_keep_factors_np_matches_device_twin():
    """engine._keep_factors_np must be BIT-identical to the traced
    _keep_factors for every multiplicative strategy — the host analytics
    (analytic_moment_shift, the terminal-law fit key) switched to the
    numpy twin to avoid a device round trip per call; any f32 divergence
    would silently change the centered power sums."""
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
        NoWithdrawal,
        VariablePercentWithdrawal,
    )

    t = 37
    sched = np.linspace(0.0, 3.7, t).astype(np.float32)
    for strat in (NoWithdrawal(), FixedPercentWithdrawal(0.37),
                  VariablePercentWithdrawal(sched)):
        a = np.asarray(eng._keep_factors(strat, t))
        b = eng._keep_factors_np(strat, t)
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.float32
