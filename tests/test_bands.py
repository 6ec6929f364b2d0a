"""Device-side trajectory decimation (engine/bands.py): percentile bands
with O(T * n_bins) host transfer — the reference's keep-data capability
(src/simulations.cpp:139-202) without the O(N*T) memory."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE
from stock_market_monte_carlo_jax.models.strategies import (
    FixedAmountWithdrawal,
)

GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)


def test_bands_match_exact_quantiles():
    """Band values must agree with exact per-month quantiles computed from
    fully materialized trajectories (to within a z-bin width)."""
    n, t = 4 * KEY_TILE, 48
    bands = smmc.simulate_bands(GAUSS, n, t, seed=7,
                                quantile_levels=(0.05, 0.5, 0.95))
    traj = np.asarray(smmc.simulate_paths(GAUSS, n, t, seed=7))
    for qi, q in enumerate((0.05, 0.5, 0.95)):
        exact = np.quantile(traj, q, axis=0)
        got = bands.values[qi]
        np.testing.assert_allclose(got[1:], exact[1:], rtol=5e-3)
    # month 0 is exactly the initial capital
    assert np.allclose(bands.values[:, 0], 1000.0, rtol=1e-3)


def test_bands_mass_and_shapes():
    n, t = KEY_TILE + 777, 12   # ragged
    bands = smmc.simulate_bands(GAUSS, n, t, seed=1, sample_paths=5)
    assert bands.values.shape == (5, t + 1)
    assert bands.sample_paths.shape == (5, t + 1)
    assert bands.month_hist.shape[0] == t + 1
    # every month's histogram holds exactly n paths
    np.testing.assert_array_equal(bands.month_hist.sum(axis=1),
                                  np.full(t + 1, n))


def test_bands_chunk_invariance():
    n, t = 3 * KEY_TILE, 24
    a = smmc.simulate_bands(GAUSS, n, t, seed=5,
                            options=EngineOptions(chunk_paths=KEY_TILE))
    b = smmc.simulate_bands(GAUSS, n, t, seed=5,
                            options=EngineOptions(chunk_paths=4 * KEY_TILE))
    np.testing.assert_array_equal(a.month_hist, b.month_hist)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-12)


def test_bands_with_depleting_withdrawal():
    """Zero-return market with a fixed withdrawal: the median band must
    track the deterministic V0 - t*amount path and hit exactly 0."""
    m = smmc.GaussianReturns(mean_pct=0.0, std_pct=1e-6)
    t = 20
    bands = smmc.simulate_bands(
        m, KEY_TILE, t, initial_capital=100.0,
        strategy=FixedAmountWithdrawal(amount=10.0),
        quantile_levels=(0.5,),
    )
    want = np.maximum(100.0 - 10.0 * np.arange(t + 1), 0.0)
    med = bands.values[0]
    np.testing.assert_allclose(med[:10], want[:10], rtol=2e-2)
    assert np.all(med[11:] == 0.0)   # depleted mass -> exact zero


@pytest.mark.parametrize("case", ["gaussian", "historical_percent",
                                  "fixed_amount"])
def test_month_hist_matches_numpy_counts(case):
    """The per-month histogram (one scatter over month-major cells) equals
    a numpy count of the same trajectories binned by the same z-grid."""
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
    )

    n, t, nb = KEY_TILE + 321, 7, 64
    model, strat = {
        "gaussian": (GAUSS, smmc.NoWithdrawal()),
        "historical_percent": (smmc.HistoricalBootstrap.from_csv(),
                               FixedPercentWithdrawal(1.0)),
        "fixed_amount": (GAUSS, FixedAmountWithdrawal(amount=40.0)),
    }[case]
    b = smmc.simulate_bands(model, n, t, seed=9, strategy=strat,
                            n_bins=nb, sample_paths=0)
    traj = np.asarray(smmc.simulate_paths(model, n, t, seed=9,
                                          strategy=strat), np.float32)
    if case == "fixed_amount":
        z = traj * (1.0 / b.scales).astype(np.float32)[None, :]
        idx = np.clip(np.floor(z * nb).astype(np.int64) + 1, 1, nb + 1)
        idx = np.where(traj <= 0.0, 0, idx)
    else:
        logv = np.log(np.maximum(traj, np.float32(1e-37)))
        z = ((logv - b.centers.astype(np.float32)[None, :])
             * (1.0 / b.scales).astype(np.float32)[None, :])
        raw = np.floor((z + np.float32(12.0)) * np.float32(nb / 24.0))
        idx = np.clip(raw.astype(np.int64) + 1, 0, nb + 1)
    want = np.stack([np.bincount(idx[:, m], minlength=nb + 2)
                     for m in range(t + 1)])
    # f32 log/multiply may round a value across a bin edge differently
    # in numpy and XLA: allow a few paths per month, never lost mass
    np.testing.assert_array_equal(b.month_hist.sum(axis=1), n)
    assert np.abs(b.month_hist - want).sum() <= 2 * 4 * (t + 1)


def test_bands_progress_callback():
    calls = []
    smmc.simulate_bands(
        GAUSS, 2 * KEY_TILE, 6, seed=0,
        options=EngineOptions(chunk_paths=KEY_TILE),
        progress=lambda d, t: calls.append((d, t)),
    )
    assert calls[-1][0] == 2 * KEY_TILE


def test_visualize_bands_cli(tmp_path, monkeypatch):
    from stock_market_monte_carlo_jax.cli.main import main

    monkeypatch.chdir(tmp_path)
    main(["visualize-bands", "12", "20000", "--model", "gaussian",
          "--target", "1100", "--save", "b.png"])
    assert (tmp_path / "b.png").exists()


def test_bands_sharded_identical_to_single_device(mesh8):
    """Bands over a mesh: per-month histograms psum between devices;
    counter streams make the counts IDENTICAL to the single-device run,
    including a ragged tail."""
    n, t = 2 * KEY_TILE + 777, 18
    a = smmc.simulate_bands(GAUSS, n, t, seed=4, sample_paths=0,
                            options=EngineOptions(chunk_paths=KEY_TILE))
    b = smmc.simulate_bands(GAUSS, n, t, seed=4, sample_paths=0,
                            options=EngineOptions(chunk_paths=KEY_TILE),
                            mesh=mesh8)
    np.testing.assert_array_equal(a.month_hist, b.month_hist)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-12)


def test_bands_sharded_counts_exact_past_f32_range(mesh8):
    """The cross-device count merge must stay exact when one dispatch
    concentrates more than 2^24 paths in a single cell (month 0 puts
    EVERY path at v0). An f32 psum cannot represent the odd total
    2^24 + 7; the int32 merge can."""
    n, t = (1 << 24) + 7, 1
    b = smmc.simulate_bands(GAUSS, n, t, seed=0, sample_paths=0,
                            n_bins=64, mesh=mesh8)
    assert b.month_hist[0].max() == n
    assert b.month_hist.sum(axis=1).tolist() == [n] * (t + 1)


# ---------------------------------------------------------------------------
# CDF band mode (band_mode="cdf"): per-month counts below K
# analytically-placed thresholds (engine/bands._chunk_month_cdf) +
# probit-space host inversion (ops/reductions.cdf_band_quantiles). It
# counts the SAME sample as the hist mode (identical streams), so the
# counts are checked against a numpy count over the exported trajectories.
# ---------------------------------------------------------------------------


def test_cdf_inversion_matches_exact_quantiles():
    """Probit-space interpolation of a 32-point CDF must recover exact
    sample quantiles of a realistic compound-growth sample to ~1e-3 z
    (~1e-4 relative value) — sharper than the hist mode's bin width."""
    from stock_market_monte_carlo_jax.ops.reductions import (
        cdf_band_quantiles, norm_icdf64,
    )

    assert abs(norm_icdf64(0.975) - 1.959963985) < 1e-7
    assert abs(norm_icdf64(0.5)) < 1e-12
    assert abs(norm_icdf64(1e-5) + 4.264890794) < 1e-6

    rng = np.random.default_rng(0)
    k = 32
    g = 1.005 + 0.02 * rng.standard_normal((500_000, 12))
    vals = 1000.0 * np.prod(g, axis=1)
    mu, sd = np.mean(np.log(g)), np.std(np.log(g))
    center = np.log(1000.0) + 12 * mu
    scale = sd * np.sqrt(12)
    dz = 12.0 / (k - 3)
    z0 = -6.0 - dz
    kk = np.arange(k, dtype=np.float64)
    kk[0], kk[-1] = (-14.0 - z0) / dz, (14.0 - z0) / dz
    logthr = center + (z0 + kk * dz) * scale
    counts = (np.log(vals)[None, :] < logthr[:, None]).sum(axis=1)
    qs = (0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99)
    lq = cdf_band_quantiles(counts, logthr, qs, len(vals))
    exact = np.quantile(np.log(vals), qs)
    # probit-interp systematic error is ~1e-3 z at K=32; the rest of the
    # budget is the 500k-sample MC noise of F_k vs the exact quantiles
    # (independent estimators of the same point). A placement or
    # inversion bug fails by orders of magnitude.
    assert np.max(np.abs(lq - exact) / scale) < 1e-2


def test_cdf_inversion_depleted_and_clamp():
    from stock_market_monte_carlo_jax.ops.reductions import (
        cdf_band_quantiles,
    )

    n = 1000
    # 10% of mass below the underflow guard (depleted), rest mid-grid
    counts = np.array([100, 100, 100, 500, 1000, 1000], np.float64)
    logthr = np.linspace(0.0, 5.0, 6)
    lq = cdf_band_quantiles(counts, logthr, (0.05, 0.5, 0.9999), n)
    assert lq[0] == -np.inf                  # inside the depleted mass
    assert logthr[2] < lq[1] < logthr[4]     # interpolated mid-grid
    # q=0.9999's rank sits inside the last resolved segment (its top F
    # is exactly 1.0): the w-clip pins it to that segment's upper edge
    assert lq[2] == logthr[4]
    # mass genuinely past the top threshold (top count < q*n): clamp to
    # the last threshold
    counts2 = np.array([0, 10, 300, 500, 800, 900], np.float64)
    lq2 = cdf_band_quantiles(counts2, logthr, (0.99,), n)
    assert lq2[0] == logthr[-1]


def test_cdf_bands_composition_and_month0():
    """CDF mode: counts monotone in k, bounded by n, month 0 an exact v0
    indicator row, values[:, 0] the initial capital, historical model +
    percent withdrawal, ragged — and every count equal to a numpy count
    of the same trajectories below the same thresholds."""
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
    )

    h = smmc.HistoricalBootstrap.from_csv()
    n, t = KEY_TILE + 100, 5
    strat = FixedPercentWithdrawal(1.0)
    b = smmc.simulate_bands(
        h, n, t, seed=2, strategy=strat,
        options=EngineOptions(chunk_paths=KEY_TILE),
        band_mode="cdf", sample_paths=0,
    )
    assert b.mode == "cdf"
    assert b.month_hist.shape == (t + 1, 32)
    assert b.log_thresholds.shape == (t + 1, 32)
    assert (np.diff(b.month_hist, axis=1) >= 0).all()
    assert (b.month_hist <= n).all()
    # month 0: exact indicator row of v0 against the month-0 thresholds
    expect0 = n * (np.log(1000.0) < b.log_thresholds[0])
    np.testing.assert_array_equal(b.month_hist[0], expect0)
    np.testing.assert_allclose(b.values[:, 0], 1000.0)
    assert np.isfinite(b.values).all()
    traj = np.asarray(smmc.simulate_paths(h, n, t, seed=2, strategy=strat))
    thr = np.exp(b.log_thresholds).astype(np.float32)
    want = (traj[:, :, None] < thr[None, :, :]).sum(axis=0)
    np.testing.assert_array_equal(b.month_hist, want)


def test_cdf_bands_chunk_invariance_and_sharded(mesh8):
    """Tile-keyed streams: CDF counts identical across chunk splits and
    across the 8-device mesh (int32 psum) — same contract as hist."""
    n, t = 2 * KEY_TILE + 777, 4
    kw = dict(seed=5, band_mode="cdf", sample_paths=0)
    a = smmc.simulate_bands(
        GAUSS, n, t,
        options=EngineOptions(chunk_paths=KEY_TILE),
        **kw)
    b = smmc.simulate_bands(
        GAUSS, n, t,
        options=EngineOptions(chunk_paths=2 * KEY_TILE),
        **kw)
    np.testing.assert_array_equal(a.month_hist, b.month_hist)
    c = smmc.simulate_bands(
        GAUSS, n, t,
        options=EngineOptions(chunk_paths=KEY_TILE),
        mesh=mesh8, **kw)
    np.testing.assert_array_equal(a.month_hist, c.month_hist)
    np.testing.assert_allclose(a.values, c.values, rtol=1e-12)


def test_cdf_bands_rejects_unsupported():
    import pytest

    h = smmc.HistoricalBootstrap.from_csv()
    with pytest.raises(ValueError, match="n_thresholds >= 4"):
        smmc.simulate_bands(h, KEY_TILE, 4, band_mode="cdf",
                            n_thresholds=3)
    with pytest.raises(ValueError, match="multiplicative"):
        smmc.simulate_bands(
            h, KEY_TILE, 4, band_mode="cdf",
            strategy=FixedAmountWithdrawal(amount=1.0))
    with pytest.raises(ValueError, match="band_mode"):
        smmc.simulate_bands(h, KEY_TILE, 4, band_mode="nope")


def test_cdf_bands_edge_shapes():
    """n_paths=1, n_periods=1, and a prime-ish ragged count through the
    CDF counts (full-tile padding + masking), and a K that is no multiple
    of 8."""
    for n, t, k in ((1, 1, 32), (8193, 1, 32), (1, 7, 32), (777, 3, 20)):
        b = smmc.simulate_bands(GAUSS, n, t, band_mode="cdf",
                                sample_paths=0, n_thresholds=k)
        assert b.values.shape == (5, t + 1)
        assert b.month_hist.shape == (t + 1, k)
        assert (b.month_hist <= n).all()
        assert (np.diff(b.month_hist, axis=1) >= 0).all()
        np.testing.assert_allclose(b.values[:, 0], 1000.0)


def test_bands_match_fft_marginal_laws():
    """End-to-end statistical validation against a genuinely independent
    oracle: the month-t marginal of V is the t-fold convolution law
    (ops/analytic.final_value_distribution at n_periods=t), so band
    quantiles must match the FFT oracle's at every probed month — full
    fidelity on CPU (XLA backend, threefry draws). Keep-fraction
    strategies shift each month's marginal by keep^t exactly."""
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
    )
    from stock_market_monte_carlo_jax.ops import analytic

    n, t = 1 << 20, 60
    qs = (0.05, 0.5, 0.95)
    mean, std = float(GAUSS.mean_pct), float(GAUSS.std_pct)
    for keep_pct in (0.0, 0.5):
        strat = (smmc.NoWithdrawal() if keep_pct == 0.0
                 else FixedPercentWithdrawal(keep_pct))
        b = smmc.simulate_bands(GAUSS, n, t, seed=3, strategy=strat,
                                quantile_levels=qs, sample_paths=0)
        for tt in (1, 7, 30, 60):
            values, cdf = analytic.final_value_distribution(
                mean, std, tt, 1000.0
            )
            shift = (1.0 - keep_pct / 100.0) ** tt
            oq = analytic.quantiles_from_cdf(values, cdf, qs) * shift
            # budget: histogram z-bin quantization (~2e-3 rel at these
            # scales) + MC quantile noise at 2^20 paths (~5e-4)
            np.testing.assert_allclose(b.values[:, tt], oq, rtol=5e-3)


def test_bands_historical_match_bootstrap_marginals():
    """Same oracle check for the bootstrap model: month-t marginals are
    the exact t-fold convolution of the table's point-mass law."""
    from stock_market_monte_carlo_jax.ops import analytic

    h = smmc.HistoricalBootstrap.from_csv()
    table = np.asarray(h.returns_pct, np.float64)
    n, t = 1 << 20, 24
    qs = (0.05, 0.5, 0.95)
    b = smmc.simulate_bands(h, n, t, seed=5, quantile_levels=qs,
                            sample_paths=0)
    for tt in (6, 24):
        values, cdf = analytic.bootstrap_final_value_distribution(
            table, tt, 1000.0
        )
        oq = analytic.quantiles_from_cdf(values, cdf, qs)
        np.testing.assert_allclose(b.values[:, tt], oq, rtol=5e-3)


def test_analytic_bands_match_sampled_and_oracle():
    """band_mode='analytic': exact infinite-path bands — must agree with
    the standalone per-month oracle to grid tolerance and with a 2^20-
    path sampled run to MC tolerance; keep-fraction strategies shift
    marginals exactly; fan curves still sample."""
    from stock_market_monte_carlo_jax.models.strategies import (
        FixedPercentWithdrawal,
    )
    from stock_market_monte_carlo_jax.ops import analytic

    qs = (0.05, 0.5, 0.95)
    t = 24
    a = smmc.simulate_bands(GAUSS, 1, t, quantile_levels=qs,
                            sample_paths=4, band_mode="analytic")
    assert a.mode == "analytic"
    assert a.n_paths == 0
    assert a.sample_paths.shape == (1, t + 1)  # capped at n_paths
    a4 = smmc.simulate_bands(GAUSS, 100, t, quantile_levels=qs,
                             sample_paths=4, band_mode="analytic")
    assert a4.sample_paths.shape == (4, t + 1)
    mean, std = float(GAUSS.mean_pct), float(GAUSS.std_pct)
    for tt in (1, 12, 24):
        vals, cdf = analytic.final_value_distribution(mean, std, tt,
                                                      1000.0)
        oq = analytic.quantiles_from_cdf(vals, cdf, qs)
        np.testing.assert_allclose(a.values[:, tt], oq, rtol=3e-4)
    s = smmc.simulate_bands(GAUSS, 1 << 20, t, seed=3, quantile_levels=qs,
                            sample_paths=0)
    np.testing.assert_allclose(a.values[:, 1:], s.values[:, 1:],
                               rtol=5e-3)
    # strategy shift is exact
    strat = FixedPercentWithdrawal(0.5)
    ak = smmc.simulate_bands(GAUSS, 1, t, strategy=strat,
                             quantile_levels=qs, sample_paths=0,
                             band_mode="analytic")
    keep = 1.0 - 0.5 / 100.0
    # keep factors are float32 in the strategy contract -> ~1e-7 rel
    np.testing.assert_allclose(
        ak.values[:, t], a.values[:, t] * keep**t, rtol=1e-6)


def test_analytic_bands_historical_and_rejections():
    import pytest

    from stock_market_monte_carlo_jax.ops import analytic

    h = smmc.HistoricalBootstrap.from_csv()
    qs = (0.25, 0.5, 0.75)
    t = 12
    a = smmc.simulate_bands(h, 1, t, quantile_levels=qs, sample_paths=0,
                            band_mode="analytic")
    vals, cdf = analytic.bootstrap_final_value_distribution(
        np.asarray(h.returns_pct, np.float64), t, 1000.0)
    oq = analytic.quantiles_from_cdf(vals, cdf, qs)
    np.testing.assert_allclose(a.values[:, t], oq, rtol=3e-4)
    with pytest.raises(ValueError, match="multiplicative"):
        smmc.simulate_bands(h, 1, t, band_mode="analytic",
                            strategy=FixedAmountWithdrawal(amount=1.0))
    with pytest.raises(ValueError, match="gaussian/historical"):
        smmc.simulate_bands(
            smmc.SobolGaussianReturns.create(n_periods=t), 1, t,
            band_mode="analytic")
