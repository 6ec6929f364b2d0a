"""Checkpoint/resume: interrupted runs continue with identical results."""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine import checkpoint as ckpt
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE

GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)
OPTS = EngineOptions(chunk_paths=KEY_TILE)


def test_checkpoint_resume_identical(tmp_path):
    n, t = 4 * KEY_TILE, 24
    path = str(tmp_path / "run.ckpt.npz")

    # interrupted run: progress callback raises after 2 chunks
    class Stop(Exception):
        pass

    calls = []

    def interrupt(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise Stop()

    with pytest.raises(Stop):
        smmc.simulate_stats(
            GAUSS, n, t, seed=3, options=OPTS, checkpoint_path=path,
            progress=interrupt, target_amount=1200.0,
        )

    resumed = smmc.simulate_stats(
        GAUSS, n, t, seed=3, options=OPTS, checkpoint_path=path,
        target_amount=1200.0,
    )
    fresh = smmc.simulate_stats(
        GAUSS, n, t, seed=3, options=OPTS, target_amount=1200.0,
    )
    assert resumed.moments.n == n
    np.testing.assert_allclose(resumed.mean, fresh.mean, rtol=1e-12)
    np.testing.assert_allclose(resumed.std, fresh.std, rtol=1e-10)
    assert resumed.count_below == fresh.count_below
    np.testing.assert_array_equal(
        resumed.histogram_counts, fresh.histogram_counts
    )


def test_completed_checkpoint_short_circuits(tmp_path):
    n, t = 2 * KEY_TILE, 12
    path = str(tmp_path / "run.ckpt.npz")
    first = smmc.simulate_stats(
        GAUSS, n, t, seed=1, options=OPTS, checkpoint_path=path,
    )
    again = smmc.simulate_stats(
        GAUSS, n, t, seed=1, options=OPTS, checkpoint_path=path,
    )
    np.testing.assert_allclose(first.mean, again.mean, rtol=1e-12)
    assert again.moments.n == n


def test_fingerprint_mismatch_refuses(tmp_path):
    n, t = KEY_TILE, 12
    path = str(tmp_path / "run.ckpt.npz")
    smmc.simulate_stats(GAUSS, n, t, seed=1, options=OPTS,
                        checkpoint_path=path)
    with pytest.raises(ValueError, match="different run"):
        smmc.simulate_stats(GAUSS, n, t, seed=2, options=OPTS,
                            checkpoint_path=path)
    with pytest.raises(ValueError, match="different run"):
        smmc.simulate_stats(GAUSS, n, 13, seed=1, options=OPTS,
                            checkpoint_path=path)


def test_checkpoint_rejects_keep_finals(tmp_path):
    with pytest.raises(ValueError, match="keep_final_values"):
        smmc.simulate_stats(
            GAUSS, KEY_TILE, 4, options=OPTS,
            checkpoint_path=str(tmp_path / "c.npz"),
            keep_final_values=True,
        )


def test_checkpoint_state_roundtrip(tmp_path):
    path = str(tmp_path / "s.npz")
    st = ckpt.CheckpointState(
        fingerprint="ab" * 32, next_offset=12345, paths_done=999,
        stats=np.arange(9, dtype=np.float64),
        hist=np.arange(16, dtype=np.float64),
    )
    ckpt.save(path, st)
    back = ckpt.load(path, "ab" * 32)
    assert back.next_offset == 12345
    assert back.paths_done == 999
    np.testing.assert_array_equal(back.stats, st.stats)
    np.testing.assert_array_equal(back.hist, st.hist)
    assert ckpt.load(str(tmp_path / "missing.npz"), "x") is None


def test_checkpoint_cross_topology_resume(tmp_path, mesh8):
    """Checkpoint on an 8-device mesh, resume single-device with a different
    chunk size: the fingerprint is topology-free (counter-based RNG makes
    chunks/shards independent of execution history) and results match."""
    n, t = 4 * 8 * KEY_TILE, 12
    path = str(tmp_path / "run.ckpt.npz")

    class Stop(Exception):
        pass

    calls = []

    def interrupt(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise Stop()

    with pytest.raises(Stop):
        smmc.simulate_stats(
            GAUSS, n, t, seed=3, options=OPTS, mesh=mesh8,
            checkpoint_path=path, progress=interrupt, target_amount=1500.0,
        )
    resumed = smmc.simulate_stats(
        GAUSS, n, t, seed=3,
        options=EngineOptions(chunk_paths=2 * KEY_TILE),
        checkpoint_path=path, target_amount=1500.0,
    )
    fresh = smmc.simulate_stats(
        GAUSS, n, t, seed=3, options=OPTS, target_amount=1500.0,
    )
    assert resumed.moments.n == n
    # float32 partial sums reassociate across the different chunk split;
    # per-path finals (hence histogram and count) are bit-identical
    np.testing.assert_allclose(resumed.mean, fresh.mean, rtol=1e-6)
    # centered power sums (engine.analytic_moment_shift) keep the
    # variance extraction well-conditioned across the different chunk
    # split — the old uncentered floor was 1e-4
    np.testing.assert_allclose(resumed.std, fresh.std, rtol=1e-6)
    assert resumed.count_below == fresh.count_below
    np.testing.assert_array_equal(
        resumed.histogram_counts, fresh.histogram_counts
    )


def test_histogram_mode_fingerprint_guard(tmp_path):
    """A checkpoint written with histograms must refuse to resume into a
    histogram=False run (the merged zero counts would silently corrupt
    the final histogram) — the /nohist fingerprint tag guards it."""
    n, t = KEY_TILE, 6
    path = str(tmp_path / "run.ckpt.npz")
    smmc.simulate_stats(GAUSS, n, t, seed=1, options=OPTS,
                        checkpoint_path=path)
    with pytest.raises(ValueError, match="different run"):
        smmc.simulate_stats(
            GAUSS, n, t, seed=1,
            options=EngineOptions(chunk_paths=KEY_TILE, histogram=False),
            checkpoint_path=path,
        )


def test_model_static_fields_fingerprinted(tmp_path):
    """Pytree META fields change the sampled bit stream but are invisible
    to tree_leaves: HistoricalBootstrap.rng and Sobol index_offset must
    refuse cross-resume (they used to be omitted from the fingerprint,
    silently mixing partial sums from two different streams)."""
    import dataclasses

    n, t = KEY_TILE, 4
    h_counter = smmc.HistoricalBootstrap.from_csv()
    h_reference = smmc.HistoricalBootstrap.from_csv(rng="reference")
    path = str(tmp_path / "hist.ckpt.npz")
    smmc.simulate_stats(h_counter, n, t, seed=1, options=OPTS,
                        checkpoint_path=path)
    with pytest.raises(ValueError, match="different run"):
        smmc.simulate_stats(h_reference, n, t, seed=1, options=OPTS,
                            checkpoint_path=path)

    s0 = smmc.SobolGaussianReturns.create(n_periods=t)
    s1 = dataclasses.replace(s0, index_offset=1 << 20)
    spath = str(tmp_path / "sobol.ckpt.npz")
    smmc.simulate_stats(s0, n, t, seed=1, options=OPTS,
                        checkpoint_path=spath)
    with pytest.raises(ValueError, match="different run"):
        smmc.simulate_stats(s1, n, t, seed=1, options=OPTS,
                            checkpoint_path=spath)
