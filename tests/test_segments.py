"""Seed segmentation: n_paths beyond EngineOptions.seed_segment_paths.

simulate_stats partitions oversized runs into fixed seed segments, each
with an independent counter-rng stream (engine._segment_keys; segment 0
= the plain seed key), lifting the uint32 global-path-offset cap that
previously forced manual seed splitting (the pattern the round-4 scale
drill used for 1e10 paths). The production segment size is 2^31 —
untestable directly on CPU — so these tests shrink it to a few RNG
tiles, exercising the identical boundary/key/merge logic.

The reference has no notion of any of this: its GPU runs are capped by
device memory and its seeding is non-reproducible by construction
(src/simulations.cpp:45,100: clock/random_device seeds).
"""

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE

KT = KEY_TILE
SEG = 2 * KT
GAUSS = smmc.GaussianReturns(mean_pct=0.5, std_pct=10.0 / 12)


def opts(**kw):
    kw.setdefault("chunk_paths", KT)
    kw.setdefault("seed_segment_paths", SEG)
    return EngineOptions(**kw)


def test_segment_zero_prefix_matches_unsegmented_stream():
    """Segment 0 runs under the plain seed key: the first SEG finals of
    a segmented run equal an unsegmented run of SEG paths bit for bit,
    and the next segment draws genuinely fresh paths (no repeats)."""
    n = SEG + KT
    seg_run = smmc.simulate_stats(GAUSS, n, 12, seed=9, options=opts(),
                                  keep_final_values=True)
    plain = smmc.simulate_stats(GAUSS, SEG, 12, seed=9,
                                options=opts(seed_segment_paths=1 << 31),
                                keep_final_values=True)
    np.testing.assert_array_equal(seg_run.final_values[:SEG],
                                  plain.final_values)
    assert not np.array_equal(seg_run.final_values[SEG:SEG + KT],
                              seg_run.final_values[:KT])
    assert seg_run.moments.n == n


def test_segmented_chunk_and_fuse_invariance():
    """Segment boundaries are fixed path positions, so results are
    invariant to chunk size and fuse_chunks exactly like within-segment
    chunking (histograms bitwise; moments to reduction-order rounding
    of the on-device f32 sums)."""
    n = 2 * SEG + 3000  # ragged tail inside segment 2
    base = smmc.simulate_stats(GAUSS, n, 10, seed=4, target_amount=1200.0,
                               options=opts(fuse_chunks=0))
    variants = [
        opts(fuse_chunks=4),
        opts(chunk_paths=2 * KT, fuse_chunks=0),  # chunk == segment
        opts(chunk_paths=2 * KT, fuse_chunks=2),
    ]
    for o in variants:
        r = smmc.simulate_stats(GAUSS, n, 10, seed=4, target_amount=1200.0,
                                options=o)
        assert r.moments.n == n
        np.testing.assert_array_equal(r.histogram_counts,
                                      base.histogram_counts)
        assert r.count_below == base.count_below
        np.testing.assert_allclose(r.mean, base.mean, rtol=1e-9)
        np.testing.assert_allclose(r.std, base.std, rtol=1e-7)


def test_segmented_historical_terminal_law():
    """The law operand is seed-independent and shared across segments;
    the drawn normals re-key per segment. Composition: a segmented law
    run merges to the same histogram mass and sane moments."""
    hist = smmc.HistoricalBootstrap.from_csv()
    n = SEG + KT + 777
    o = opts(terminal_law=True)
    r = smmc.simulate_stats(hist, n, 120, seed=3, target_amount=2000.0,
                            options=o)
    assert r.moments.n == n
    assert r.histogram_counts.sum() == n
    # law mean ~ exact analytic mean of the bootstrap month loop
    table = np.asarray(hist.returns_pct, np.float64)
    exact = 1000.0 * (1.0 + table.mean() / 100.0) ** 120
    np.testing.assert_allclose(r.mean, exact, rtol=0.05)


@pytest.mark.parametrize("kill_at", [SEG, SEG + KT])
def test_checkpoint_resume_across_segment_boundary(tmp_path, kill_at):
    """SIGKILL-equivalent interruption exactly at / one chunk past the
    segment boundary; resume re-derives (segment, offset) from the
    exact valid count and finishes bit-compatibly with an uninterrupted
    control."""
    n = SEG + 2 * KT
    path = str(tmp_path / "seg.ckpt.npz")

    class Stop(Exception):
        pass

    def interrupt(done, total):
        if done >= kill_at:
            raise Stop()

    with pytest.raises(Stop):
        smmc.simulate_stats(GAUSS, n, 12, seed=3, options=opts(),
                            checkpoint_path=path, progress=interrupt,
                            target_amount=1100.0)
    resumed = smmc.simulate_stats(GAUSS, n, 12, seed=3, options=opts(),
                                  checkpoint_path=path,
                                  target_amount=1100.0)
    fresh = smmc.simulate_stats(GAUSS, n, 12, seed=3, options=opts(),
                                target_amount=1100.0)
    assert resumed.moments.n == n
    np.testing.assert_array_equal(resumed.histogram_counts,
                                  fresh.histogram_counts)
    assert resumed.count_below == fresh.count_below
    np.testing.assert_allclose(resumed.mean, fresh.mean, rtol=1e-12)
    np.testing.assert_allclose(resumed.std, fresh.std, rtol=1e-10)
    assert resumed.moments.min == fresh.moments.min
    assert resumed.moments.max == fresh.moments.max


def test_segmented_checkpoint_fingerprint_guards_segment_size(tmp_path):
    """A checkpoint written under one seed_segment_paths must refuse to
    resume under another (different stream family)."""
    n = SEG + KT
    path = str(tmp_path / "seg.ckpt.npz")

    class Stop(Exception):
        pass

    def interrupt(done, total):
        if done >= KT:
            raise Stop()

    with pytest.raises(Stop):
        smmc.simulate_stats(GAUSS, n, 8, seed=1, options=opts(),
                            checkpoint_path=path, progress=interrupt)
    with pytest.raises(ValueError, match="fingerprint"):
        smmc.simulate_stats(
            GAUSS, n, 8, seed=1, checkpoint_path=path,
            options=opts(seed_segment_paths=4 * KT),
        )


def test_segmented_mesh_matches_single_device(mesh8):
    """Sharded segmented run == single-device segmented run (the
    boundary cap distributes a partial dispatch across devices via the
    same valid-mask path as the run-end tail)."""
    n = SEG + 3 * KT + 999
    a = smmc.simulate_stats(GAUSS, n, 8, seed=2, target_amount=1150.0,
                            options=opts())
    b = smmc.simulate_stats(GAUSS, n, 8, seed=2, target_amount=1150.0,
                            options=opts(), mesh=mesh8)
    assert b.moments.n == n
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    assert a.count_below == b.count_below
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-6)
    np.testing.assert_allclose(a.std, b.std, rtol=1e-6)
    assert a.moments.min == b.moments.min
    assert a.moments.max == b.moments.max


def test_reference_rng_refuses_segmentation():
    """Reference-parity streams are keyed by global path id alone
    (src/simulations.cu:140) — a fresh segment would repeat segment 0's
    paths verbatim, so the engine must refuse rather than silently
    produce duplicated samples."""
    hist = smmc.HistoricalBootstrap.from_csv(rng="reference")
    with pytest.raises(ValueError, match="reference-parity"):
        smmc.simulate_stats(hist, SEG + 1, 6, options=opts())


def test_sobol_ignores_segmentation():
    """Quasi models keep their documented split mechanism (index_offset
    over the 2^62 sequence): a tiny seed_segment_paths must not alter a
    Sobol run."""
    m = smmc.SobolGaussianReturns.create(n_periods=8)
    a = smmc.simulate_stats(m, SEG + KT, 8, seed=5, options=opts())
    b = smmc.simulate_stats(
        m, SEG + KT, 8, seed=5,
        options=opts(seed_segment_paths=1 << 31),
    )
    assert a.moments == b.moments
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)


def test_segment_options_validation():
    with pytest.raises(ValueError, match="seed_segment_paths"):
        EngineOptions(seed_segment_paths=1000)
    with pytest.raises(ValueError, match="headroom"):
        smmc.simulate_stats(
            GAUSS, (1 << 32) + 8192, 1,
            options=EngineOptions(seed_segment_paths=1 << 32),
        )
