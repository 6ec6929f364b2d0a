"""Fused multi-chunk dispatch (EngineOptions.fuse_chunks).

When nothing consumes per-chunk results (the deferred-absorb condition),
the engine batches up to ``fuse_chunks`` chunks into ONE device dispatch —
a ``lax.scan`` over the identical chunk body that stacks the per-chunk
(stats, histogram) rows (engine._get_chunk_fn fuse_g). The host then runs
the same float64 merges in the same order, so every statistic must be
BIT-IDENTICAL to unfused per-chunk dispatch. Rationale: each dispatch
pays a fixed host cost, which dominates chunks whose device time is
small (terminal law).

The reference has no analog (its async launcher still launches one kernel
per block batch, src/simulations.cu:576-655); this is dispatch-overhead
amortization native to the XLA compilation model.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE

GAUSS = smmc.GaussianReturns()


def _identical(a, b):
    np.testing.assert_array_equal(a.histogram_counts, b.histogram_counts)
    assert a.moments == b.moments  # dataclass eq: every derived stat
    assert a.count_below == b.count_below
    assert a.n_paths == b.n_paths


# 11 chunks + ragged tail: with fuse_chunks=8 this dispatches one full
# 8-block plus one exact-length 4-block (ragged tail masked inside it) —
# both the streaming block size and the exact-tail block in one run
N_RAGGED = 11 * KEY_TILE + 137


@pytest.mark.parametrize("model_name", ["gaussian", "historical"])
def test_fused_bit_identical_to_unfused(model_name, historical_table):
    model = (GAUSS if model_name == "gaussian"
             else smmc.HistoricalBootstrap(jnp.asarray(historical_table)))
    kw = dict(n_periods=13, seed=9, target_amount=1500.0)
    fused = smmc.simulate_stats(
        model, N_RAGGED,
        options=EngineOptions(chunk_paths=KEY_TILE, fuse_chunks=8), **kw
    )
    unfused = smmc.simulate_stats(
        model, N_RAGGED,
        options=EngineOptions(chunk_paths=KEY_TILE, fuse_chunks=0), **kw
    )
    _identical(fused, unfused)


def test_fused_terminal_law_identity():
    kw = dict(n_periods=120, seed=3, target_amount=2000.0)
    base = EngineOptions(chunk_paths=KEY_TILE, terminal_law=True)
    fused = smmc.simulate_stats(
        GAUSS, N_RAGGED, options=base, **kw
    )
    unfused = smmc.simulate_stats(
        GAUSS, N_RAGGED,
        options=dataclasses.replace(base, fuse_chunks=0), **kw
    )
    _identical(fused, unfused)


def test_fused_mesh_identity(mesh8, historical_table):
    """Fused dispatch under shard_map: the per-chunk merges run inside
    the scan body, so the sharded fused run must equal BOTH the sharded
    unfused run and the single-device fused run (chunk/shard invariance of
    the counter-keyed streams is preserved by construction — offsets are
    per-chunk-per-device exactly as in unfused dispatch)."""
    model = smmc.HistoricalBootstrap(jnp.asarray(historical_table))
    n = 3 * 8 * KEY_TILE + 17  # 4 mesh chunks (one exact-length fused
    #                            block of 4; the 17-path rag masked in it)
    kw = dict(n_periods=7, seed=5, target_amount=1500.0)
    opts = EngineOptions(chunk_paths=KEY_TILE)
    sharded_fused = smmc.simulate_stats(
        model, n, options=opts, mesh=mesh8, **kw
    )
    sharded_unfused = smmc.simulate_stats(
        model, n,
        options=dataclasses.replace(opts, fuse_chunks=0), mesh=mesh8, **kw
    )
    single = smmc.simulate_stats(model, n, options=opts, **kw)
    _identical(sharded_fused, sharded_unfused)
    np.testing.assert_array_equal(sharded_fused.histogram_counts,
                                  single.histogram_counts)
    assert sharded_fused.count_below == single.count_below
    assert sharded_fused.moments.n == single.moments.n
    np.testing.assert_allclose(sharded_fused.mean, single.mean, rtol=1e-6)


def test_fused_histogram_off_and_no_target():
    kw = dict(n_periods=11, seed=2)
    base = EngineOptions(chunk_paths=KEY_TILE, histogram=False)
    fused = smmc.simulate_stats(GAUSS, N_RAGGED, options=base, **kw)
    unfused = smmc.simulate_stats(
        GAUSS, N_RAGGED,
        options=dataclasses.replace(base, fuse_chunks=0), **kw
    )
    assert fused.moments == unfused.moments
    assert fused.histogram_counts is None


def test_fuse_knob_validation():
    for bad in (-1, 3, 6, 65, 128):
        with pytest.raises(ValueError, match="fuse_chunks"):
            EngineOptions(fuse_chunks=bad)
    for ok in (0, 1, 2, 32, 64):
        EngineOptions(fuse_chunks=ok)


def test_fused_not_used_with_per_chunk_consumers():
    """progress/stream/checkpoint/keep_finals force per-chunk dispatch;
    results must still match the fused fast path (the two code paths
    produce the same rows — this pins the gate doesn't change results)."""
    seen = []
    kw = dict(n_periods=9, seed=4, target_amount=1500.0)
    opts = EngineOptions(chunk_paths=KEY_TILE)
    with_cb = smmc.simulate_stats(
        GAUSS, N_RAGGED, options=opts,
        progress=lambda d, t: seen.append(d), **kw
    )
    assert len(seen) >= 12  # one per chunk + final: the slow path ran
    fused = smmc.simulate_stats(GAUSS, N_RAGGED, options=opts, **kw)
    _identical(fused, with_cb)


def test_whole_run_is_one_fused_dispatch():
    """Round 5: a run of <= fuse_chunks chunks must execute as ONE
    fused block of exactly chunks_left scan steps (the 100M headline's
    dispatch shape) — pinned by inspecting the chunk-fn cache keys the
    run creates (fuse_g is the last key element)."""
    from stock_market_monte_carlo_jax.engine import engine as eng

    n = 6 * KEY_TILE + 137  # 7 chunks, ragged tail
    opts = EngineOptions(chunk_paths=KEY_TILE)
    before = set(eng._CHUNK_FN_CACHE)
    res = smmc.simulate_stats(GAUSS, n, 9, seed=13, options=opts)
    created = [k for k in eng._CHUNK_FN_CACHE if k not in before]
    fuse_gs = sorted(k[-1] for k in created)
    assert fuse_gs == [7], fuse_gs  # one fused fn, exact length, no g=1
    assert res.moments.n == n
