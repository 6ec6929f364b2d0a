"""Sharded runs on the 8-device mesh equal single-device runs.

Streams are keyed by global path position, so every model kind, strategy
and sampler must give per-path finals that are BIT-identical on the mesh
and on one device, identical histograms and counts (merged by int32
psum), and moments equal to float reassociation of the f32 device sums.
tests/test_sharding.py covers the Gaussian month loop's basics; this file
is the matrix over model kinds, strategies and samplers, plus ragged
counts, chunk sizes and seed segments.
"""

import dataclasses

import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.engine import KEY_TILE
from stock_market_monte_carlo_jax.models.strategies import (
    FixedPercentWithdrawal,
    NoWithdrawal,
)

T = 6
N = 2 * 8 * KEY_TILE + 777          # two dispatches, ragged tail
OPTS = EngineOptions(chunk_paths=KEY_TILE)


def _model(kind):
    table = smmc.HistoricalBootstrap.from_csv().returns_pct
    return {
        "gaussian": lambda: smmc.GaussianReturns(),
        "historical": lambda: smmc.HistoricalBootstrap(table),
        "historical_reference": lambda: smmc.HistoricalBootstrap(
            table, rng="reference"),
        "sobol_gaussian": lambda: smmc.SobolGaussianReturns.create(
            n_periods=T),
        "sobol_historical": lambda: smmc.SobolHistoricalBootstrap.create(
            table, n_periods=T),
    }[kind]()


STRATEGIES = {
    "none": NoWithdrawal(),
    "fixed_percent": FixedPercentWithdrawal(0.5),
}


def _assert_identical(single, sharded, rtol=1e-6):
    np.testing.assert_array_equal(sharded.final_values, single.final_values)
    np.testing.assert_array_equal(sharded.histogram_counts,
                                  single.histogram_counts)
    a, b = sharded.moments, single.moments
    assert a.n == b.n
    assert a.count_below == b.count_below
    assert a.min == b.min and a.max == b.max
    np.testing.assert_allclose([a.mean, a.std], [b.mean, b.std], rtol=rtol)


def _both(model, mesh, n=N, opts=OPTS, strategy=NoWithdrawal(), seed=3):
    kw = dict(initial_capital=1000.0, seed=seed, strategy=strategy,
              target_amount=1005.0, options=opts, keep_final_values=True)
    return (smmc.simulate_stats(model, n, T, **kw),
            smmc.simulate_stats(model, n, T, mesh=mesh, **kw))


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("kind", ["gaussian", "historical",
                                  "historical_reference", "sobol_gaussian",
                                  "sobol_historical"])
def test_month_loop_sharded_equals_single(mesh8, kind, strategy):
    single, sharded = _both(_model(kind), mesh8,
                            strategy=STRATEGIES[strategy])
    _assert_identical(single, sharded)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("kind", ["gaussian", "historical"])
def test_terminal_law_sharded_equals_single(mesh8, kind, strategy):
    opts = dataclasses.replace(OPTS, terminal_law=True,
                               track_withdrawn=False)
    single, sharded = _both(_model(kind), mesh8, opts=opts,
                            strategy=STRATEGIES[strategy])
    _assert_identical(single, sharded)


@pytest.mark.parametrize("n", [1, KEY_TILE - 1, 8 * KEY_TILE + 1])
def test_ragged_counts_sharded_equals_single(mesh8, n):
    single, sharded = _both(_model("historical"), mesh8, n=n)
    _assert_identical(single, sharded)
    assert sharded.moments.n == n


@pytest.mark.parametrize("sampler", ["month", "law"])
@pytest.mark.parametrize("chunk", [KEY_TILE, 2 * KEY_TILE])
def test_chunk_size_invariance_sharded(mesh8, chunk, sampler):
    """The mesh run at any chunk size equals the single-device run at the
    default chunk size, path for path."""
    base = EngineOptions(terminal_law=sampler == "law")
    single, _ = _both(_model("historical"), mesh8, opts=base)
    _, sharded = _both(_model("historical"), mesh8,
                       opts=dataclasses.replace(base, chunk_paths=chunk))
    _assert_identical(single, sharded)


@pytest.mark.parametrize("sampler", ["month", "law"])
def test_seed_segments_sharded_equals_single(mesh8, sampler):
    """Three seed segments (shrunk to two mesh dispatches each) with a
    ragged tail: per-segment streams are keyed the same way on the mesh."""
    opts = dataclasses.replace(OPTS, seed_segment_paths=16 * KEY_TILE,
                               terminal_law=sampler == "law")
    single, sharded = _both(_model("historical"), mesh8,
                            n=40 * KEY_TILE + 321, opts=opts)
    _assert_identical(single, sharded)
