"""Device histograms (ops/histogram.py) against np.bincount: exact
integer counts for ragged sizes, out-of-range indices dropped, and the
engine's padding marker discarded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stock_market_monte_carlo_jax.ops import histogram as hist_ops


def _counts(idx, n_total):
    fn = jax.jit(hist_ops.histogram_counts, static_argnums=(1,))
    return np.asarray(fn(jnp.asarray(idx, jnp.int32), n_total))


@pytest.mark.parametrize("n", [1, 777, 65536, 65537, 200_003])
def test_histogram_matches_bincount(n):
    rng = np.random.default_rng(n)
    # concentrated like real final values: most mass in a few hot bins
    idx = np.clip(rng.normal(2048, 60, n).astype(np.int64), 0, 4095)
    np.testing.assert_array_equal(_counts(idx, 4096),
                                  np.bincount(idx, minlength=4096))


@pytest.mark.parametrize("n_total", [1, 17, 4096])
def test_out_of_range_indices_dropped(n_total):
    rng = np.random.default_rng(n_total)
    idx = rng.integers(-5, n_total + 5, size=10_000)
    keep = idx[(idx >= 0) & (idx < n_total)]
    np.testing.assert_array_equal(_counts(idx, n_total),
                                  np.bincount(keep, minlength=n_total))


def test_padding_marker_discarded():
    """The engine marks padding paths with index n_bins + 2 — one past
    the last cell — which must count nowhere."""
    n_cells = 4096
    idx = np.concatenate([np.arange(n_cells), np.full(1000, n_cells)])
    got = _counts(idx, n_cells)
    np.testing.assert_array_equal(got, np.ones(n_cells))


def test_histogram_exact_at_2pow24_in_one_bin():
    """Counts stay exact up to the 2^24-path chunk cap (f32 integers)."""
    idx = jnp.zeros((1 << 24,), jnp.int32)
    got = _counts(idx, 8)
    assert got[0] == float(1 << 24) and got[1:].sum() == 0


@pytest.mark.parametrize("shape", [(1, 1), (777, 13), (8192, 61)])
def test_month_histogram_matches_bincount(shape):
    b, t = shape
    n_cells = 258
    rng = np.random.default_rng(b)
    idx = rng.integers(0, n_cells + 1, size=(b, t))   # n_cells = discard
    fn = jax.jit(hist_ops.month_histogram_counts, static_argnums=(1,))
    got = np.asarray(fn(jnp.asarray(idx, jnp.int32), n_cells))
    want = np.stack([np.bincount(idx[:, m][idx[:, m] < n_cells],
                                 minlength=n_cells) for m in range(t)])
    np.testing.assert_array_equal(got, want)
