"""Exact integer histograms of bin indices on device: a scatter-add
(``jax.ops.segment_sum``) of ones into the bins.

Counts are float32 and exact while every cell stays below 2^24 (the
per-chunk path cap, config.py). Out-of-range indices — the engine marks
padding paths with one past the last cell — are dropped.

On one H100 (80 GB HBM3, 700 W power limit) the scatter beat the
alternative bf16 one-hot matrix-product form in every measured case
(PERF.md): 3.0 ms against 16.3 ms for 2^24 final-value indices into
4,096 bins, and 1.8 ms against 25.6 ms for a 245,760 x 361 per-month band
histogram.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def histogram_counts(bin_idx: jax.Array, n_total: int) -> jax.Array:
    """(n_total,) float32 counts of each bin in [0, n_total)."""
    flat = bin_idx.ravel().astype(jnp.int32)
    flat = jnp.where((flat < 0) | (flat >= n_total), n_total, flat)
    return jax.ops.segment_sum(
        jnp.ones_like(flat, jnp.float32), flat, num_segments=n_total + 1
    )[:n_total]


def month_histogram_counts(idx: jax.Array, n_cells: int) -> jax.Array:
    """(T, n_cells) float32 per-month counts of idx (B, T): one
    scatter-add into month-major cells."""
    _, t = idx.shape
    idx = idx.astype(jnp.int32)
    live = (idx >= 0) & (idx < n_cells)
    cell = jnp.arange(t, dtype=jnp.int32)[None, :] * n_cells + idx
    cell = jnp.where(live, cell, t * n_cells)
    counts = jax.ops.segment_sum(
        jnp.ones_like(cell, jnp.float32).ravel(), cell.ravel(),
        num_segments=t * n_cells + 1,
    )
    return counts[:t * n_cells].reshape(t, n_cells)
