"""Exact integer counts past the f32 range on multi-device merges.

Per-device chunks keep every count (n, count_below, histogram cells) an
exact integer in f32 because chunk_paths is capped at 2^24 (config
invariant — f32 represents every integer up to 2^24, and partial sums of
non-negative integer addends are monotone, so all intermediates stay
exact). A MESH dispatch merges up to n_dev * 2^24 counts, which exceeds
the f32-exact range: engine device_fn therefore psums count rows in
int32 and bitcasts the exact totals into the f32 stats lanes for
transport (decoded in engine._absorb), and psums histograms in int32.
This test pins that contract with an odd > 2^24 single-dispatch total
that f32 summation cannot represent (it would round to an even value).
"""

import jax
import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.parallel.mesh import paths_mesh

# 2^24 + 4097: odd, one dispatch on an 8-device mesh at 2^22-path chunks
N_PATHS = 2**24 + 4097


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8-device mesh")
def test_mesh_counts_exact_past_f32_range():
    mesh = paths_mesh()
    res = smmc.simulate_stats(
        smmc.GaussianReturns(),
        N_PATHS,
        n_periods=1,
        seed=3,
        target_amount=1e30,  # every final is below: count_below == n
        options=EngineOptions(chunk_paths=2**22),
        mesh=mesh,
    )
    # f32 would round the odd 16781313 to an even neighbour
    assert res.moments.n == N_PATHS
    assert res.count_below == N_PATHS
    assert int(res.histogram_counts.sum()) == N_PATHS
    assert np.isfinite(res.mean)


def test_chunk_paths_capped_at_f32_exact_range():
    with pytest.raises(ValueError, match="2\\*\\*24"):
        EngineOptions(chunk_paths=2**25)
    EngineOptions(chunk_paths=2**24)  # the cap itself is allowed
