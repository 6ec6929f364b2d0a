"""Reference-PRNG parity mode: the reference GPU kernel's exact stream.

``HistoricalBootstrap(rng="reference")`` replays the reference CUDA
kernel's recipe (state0 = rand_pcg(path_id+1), one xorshift per month,
src/simulations.cu:140-150). These tests pin the engine to an
independent pure-Python implementation.
"""

import jax.numpy as jnp
import numpy as np

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.ops import rng as r

M32 = 0xFFFFFFFF


def _py_stream_final(path_id, table, t, v0=1000.0):
    def pcg(x):
        word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
        return ((word >> 22) ^ word) & M32

    def xs(y):
        y ^= (y << 11) & M32
        y &= M32
        y ^= y >> 7
        y ^= y >> 12
        return y & M32

    st = pcg((path_id + 1) & M32)
    total = np.float32(v0)
    n = len(table)
    for _ in range(t):
        st = xs(st)
        idx = (n * st) >> 32  # exact integer mapping
        total = np.float32(total * np.float32((100.0 + table[idx]) / 100.0))
    return total


def test_bootstrap_index_exact_matches_integer_math():
    bits = np.asarray([0, 1, 12345, 0x80000000, M32], np.uint32)
    got = np.asarray(r.bootstrap_index_exact(jnp.asarray(bits), 1127))
    want = [(1127 * int(b)) >> 32 for b in bits]
    np.testing.assert_array_equal(got, want)


def test_reference_rng_engine_matches_python(historical_table):
    t = 12
    model = smmc.HistoricalBootstrap(
        jnp.asarray(historical_table), rng="reference"
    )
    finals = smmc.simulate_final_values(model, 64, t, seed=0)
    table = np.asarray(historical_table, np.float32)
    for pid in (0, 1, 7, 63):
        want = _py_stream_final(pid, table, t)
        assert abs(finals[pid] - want) / want < 1e-6, pid


def test_reference_rng_is_seed_independent(historical_table):
    """The reference recipe keys off path id only (its CPU engines seed
    from the clock; the GPU kernel from tid — deterministic per id)."""
    model = smmc.HistoricalBootstrap(
        jnp.asarray(historical_table), rng="reference"
    )
    a = smmc.simulate_final_values(model, 256, 6, seed=0)
    b = smmc.simulate_final_values(model, 256, 6, seed=99)
    np.testing.assert_array_equal(a, b)


def test_reference_rng_statistics_match_counter_rng(historical_table):
    """Both streams must produce the same final-value distribution."""
    t, n = 60, 200_000
    ref = smmc.simulate_stats(
        smmc.HistoricalBootstrap(jnp.asarray(historical_table),
                                 rng="reference"), n, t, seed=0,
    )
    ctr = smmc.simulate_stats(
        smmc.HistoricalBootstrap(jnp.asarray(historical_table)), n, t,
        seed=0,
    )
    se = ctr.std / np.sqrt(n)
    assert abs(ref.mean - ctr.mean) < 5 * se
    assert abs(ref.std - ctr.std) / ctr.std < 0.02


def test_single_period_bootstrap_chi_square():
    """T=1 finals expose the raw sampled table entry: chi-square the
    frequency of every table row (catches index-mapping or padding bugs
    anywhere in the sampling pipeline). Uses an integer-spaced probe
    table so each final maps back to its row index exactly: r_k = k
    percent -> final = 1000*(100+k)/100 ~ 1000 + 10k, spacing 10 >> ulp.
    Same 1127-row size as the S&P table (src/simulations.cu:123)."""
    n = 400_000
    n_table = 1127
    probe = np.arange(n_table, dtype=np.float32)
    model = smmc.HistoricalBootstrap(jnp.asarray(probe))
    finals = smmc.simulate_final_values(model, n, 1, 1000.0, seed=5)
    idx = np.rint((finals - 1000.0) / 10.0).astype(np.int64)
    assert idx.min() >= 0 and idx.max() == n_table - 1
    counts = np.bincount(idx, minlength=n_table)
    assert counts.sum() == n
    expected = n / n_table
    chi2 = ((counts - expected) ** 2 / expected).sum()
    dof = n_table - 1
    assert chi2 < dof + 6 * np.sqrt(2 * dof), chi2


def test_single_period_reference_rng_chi_square():
    """Same probe through the reference-recipe stream."""
    n = 400_000
    n_table = 1127
    probe = np.arange(n_table, dtype=np.float32)
    model = smmc.HistoricalBootstrap(jnp.asarray(probe), rng="reference")
    finals = smmc.simulate_final_values(model, n, 1, 1000.0, seed=0)
    idx = np.rint((finals - 1000.0) / 10.0).astype(np.int64)
    counts = np.bincount(idx, minlength=n_table)
    expected = n / n_table
    chi2 = ((counts - expected) ** 2 / expected).sum()
    dof = n_table - 1
    assert chi2 < dof + 6 * np.sqrt(2 * dof), chi2
