"""Bootstrap table lookups: every model draw is a plain ``table[idx]``
gather of the exact integer row index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stock_market_monte_carlo_jax as smmc
from stock_market_monte_carlo_jax.ops import rng as rng_ops


def test_table_lookup_dispatch_cpu():
    # the counter-rng bootstrap draw is the gather of its randint indices
    table = jnp.arange(10, dtype=jnp.float32)
    model = smmc.HistoricalBootstrap(returns_pct=table)
    key = jax.random.key(3)
    got = model.sample_returns_pct(key, (2, 5))
    idx = jax.random.randint(key, (2, 5), 0, 10)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(table[idx]))


@pytest.mark.parametrize("n_table", [1127, 1128, 128, 100, 5])
def test_reference_rng_draws_are_exact_table_rows(n_table):
    """rng='reference' gathers row floor(n * u32 / 2^32) of the xorshift
    stream: bit-exact with a numpy gather of the same integer map."""
    rng = np.random.default_rng(n_table)
    table = rng.normal(0.5, 4.0, n_table).astype(np.float32)
    model = smmc.HistoricalBootstrap(returns_pct=jnp.asarray(table),
                                     rng="reference")
    got = np.asarray(model.sample_returns_pct_reference(jnp.uint32(40),
                                                        (257, 12)))
    gids = np.arange(40, 40 + 257, dtype=np.uint32)
    bits = np.asarray(rng_ops.xorshift_stream(jnp.asarray(gids + 1), 12))
    idx = (bits.astype(np.uint64) * n_table) >> np.uint64(32)
    np.testing.assert_array_equal(got, table[idx.astype(np.int64)])
