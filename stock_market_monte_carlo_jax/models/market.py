"""Market models: where monthly percent returns come from.

The reference has two return sources — a Gaussian sampler
(src/simulations.cpp:41-55) and an i.i.d. bootstrap from the historical
S&P500 monthly-return table (src/simulations.cpp:95-112; on GPU, a xorshift
draw indexing a ``__shared__`` copy of the table, src/simulations.cu:144-150)
— plus vendored Sobol generators that were never wired into the simulators
(src/simulations.cu:136-137 has the TODO). Here all four combinations are
first-class models with a single interface.

Models are JAX pytrees: array fields (the returns table, Sobol direction
numbers) travel as traced leaves; scalars are leaves too so one compiled
executable serves any mean/std. ``kind`` is static metadata used by the
engine to pick the right fused kernel.

Semantics notes (kept deliberately identical to the reference):
- returns are in *percent per month*; the update is
  ``V *= (100 + r) / 100`` (src/simulations.cpp:14-16). The GPU kernel
  instead pre-scales the table by 0.01 and uses ``V += V * r_frac``
  (src/simulations.cu:126,148) — algebraically the same.
- bootstrap sampling is i.i.d. uniform over table rows, with replacement.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from stock_market_monte_carlo_jax.config import (
    DEFAULT_GAUSSIAN_MEAN_PCT,
    DEFAULT_GAUSSIAN_STD_PCT,
)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["mean_pct", "std_pct"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class GaussianReturns:
    """Monthly returns ~ N(mean_pct, std_pct), in percent.

    Defaults match the reference's hard-coded market config
    (examples/monte_carlo_simulated.cpp:11-13).
    """

    mean_pct: Union[float, jax.Array] = DEFAULT_GAUSSIAN_MEAN_PCT
    std_pct: Union[float, jax.Array] = DEFAULT_GAUSSIAN_STD_PCT

    kind = "gaussian"
    is_quasi = False

    def sample_returns_pct(self, key: jax.Array, shape) -> jax.Array:
        return (
            jnp.asarray(self.mean_pct, jnp.float32)
            + jnp.asarray(self.std_pct, jnp.float32)
            * jax.random.normal(key, shape, dtype=jnp.float32)
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["returns_pct"],
    meta_fields=["rng"],
)
@dataclasses.dataclass(frozen=True)
class HistoricalBootstrap:
    """i.i.d. bootstrap (with replacement) from a monthly-returns table.

    ``returns_pct`` is the `returns` column of the S&P500 CSV, in percent
    (reference loader: src/simulations.cpp:83-93).

    ``rng`` selects the bit stream:
      - "counter" (default): counter-based threefry streams keyed by
        global tile — reproducible and sharding-invariant.
      - "reference": the reference GPU kernel's exact per-path recipe —
        state0 = rand_pcg(path_id + 1), then one xorshift step per month
        (src/simulations.cu:140-150) — as a cross-implementation parity
        mode. Path p draws the same *bit stream* in the engine and the
        jnp ports in ops/rng.py, bit-identical to the CUDA kernel. The
        u32 -> table-row map uses the exact integer form
        floor(n * u32 / 2^32); the CUDA kernel computes the same map in
        float32 (src/simulations.cu:148), whose 24-bit rounding selects a
        neighboring row for ~1e-4 of draws — so row indices/finals are
        parity-equivalent in distribution, not bit-for-bit vs CUDA.
    """

    returns_pct: jax.Array
    rng: str = "counter"

    kind = "historical"
    is_quasi = False

    @classmethod
    def from_csv(cls, path=None, rng: str = "counter") -> "HistoricalBootstrap":
        from stock_market_monte_carlo_jax.data.loader import (
            read_historical_returns,
        )

        return cls(
            returns_pct=jnp.asarray(read_historical_returns(path)), rng=rng
        )

    def sample_returns_pct(self, key: jax.Array, shape) -> jax.Array:
        table = jnp.asarray(self.returns_pct, jnp.float32)
        idx = jax.random.randint(key, shape, 0, table.shape[0])
        return table[idx]

    def sample_returns_pct_reference(self, path_offset, shape) -> jax.Array:
        """Reference-recipe draws for global paths
        [path_offset, path_offset+B) — see class docstring."""
        from stock_market_monte_carlo_jax.ops import rng as rng_ops

        b, t = shape
        table = jnp.asarray(self.returns_pct, jnp.float32)
        gids = (jnp.asarray(path_offset, jnp.uint32)
                + jnp.arange(b, dtype=jnp.uint32))
        bits = rng_ops.xorshift_stream(gids + jnp.uint32(1), t)
        idx = rng_ops.bootstrap_index_exact(bits, table.shape[0])
        return table[idx]


def _sobol_uniforms(direction, path_offset, shape, scramble_key,
                    index_offset: int = 0):
    """(paths, periods) low-discrepancy uniforms; dim = period index."""
    from stock_market_monte_carlo_jax.ops.sobol import sobol_points_f32

    n_paths, n_periods = shape
    return sobol_points_f32(
        direction, path_offset, n_paths, n_periods, scramble_key,
        index_offset,
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["mean_pct", "std_pct", "direction"],
    meta_fields=["index_offset"],
)
@dataclasses.dataclass(frozen=True)
class SobolGaussianReturns:
    """Gaussian model driven by Sobol quasi-random points.

    Each month is one Sobol dimension; each path one sequence index; uniforms
    map to normals via the inverse CDF. This *upgrades* the reference, which
    vendored Sobol (include/sobol_joekuo/sobol.cc:74-166) but never wired it
    into a simulator. Points are Owen-style digit-scrambled per seed so
    repeated runs give unbiased error estimates.

    ``index_offset`` (static, < 2^62) positions the run deeper in the
    sequence — the reference i8_sobol's 64-bit index depth
    (include/sobol/sobol.cpp:14191). Nonzero offsets use a (dims, 64)
    direction table (create(..., index_offset=...) builds it).
    """

    direction: jax.Array  # (dims, 32) or (dims, 64) uint32 directions
    mean_pct: Union[float, jax.Array] = DEFAULT_GAUSSIAN_MEAN_PCT
    std_pct: Union[float, jax.Array] = DEFAULT_GAUSSIAN_STD_PCT
    index_offset: int = 0

    kind = "sobol_gaussian"
    is_quasi = True

    @classmethod
    def create(cls, n_periods, mean_pct=DEFAULT_GAUSSIAN_MEAN_PCT,
               std_pct=DEFAULT_GAUSSIAN_STD_PCT,
               index_offset: int = 0) -> "SobolGaussianReturns":
        from stock_market_monte_carlo_jax.ops.sobol import (
            direction_numbers,
            direction_numbers_hi32,
        )

        table = (direction_numbers_hi32(n_periods) if index_offset
                 else direction_numbers(n_periods))
        return cls(
            direction=jnp.asarray(table),
            mean_pct=mean_pct,
            std_pct=std_pct,
            index_offset=index_offset,
        )

    def sample_returns_pct_quasi(self, scramble_key, path_offset, shape):
        from stock_market_monte_carlo_jax.ops.normal import normal_icdf

        u = _sobol_uniforms(self.direction, path_offset, shape,
                            scramble_key, self.index_offset)
        z = normal_icdf(u)
        return (
            jnp.asarray(self.mean_pct, jnp.float32)
            + jnp.asarray(self.std_pct, jnp.float32) * z
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["returns_pct", "direction"],
    meta_fields=["index_offset"],
)
@dataclasses.dataclass(frozen=True)
class SobolHistoricalBootstrap:
    """Historical bootstrap driven by Sobol points: idx = floor(u * n)."""

    returns_pct: jax.Array
    direction: jax.Array
    index_offset: int = 0

    kind = "sobol_historical"
    is_quasi = True

    @classmethod
    def create(cls, returns_pct, n_periods,
               index_offset: int = 0) -> "SobolHistoricalBootstrap":
        from stock_market_monte_carlo_jax.ops.sobol import (
            direction_numbers,
            direction_numbers_hi32,
        )

        table = (direction_numbers_hi32(n_periods) if index_offset
                 else direction_numbers(n_periods))
        return cls(
            returns_pct=jnp.asarray(returns_pct, jnp.float32),
            direction=jnp.asarray(table),
            index_offset=index_offset,
        )

    def sample_returns_pct_quasi(self, scramble_key, path_offset, shape):
        from stock_market_monte_carlo_jax.ops.rng import (
            bootstrap_index_exact,
        )
        from stock_market_monte_carlo_jax.ops.sobol import sobol_bits_u32

        table = jnp.asarray(self.returns_pct, jnp.float32)
        n_paths, n_periods = shape
        # EXACT integer index map on the raw Sobol words (not on rounded
        # f32 uniforms)
        bits = sobol_bits_u32(self.direction, path_offset, n_paths,
                              n_periods, scramble_key, self.index_offset)
        idx = bootstrap_index_exact(bits, table.shape[0])
        return table[idx]


MarketModel = Union[
    GaussianReturns,
    HistoricalBootstrap,
    SobolGaussianReturns,
    SobolHistoricalBootstrap,
]
