"""Monte Carlo stock-market simulator in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``matthijsvk/stock_market_monte_carlo`` (C++/CUDA): Monte Carlo simulation
of long-term portfolio evolution where monthly returns are drawn from a
Gaussian model, bootstrapped from historical S&P500 monthly returns, or
generated by Sobol quasi-Monte-Carlo — compounded over hundreds of months
across up to billions of independent paths.

Architecture:

- one simulation path <-> one element of a (paths, months) chunk; the
  reference's per-thread loop <-> a fused XLA program per chunk.
- per-thread xorshift/PCG state <-> counter-based RNG keyed by *global*
  tile index, so results are reproducible across shardings (the reference
  is non-reproducible by construction, src/simulations.cpp:45,100).
- the ``reduceBlock`` per-block mean/variance kernel
  (src/simulations.cu:185-247) <-> on-device chunk reductions merged with
  exact float64 combination on the host (the reference's
  mean-of-block-means merge is biased for ragged blocks; ours is exact).
- multi-GPU async streaming (src/simulations.cu:559-655) <-> ``shard_map``
  over a ``jax.sharding.Mesh`` path axis with ``psum`` merges; only final
  statistics leave the device.
"""

from stock_market_monte_carlo_jax.utils import compile_cache as _cc

_cc.enable()

from stock_market_monte_carlo_jax.config import (  # noqa: E402
    EngineOptions,
    SimulationConfig,
)
from stock_market_monte_carlo_jax.models.market import (
    GaussianReturns,
    HistoricalBootstrap,
    MarketModel,
    SobolGaussianReturns,
    SobolHistoricalBootstrap,
)
from stock_market_monte_carlo_jax.models.strategies import (
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
    WithdrawalStrategy,
)
from stock_market_monte_carlo_jax.engine.engine import (
    StreamUpdate,
    simulate,
    simulate_final_values,
    simulate_paths,
    simulate_stats,
    run,
)
from stock_market_monte_carlo_jax.engine.bands import (
    TrajectoryBands,
    simulate_bands,
)
from stock_market_monte_carlo_jax.engine.results import SimulationResult
from stock_market_monte_carlo_jax.engine.rqmc import (
    RqmcEstimate,
    rqmc_estimate,
)
from stock_market_monte_carlo_jax.data.loader import (
    read_historical_returns,
    default_returns_path,
)

__version__ = "0.1.0"

__all__ = [
    "EngineOptions",
    "SimulationConfig",
    "MarketModel",
    "GaussianReturns",
    "HistoricalBootstrap",
    "SobolGaussianReturns",
    "SobolHistoricalBootstrap",
    "WithdrawalStrategy",
    "NoWithdrawal",
    "FixedAmountWithdrawal",
    "FixedPercentWithdrawal",
    "VariablePercentWithdrawal",
    "StreamUpdate",
    "simulate",
    "simulate_final_values",
    "simulate_paths",
    "simulate_stats",
    "run",
    "SimulationResult",
    "TrajectoryBands",
    "simulate_bands",
    "RqmcEstimate",
    "rqmc_estimate",
    "read_historical_returns",
    "default_returns_path",
]
