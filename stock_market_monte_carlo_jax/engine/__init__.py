from stock_market_monte_carlo_jax.engine.engine import (
    run,
    simulate_final_values,
    simulate_paths,
    simulate_stats,
)
from stock_market_monte_carlo_jax.engine.results import SimulationResult

__all__ = [
    "run",
    "simulate_final_values",
    "simulate_paths",
    "simulate_stats",
    "SimulationResult",
]
