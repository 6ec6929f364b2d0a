from stock_market_monte_carlo_jax.data.loader import (
    default_returns_path,
    read_historical_returns,
)

__all__ = ["read_historical_returns", "default_returns_path"]
