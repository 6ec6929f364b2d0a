from stock_market_monte_carlo_jax.parallel.mesh import (
    paths_mesh,
    device_count,
)

__all__ = ["paths_mesh", "device_count"]
