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

__all__ = [
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
]
