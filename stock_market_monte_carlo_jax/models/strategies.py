"""Withdrawal strategies — composable per-period update rules.

The reference lists these as an open TODO (README.md:130-133): take out a
fixed amount every period, a fixed percentage, or a varying percentage.
Here they are a first-class, jit-compatible hook applied after each month's
growth:

    V_{t+1} = clamp( V_t * g_t  -  withdrawal(V_t * g_t, t) , 0 )

where ``g_t = (100 + r_t) / 100`` is the month's growth factor. A depleted
fund stays at zero (no margin debt), and each strategy reports the total
amount withdrawn so the engine can expose income statistics.

Every strategy is an *affine* map ``V' = a_t * V + b_t`` in the fund value,
which keeps the whole month-update affine. The engine exploits this: the v1
(store-all-paths) engine can compute full trajectories with
``jax.lax.associative_scan`` over composed affine maps instead of a serial
scan when profitable.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np


def _validate_percent(p, what: str) -> None:
    """Reject percent outside [0, 100] when the value is concrete.

    percent > 100 would make the multiplicative keep factor negative (the
    fund would go short); percent == 100 is allowed and depletes exactly.
    Traced values (this runs again on pytree unflatten during jit) are
    skipped — validation happens at user construction time.
    """
    try:
        vals = np.asarray(p, dtype=np.float64)
    except Exception:
        return  # traced leaf — already validated at construction
    if vals.size and (np.any(vals < 0.0) or np.any(vals > 100.0)):
        raise ValueError(f"{what} must be within [0, 100], got {p}")


@partial(jax.tree_util.register_dataclass, data_fields=[], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class NoWithdrawal:
    """Pure compounding — the reference's only behavior."""

    kind = "none"

    def affine_step(self, t, growth):
        """Return (a, b) with V_{t+1} = a * (growth * V_t) + b."""
        del t
        return jnp.ones_like(growth), jnp.zeros_like(growth)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["amount"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class FixedAmountWithdrawal:
    """Withdraw a fixed currency amount every period (clamped at depletion)."""

    amount: Union[float, jax.Array]

    kind = "fixed_amount"

    def affine_step(self, t, growth):
        del t
        return (
            jnp.ones_like(growth),
            jnp.broadcast_to(
                -jnp.asarray(self.amount, jnp.float32), growth.shape
            ),
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["percent"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class FixedPercentWithdrawal:
    """Withdraw a fixed percentage of the fund every period."""

    percent: Union[float, jax.Array]

    kind = "fixed_percent"

    def __post_init__(self):
        _validate_percent(self.percent, "FixedPercentWithdrawal.percent")

    def affine_step(self, t, growth):
        del t
        keep = 1.0 - jnp.asarray(self.percent, jnp.float32) / 100.0
        return jnp.broadcast_to(keep, growth.shape), jnp.zeros_like(growth)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["percent_schedule"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class VariablePercentWithdrawal:
    """Withdraw percent_schedule[t] percent of the fund in period t.

    The schedule has length >= n_periods; schedules shorter than the horizon
    are an error at trace time.
    """

    percent_schedule: jax.Array

    kind = "variable_percent"

    def __post_init__(self):
        _validate_percent(
            self.percent_schedule, "VariablePercentWithdrawal schedule"
        )

    def affine_step(self, t, growth):
        sched = jnp.asarray(self.percent_schedule, jnp.float32)
        keep = 1.0 - sched[t] / 100.0
        return jnp.broadcast_to(keep, growth.shape), jnp.zeros_like(growth)


WithdrawalStrategy = Union[
    NoWithdrawal,
    FixedAmountWithdrawal,
    FixedPercentWithdrawal,
    VariablePercentWithdrawal,
]


def apply_month(strategy: WithdrawalStrategy, t, value, growth):
    """One month update: grow, withdraw, clamp at zero.

    ``value`` and ``growth`` are (paths,) or (paths_tile...) arrays; ``t`` is
    a traced scalar period index. Returns (new_value, withdrawn_amount).

    Semantics note: the clamp matters only for FIXED-AMOUNT withdrawals
    (a withdrawal can only take what is there; a depleted fund stays
    depleted), and every engine applies it there. MULTIPLICATIVE
    strategies (none / percent schedules) run as pure products in every
    engine path — so a month
    with growth <= 0 (a loss of 100% or more, reachable only for
    Gaussian models with extreme sigma) propagates its sign through the
    product exactly like the reference's unclamped ``update_fund``
    (src/simulations.cpp:14-16). The engine warns when a model makes
    such months non-negligible (engine._validate_run).
    """
    grown = value * growth
    a, b = strategy.affine_step(t, growth)
    after = a * grown + b
    # clamp: a depleted fund stays depleted, and a withdrawal can only take
    # what is there.
    new_value = jnp.maximum(after, 0.0)
    withdrawn = grown - new_value
    if isinstance(strategy, NoWithdrawal):
        withdrawn = jnp.zeros_like(new_value)
    return new_value, withdrawn
