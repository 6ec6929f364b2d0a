"""Randomized-QMC error estimation: replicated scrambles -> confidence
intervals.

A single QMC run has no usable internal error estimate (the empirical
variance of correlated low-discrepancy samples wildly overstates the
integration error — the whole point of QMC is that its points are NOT
independent). The standard remedy is replication: run R independent
randomizations of the SAME point set, treat the R replicate means as
i.i.d. draws of the randomized-QMC estimator, and build a Student-t
interval over them. With the digital-shift scrambling used here
(ops/sobol.digital_shift) each replicate mean is exactly unbiased, so
the interval is valid at any R >= 2 while converging at the QMC rate.

The reference vendors Sobol generators but never wires them into the
simulators (src/simulations.cu:136-137 TODO), let alone estimates QMC
error; this utility completes the framework's QMC story. For
pseudo-random models the same machinery degenerates to a plain batched
mean/CI (replicates are then just independent seed groups), which is a
useful cross-check but offers no rate advantage.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.models.strategies import NoWithdrawal

# Two-sided Student-t critical values t_{df, 1-(1-conf)/2} for the
# supported confidence levels, df = 1..30; beyond 30 the normal quantile
# is used (relative error < 1%). scipy is not a dependency, so the
# classic table is embedded (Abramowitz & Stegun table 26.10 values).
_T_TABLE = {
    0.90: (6.314, 2.920, 2.353, 2.132, 2.015, 1.943, 1.895, 1.860,
           1.833, 1.812, 1.796, 1.782, 1.771, 1.761, 1.753, 1.746,
           1.740, 1.734, 1.729, 1.725, 1.721, 1.717, 1.714, 1.711,
           1.708, 1.706, 1.703, 1.701, 1.699, 1.697),
    0.95: (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306,
           2.262, 2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120,
           2.110, 2.101, 2.093, 2.086, 2.080, 2.074, 2.069, 2.064,
           2.060, 2.056, 2.052, 2.048, 2.045, 2.042),
    0.99: (63.657, 9.925, 5.841, 4.604, 4.032, 3.707, 3.499, 3.355,
           3.250, 3.169, 3.106, 3.055, 3.012, 2.977, 2.947, 2.921,
           2.898, 2.878, 2.861, 2.845, 2.831, 2.819, 2.807, 2.797,
           2.787, 2.779, 2.771, 2.763, 2.756, 2.750),
}
_Z_NORMAL = {0.90: 1.6449, 0.95: 1.9600, 0.99: 2.5758}


def _t_critical(df: int, confidence: float) -> float:
    if confidence not in _T_TABLE:
        raise ValueError(
            f"confidence must be one of {sorted(_T_TABLE)}, got "
            f"{confidence}"
        )
    if df < 1:
        raise ValueError("need at least 2 replicates for an interval")
    tab = _T_TABLE[confidence]
    if df <= len(tab):
        return tab[df - 1]
    return _Z_NORMAL[confidence]


@dataclasses.dataclass(frozen=True)
class RqmcEstimate:
    """Replicated-randomization estimate of E[statistic(V_T)]."""

    mean: float                 # grand mean over replicates
    sem: float                  # standard error of the replicate means
    ci_lo: float
    ci_hi: float
    confidence: float
    replicate_means: np.ndarray  # (R,)
    n_paths_per_replicate: int

    def __str__(self):
        return (f"{self.mean:.6g} +/- {self.ci_hi - self.mean:.3g} "
                f"({100 * self.confidence:.0f}% CI, "
                f"{len(self.replicate_means)} replicates x "
                f"{self.n_paths_per_replicate} paths)")


def rqmc_estimate(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    replicates: int = 16,
    confidence: float = 0.95,
    statistic: str = "mean",
    target_amount: Optional[float] = None,
    options: EngineOptions = EngineOptions(),
    mesh=None,
) -> RqmcEstimate:
    """Mean and confidence interval from ``replicates`` independent
    randomizations of the same ``n_paths``-point run.

    Each replicate r runs with seed ``seed + r``: for Sobol models that
    re-randomizes the digital shift over the SAME sequence positions
    (proper RQMC — the replicate means converge at the QMC rate and the
    t-interval over them is exact-in-expectation); for pseudo-random
    models it is plain independent batching. ``statistic`` selects the
    estimand: "mean" (E[V_T]), "std", or "prob_below" (requires
    ``target_amount``). Total cost is replicates * n_paths paths.
    """
    from stock_market_monte_carlo_jax.engine.engine import simulate_stats

    if replicates < 2:
        raise ValueError("replicates must be >= 2 for an interval")
    if statistic not in ("mean", "std", "prob_below"):
        raise ValueError(
            f"statistic must be mean|std|prob_below, got {statistic!r}"
        )
    if statistic == "prob_below" and target_amount is None:
        raise ValueError("statistic='prob_below' needs target_amount")

    vals = np.empty(replicates, np.float64)
    for r in range(replicates):
        res = simulate_stats(
            model, n_paths, n_periods, initial_capital, seed + r,
            strategy, target_amount, options, mesh,
        )
        if statistic == "mean":
            vals[r] = res.moments.mean
        elif statistic == "std":
            vals[r] = res.moments.std
        else:
            vals[r] = res.moments.count_below / res.moments.n
    grand = float(vals.mean())
    sem = float(vals.std(ddof=1) / np.sqrt(replicates))
    t = _t_critical(replicates - 1, confidence)
    return RqmcEstimate(
        mean=grand, sem=sem, ci_lo=grand - t * sem, ci_hi=grand + t * sem,
        confidence=confidence, replicate_means=vals,
        n_paths_per_replicate=n_paths,
    )
