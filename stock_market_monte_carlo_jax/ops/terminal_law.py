"""Terminal-law sampler: draw V_T in ONE step from its exact law.

For iid-month multiplicative models (Gaussian or historical bootstrap,
optionally with a deterministic keep-fraction withdrawal schedule) the
final value is V_T = v0 * prod_t g_t * k_t, so log V_T is a T-fold
convolution of the single-month log-growth law shifted by sum_t log k_t.
That law is already computed to ~1e-6 quantile accuracy by the FFT
characteristic-function oracles (ops/analytic.final_value_distribution /
bootstrap_final_value_distribution) — which means the engine does not
have to LOOP the T months at all: precompute the quantile function
Q(z) = F^{-1}(Phi(z)) once on the host, fit it with a Chebyshev series
in z (log V_T is near-Gaussian in probit space, so a short series is
exact to float32 noise), and sample

    V = scale * exp( C(z / Z_MAX) ),   z ~ N(0, 1)

on device: one PRNG draw + one Clenshaw recurrence per PATH instead of
~T draws + T fused multiply chains. This is ~two orders of magnitude
less device work than the month-loop kernels at T=360 while sampling
the IDENTICAL distribution (up to the fit tolerance, validated here at
fit time with a float32 replica of the kernel arithmetic).

The reference has no analog — its benchmark table (README.md:66-75)
measures the month-loop kernels only — so this is an algorithmic
upgrade, exposed as ``EngineOptions(terminal_law=True)`` and excluded
from like-for-like baseline comparisons (bench.py keeps the month-loop
kernel as the headline).

Limits (enforced by the engine / this fit):
- needs the iid-month structure: counter-rng gaussian/historical models,
  multiplicative strategies with keep > 0 every month;
- per-path withdrawn totals are path-dependent and cannot be sampled
  from the terminal law (strategy runs require track_withdrawn=False);
- trajectories/bands are month-resolved products — terminal_law applies
  to simulate_stats / simulate_final_values surfaces only;
- discrete bootstrap laws at very short horizons are step functions a
  polynomial cannot represent: the fit validates itself against the
  oracle and raises when the tolerance cannot be met.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from stock_market_monte_carlo_jax.ops import analytic
from stock_market_monte_carlo_jax.ops.reductions import norm_icdf64

# Chebyshev domain half-width in z (probit) space. Draws are clamped to
# LAW_CLAMP (engine._law_finals_xla).
LAW_ZMAX = 6.25
LAW_CLAMP = 5.99
# Fixed operand length: [scale, c_0 .. c_{LAW_D-1}] — padded with zeros so
# every law reuses ONE compiled program (the coefficients are a runtime
# operand, never compile-time constants).
LAW_D = 48
LAW_OP_LEN = LAW_D + 1


@dataclasses.dataclass(frozen=True)
class TerminalLawFit:
    """Fitted quantile function V(z) = scale * exp(C(z / LAW_ZMAX)).

    ``coefs`` is the (LAW_D,) float32 Chebyshev series of
    log(V(z)/scale); its constant term is (near) zero because the
    midrange log-value is split into ``scale`` on the host in float64 —
    that keeps the float32 Clenshaw residual small regardless of v0.
    ``max_err`` is the measured sup|log error| of the float32 kernel
    replica against the FFT oracle over |z| <= LAW_CLAMP (~ relative
    value error).
    """

    scale: float
    coefs: np.ndarray
    max_err: float
    degree: int

    def operand(self) -> np.ndarray:
        """(LAW_OP_LEN,) float32 device operand: [scale, coefs...]."""
        return np.concatenate(
            [np.float32([self.scale]), self.coefs]
        ).astype(np.float32)

    def operand_device(self):
        """The operand as a device array, uploaded once per fit (fits
        are cached, so warm simulate_stats calls skip the host->device
        transfer entirely — it showed up at ~ms scale in the fused
        single-dispatch headline where everything else is ~tens of ms)."""
        dev = self.__dict__.get("_operand_device")
        if dev is None:
            import jax.numpy as jnp

            dev = jnp.asarray(self.operand())
            # frozen dataclass: cache via object.__setattr__
            object.__setattr__(self, "_operand_device", dev)
        return dev


def clenshaw_f32(coefs: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Float32 Clenshaw evaluation of a Chebyshev series — the exact
    arithmetic the device paths run (validation replica)."""
    c = np.asarray(coefs, np.float32)
    s = np.asarray(s, np.float32)
    two_s = np.float32(2.0) * s
    b1 = np.zeros_like(s)
    b2 = np.zeros_like(s)
    for k in range(len(c) - 1, 0, -1):
        b0 = two_s * b1 - b2 + c[k]
        b2 = b1
        b1 = b0
    return s * b1 - b2 + c[0]


def _qlog_of_z(values: np.ndarray, cdf: np.ndarray,
               z: np.ndarray) -> np.ndarray:
    """log-quantile of the (values, cdf) law at probit positions ``z``
    — probit-space linear interpolation on the oracle grid (the same
    convention as ops.reductions.cdf_band_quantiles)."""
    logv = np.log(values)
    mask = (cdf > 1e-300) & (cdf < 1.0 - 1e-16)
    c = cdf[mask]
    lv = logv[mask]
    keep = np.concatenate([[True], np.diff(c) > 0])
    c = c[keep]
    lv = lv[keep]
    if len(c) < 8:
        raise ValueError("terminal law oracle grid degenerate")
    zc = norm_icdf64(c)
    return np.interp(z, zc, lv)


_FIT_CACHE: dict = {}


def _law_cache_key(model, keep, n_periods: int, v0: float):
    """``keep``: the strategy's (T,) float64 keep factors, or None for
    no-withdrawal — computed ONCE by fit_terminal_law and shared between
    this key and the log-shift so the two can never diverge."""
    kind = model.kind
    if kind == "gaussian":
        params = (float(np.asarray(model.mean_pct)),
                  float(np.asarray(model.std_pct)))
    else:
        tbl = np.asarray(model.returns_pct, np.float64)
        params = hashlib.sha256(tbl.tobytes()).hexdigest()
    keep_key = (None if keep is None
                else hashlib.sha256(keep.tobytes()).hexdigest())
    return (kind, params, int(n_periods), float(v0), keep_key)


def fit_terminal_law(model, strategy, n_periods: int,
                     initial_capital: float,
                     tol: float = 2e-4) -> TerminalLawFit:
    """Fit the terminal-value quantile function for one run config.

    Raises ValueError when the float32 kernel replica cannot reproduce
    the FFT oracle to ``tol`` in log space over |z| <= LAW_CLAMP (e.g. a
    short-horizon bootstrap law, whose quantile function is a step
    function). Cached per (model params, strategy keep schedule, T, v0).
    Typical fitted error at T >= 60: ~1e-5 (the float32 Clenshaw noise
    floor); the engine's parity tests pin it (tests/test_terminal_law.py).
    """
    keep = None
    if strategy.kind != "none":
        # numpy twin: bit-identical f32 keep factors without the device
        # round trip the jnp version costs (engine._keep_factors_np)
        from stock_market_monte_carlo_jax.engine.engine import (
            _keep_factors_np,
        )

        keep = _keep_factors_np(strategy, n_periods).astype(np.float64)

    # tol is part of the key: a stricter-tol call must re-validate, not
    # inherit a fit that only passed a looser bar
    key = (_law_cache_key(model, keep, n_periods, initial_capital),
           float(tol))
    hit = _FIT_CACHE.get(key)
    if hit is not None:
        return hit

    log_shift = 0.0
    if keep is not None:
        if np.any(keep <= 0.0):
            raise ValueError(
                "terminal_law needs keep fractions > 0 every month "
                "(a 100% withdrawal makes every final exactly 0 — "
                "no law to sample); use the month-loop engine"
            )
        log_shift = float(np.log(keep).sum())

    if model.kind == "gaussian":
        values, cdf = analytic.final_value_distribution(
            float(np.asarray(model.mean_pct)),
            float(np.asarray(model.std_pct)),
            int(n_periods), float(initial_capital),
        )
    else:
        values, cdf = analytic.bootstrap_final_value_distribution(
            np.asarray(model.returns_pct, np.float64),
            int(n_periods), float(initial_capital),
        )

    # Chebyshev-Lobatto nodes over the full fit domain (8x oversampled
    # least squares at degree LAW_D-1 — well-conditioned at these sizes)
    n_nodes = 8 * LAW_D
    zs = LAW_ZMAX * np.cos(np.pi * np.arange(n_nodes) / (n_nodes - 1))
    q = _qlog_of_z(values, cdf, zs) + log_shift
    coef = np.polynomial.chebyshev.chebfit(zs / LAW_ZMAX, q, LAW_D - 1)

    # split the midrange level into a float64 host scale so the float32
    # residual series stays O(sigma_T * z) regardless of v0
    scale = float(np.exp(coef[0]))
    coef = coef.copy()
    coef[0] = 0.0
    coefs32 = coef.astype(np.float32)

    # validate the exact float32 device arithmetic against the oracle on
    # the reachable draw domain. The device computes
    # s = f32(z) * f32(1/LAW_ZMAX) (engine._law_finals_xla) — replicate
    # that exactly rather than the
    # up-to-1-ulp-different (z / LAW_ZMAX in f64).astype(f32)
    zval = np.linspace(-LAW_CLAMP, LAW_CLAMP, 4097)
    s32 = zval.astype(np.float32) * np.float32(1.0 / LAW_ZMAX)
    got = clenshaw_f32(coefs32, s32)
    want = (_qlog_of_z(values, cdf, zval) + log_shift) - np.log(scale)
    max_err = float(np.max(np.abs(got.astype(np.float64) - want)))
    if not np.isfinite(max_err) or max_err > tol:
        raise ValueError(
            f"terminal_law fit error {max_err:.2e} exceeds tol {tol:.0e} "
            f"for {model.kind} T={n_periods}: the terminal law is not "
            "smooth enough for a degree-47 Chebyshev quantile function "
            "(typical cause: a short-horizon bootstrap law, which is a "
            "step function) — use the month-loop engine instead"
        )

    # degree threshold is relative to the (dimensionless, log-space)
    # coefficient magnitudes — scale is in VALUE units and must not
    # enter (at v0=1e9 it would zero out every genuine coefficient)
    c_mag = float(np.max(np.abs(coefs32))) if coefs32.size else 0.0
    nz = np.nonzero(np.abs(coefs32) > 1e-7 * max(c_mag, 1e-30))[0]
    degree = int(nz[-1]) if len(nz) else 0
    fit = TerminalLawFit(scale=scale, coefs=coefs32, max_err=max_err,
                         degree=degree)
    _FIT_CACHE[key] = fit
    return fit
