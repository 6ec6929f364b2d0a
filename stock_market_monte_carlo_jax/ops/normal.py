"""Normal-distribution math kit.

Covers the reference's host-side analytic helpers — ``normalCDF`` via erfc,
the Abramowitz–Stegun CND approximation, normal PDF, inverse CDF, and
quantiles-from-mean/std (reference: examples/benchmark_mc_gpu_reduceBlock.cpp:
28-70 and examples/visualize_distribution.cpp:68-151) — re-expressed as
vectorized jnp functions usable on device and on host.

``normal_icdf`` doubles as the sampler primitive: it maps uniforms (pseudo or
Sobol) to normals with a single transcendental (one log), cheaper than
Box–Muller's log+sqrt+sincos, and is the only way to preserve the
low-discrepancy structure of quasi-random points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SQRT2 = 1.4142135623730951
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def normal_cdf(x, mean=0.0, std=1.0):
    """Phi((x-mean)/std) via erfc — matches the reference's ``normalCDF``
    (benchmark_mc_gpu_reduceBlock.cpp:28-31)."""
    z = (x - mean) / std
    return 0.5 * jax.lax.erfc(-z * _INV_SQRT2)


def normal_cdf_abramowitz_stegun(d):
    """The reference's ``cumulative_normal_standard`` polynomial CND
    (benchmark_mc_gpu_reduceBlock.cpp:33-52), kept for parity experiments.

    Abramowitz & Stegun 26.2.17, |error| < 7.5e-8.
    """
    d = jnp.asarray(d)
    a1, a2, a3 = 0.31938153, -0.356563782, 1.781477937
    a4, a5 = -1.821255978, 1.330274429
    k = 1.0 / (1.0 + 0.2316419 * jnp.abs(d))
    poly = k * (a1 + k * (a2 + k * (a3 + k * (a4 + k * a5))))
    cnd = _INV_SQRT_2PI * jnp.exp(-0.5 * d * d) * poly
    return jnp.where(d > 0, 1.0 - cnd, cnd)


def normal_pdf(x, mean=0.0, std=1.0):
    """Normal density (reference: ``normal``,
    benchmark_mc_gpu_reduceBlock visualize_distribution.cpp:114-118)."""
    a = (x - mean) / std
    return _INV_SQRT_2PI / std * jnp.exp(-0.5 * a * a)


def truncated_normal_cdf_left(x, mean, std, lo):
    """CDF of a normal truncated to [lo, inf) — the reference's
    truncated-left CDF (visualize_returns_distribution_gpu_reduceBlock.cpp:
    105-112), used when mass below a floor is discarded."""
    num = normal_cdf(x, mean, std) - normal_cdf(lo, mean, std)
    den = 1.0 - normal_cdf(lo, mean, std)
    return jnp.clip(num / den, 0.0, 1.0)


def erfinv_f32(x):
    """Single-precision inverse error function (Giles-style polynomial).

    Branch-free piecewise polynomial in w = -log(1-x^2): ~9 FMAs plus one
    log for the central region; the deep-tail branch adds a sqrt. Replaces
    the reference's RationalApproximation/NormalCDFInverse host code
    (benchmark_mc_gpu_reduceBlock path, visualize_distribution.cpp:120-143)
    with something that runs at VPU speed.
    """
    x = jnp.asarray(x, jnp.float32)
    w = -jnp.log1p(-(x * x))

    wc = w - 2.5
    p_c = jnp.float32(2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164,
              0.246640727, 1.50140941):
        p_c = jnp.float32(c) + p_c * wc

    wt = jnp.sqrt(jnp.maximum(w, 1e-30)) - 3.0
    p_t = jnp.float32(-0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682):
        p_t = jnp.float32(c) + p_t * wt

    return jnp.where(w < 5.0, p_c, p_t) * x


def normal_icdf(u, mean=0.0, std=1.0):
    """Inverse normal CDF (quantile function) of uniform(0,1) inputs.

    Clamps u away from {0,1} at the float32 resolution so the hardware-RNG
    convention u in [0,1) never produces inf.
    """
    u = jnp.asarray(u, jnp.float32)
    # 1 - eps must be representable below 1.0f (f32 gap at 1.0 is ~6e-8)
    eps = jnp.float32(1e-7)
    u = jnp.clip(u, eps, jnp.float32(1.0) - eps)
    z = _SQRT2 * erfinv_f32(2.0 * u - 1.0)
    return mean + std * z


def quantiles_from_mean_std(qs, mean, std):
    """Normal-approximation quantiles from summary stats (reference:
    visualize_distribution.cpp:145-153)."""
    return mean + std * normal_icdf(jnp.asarray(qs, jnp.float32))


def count_below_clt(target, mean, std, n):
    """CLT estimate of #paths below target from mean/std alone — the
    reference's ``update_count_below_min`` on the reduceBlock path
    (benchmark_mc_gpu_reduceBlock.cpp:65-70). The reference itself notes the
    final-value distribution is skewed, so this is an approximation; the
    engine also offers the exact on-device count."""
    return n * normal_cdf(target, mean, std)
