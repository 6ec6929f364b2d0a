"""The simulation engine: chunked, jitted, shardable.

Capabilities mirror the reference's three engine families, re-designed for
XLA's compilation model:

- ``simulate_paths``    — v1 "keepdata" semantics (full trajectories; CPU:
  src/simulations.cpp:139-202). Compounding is a parallel prefix product
  (``cumprod``), not a serial loop, for all multiplicative strategies.
- ``simulate_final_values`` — v2 final-only semantics (src/simulations.cpp:
  204-266; GPU kernel src/simulations.cu:112-152). A single product
  reduction per path.
- ``simulate_stats``    — the ``reduceBlock`` idea taken to its limit
  (src/simulations.cu:185-247): moments + histogram + count-below are
  accumulated on device and only ~4 KB of statistics ever reach the host,
  for any number of paths.

Large runs stream through fixed-shape *chunks*: the host dispatch loop plays
the role of the reference's multi-GPU async launcher (src/simulations.cu:
576-655) — JAX's async dispatch overlaps chunk k+1's compute with chunk k's
result fetch — and doubles as the progress counter. With a
``jax.sharding.Mesh``, each chunk is ``shard_map``-ped over the path axis
and per-device statistics are merged with ``psum`` between devices, so the
host is never a data hub (unlike the reference, where the CPU shuttles
every buffer, src/simulations.cu:615-626).

RNG is counter-based and keyed by global path position (see ops/rng.py):
the same seed gives the same statistics on 1 device or many.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.engine.results import SimulationResult
from stock_market_monte_carlo_jax.models.market import (
    GaussianReturns,
    SobolGaussianReturns,
)
from stock_market_monte_carlo_jax.models.strategies import (
    FixedPercentWithdrawal,
    NoWithdrawal,
    VariablePercentWithdrawal,
    apply_month,
)
from stock_market_monte_carlo_jax.ops import histogram as hist_ops
from stock_market_monte_carlo_jax.ops import rng as rng_ops
from stock_market_monte_carlo_jax.ops import reductions as red

KEY_TILE = rng_ops.KEY_TILE

# deferred-absorb queue bound: flush (one stacked fetch + f64 merges)
# every N chunks so device memory stays O(N), not O(n_chunks) — a 1e12-
# path run is ~60k chunks whose queued histograms would hold ~1 GB
_DEFER_FLUSH_CHUNKS = 256

# fold_in tag for seed-segment root keys (segment s >= 1 uses
# fold_in(key(seed), _SEG_FOLD + s)); disjoint by construction from the
# 0x50B0 scramble fold and small user data values
_SEG_FOLD = 0x5E6C0000

# ---------------------------------------------------------------------------
# Host-side analytics used to place histogram bins.
# ---------------------------------------------------------------------------


_GAUSS_LGM_CACHE: dict = {}


def log_growth_moments(model) -> Tuple[float, float]:
    """(mean, std) of log((100+r)/100) under the model, computed on host.

    Gaussian models use 201-node Gauss–Hermite quadrature (exact to fp
    precision for this smooth integrand); bootstrap models compute the exact
    discrete moments of the table. The Gaussian branch is cached per
    (mean, std): generating the 201 quadrature nodes costs milliseconds
    of host time on every call otherwise.
    """
    if isinstance(model, (GaussianReturns, SobolGaussianReturns)):
        mean = float(np.asarray(model.mean_pct))
        std = float(np.asarray(model.std_pct))
        hit = _GAUSS_LGM_CACHE.get((mean, std))
        if hit is not None:
            return hit
        z, w = np.polynomial.hermite_e.hermegauss(201)
        g = mean + std * z
        g = np.clip(g, -99.99, None)
        f = np.log((100.0 + g) / 100.0)
        w = w / w.sum()
        mu = float(np.sum(w * f))
        var = float(np.sum(w * f * f) - mu * mu)
        out = (mu, float(np.sqrt(max(var, 1e-30))))
        if len(_GAUSS_LGM_CACHE) > 256:  # unbounded-growth guard
            _GAUSS_LGM_CACHE.clear()
        _GAUSS_LGM_CACHE[(mean, std)] = out
        return out
    table = np.asarray(model.returns_pct, np.float64)
    f = np.log((100.0 + np.clip(table, -99.99, None)) / 100.0)
    mu = float(f.mean())
    var = float(f.var())
    return mu, float(np.sqrt(max(var, 1e-30)))


def analytic_moment_shift(model, strategy, n_periods: int) -> float:
    """The v0-normalized analytic mean E[V_T]/v0 — the centering constant
    for the device power sums.

    Accumulating moments of d = V/v0 - c instead of V/v0 makes the
    variance extraction s2/n - mean^2 well-conditioned: uncentered, the
    f32 device sums carry mean^2/var ~ 40-600x more magnitude than the
    variance they must resolve, which amplified reassociation noise to a
    1e-4 std parity floor (ROADMAP item 7). The shift is exact for i.i.d.
    multiplicative compounding: E[V_T]/v0 = prod_t E[g_t]*keep_t with
    E[g] = 1 + mean/100 (Gaussian r, linear expectation) or the exact
    discrete mean of the bootstrap growth table. Non-multiplicative
    strategies (fixed_amount) have no closed form -> shift 0 (unshifted,
    the old behavior). The host converts shifted sums back to raw power
    sums in float64 per chunk (engine._absorb), so the packed layout,
    checkpoint format and MomentSummary are unchanged.
    """
    if not _is_multiplicative(strategy):
        return 0.0
    if isinstance(model, (GaussianReturns, SobolGaussianReturns)):
        g = 1.0 + float(np.asarray(model.mean_pct)) / 100.0
    else:
        table = np.asarray(model.returns_pct, np.float64)
        g = float(1.0 + table.mean() / 100.0)
    # host-side numpy keep factors: no device round trip per call
    keep = _keep_factors_np(strategy, n_periods).astype(np.float64)
    with np.errstate(over="ignore", under="ignore"):
        c = float(g ** n_periods * np.prod(keep))
    if not np.isfinite(c):
        return 0.0
    # keep c (and c^4 in the f64 host reconstruction) comfortably finite;
    # shifts beyond f32 range mean the values themselves overflow anyway
    return float(np.clip(c, 0.0, 1e30))


def make_histogram_spec(model, strategy, n_periods: int,
                        initial_capital: float,
                        n_bins: int) -> red.HistogramSpec:
    mu, sigma = log_growth_moments(model)
    if isinstance(strategy, (FixedPercentWithdrawal,
                             VariablePercentWithdrawal)):
        # multiplicative strategies shift the final-value log-center by
        # the MEAN per-month log-keep (exactly log(keep) for the fixed
        # case — unchanged; for variable schedules omitting this pushed
        # a sustained schedule's entire mass into the underflow bin).
        # Clamp so percent == 100 (keep == 0, all finals exactly 0)
        # still yields a valid log-spaced spec; zeros land in the
        # underflow bin.
        if isinstance(strategy, FixedPercentWithdrawal):
            pct = np.float64(np.asarray(strategy.percent))
        else:
            pct = np.asarray(strategy.percent_schedule,
                             np.float64)[:n_periods]
        keep = np.clip(1.0 - pct / 100.0, 1e-6, None)
        mu += float(np.mean(np.log(keep)))
    spec = red.default_histogram_spec(
        initial_capital, n_periods, mu, sigma, n_bins
    )
    if not isinstance(strategy, NoWithdrawal):
        # Withdrawals can drive funds toward zero; widen the low end. The
        # underflow bin still catches fully depleted paths exactly. Floor
        # lo into float32-representable range: a sub-float32 lo casts to
        # 0.0f in bin_index, so the v < lo underflow test would miss exact
        # zeros and misfile them in the overflow bin (extreme keep
        # fractions push the analytic center below 1e-38).
        lo = max(min(spec.lo, initial_capital * 1e-6 + 1e-30), 1e-30)
        hi = max(spec.hi, lo * 1e6)
        spec = red.HistogramSpec(lo=lo, hi=hi, n_bins=n_bins)
    return spec


# ---------------------------------------------------------------------------
# Traced building blocks.
# ---------------------------------------------------------------------------


def sample_growth(model, root_key, scramble_key, path_offset, shape):
    """(B, T) growth factors (100 + r)/100 for global paths
    [path_offset, path_offset + B). ``B`` must be a KEY_TILE multiple for
    pseudo-random models (sharding invariance)."""
    b, t = shape
    if model.is_quasi:
        r = model.sample_returns_pct_quasi(scramble_key, path_offset, shape)
    elif getattr(model, "rng", "counter") == "reference":
        r = model.sample_returns_pct_reference(path_offset, shape)
    else:
        # Always sample at KEY_TILE granularity: draws for global path p
        # then depend only on (seed, p // KEY_TILE, p % KEY_TILE), never on
        # chunk size, device count, or entry point (v1 vs v2).
        kt = KEY_TILE
        assert b % kt == 0, (b, kt)
        first_tile = (jnp.asarray(path_offset, jnp.uint32)
                      // jnp.uint32(kt))
        keys = rng_ops.path_tile_keys(root_key, first_tile, b // kt)
        r = jax.vmap(
            lambda k: model.sample_returns_pct(k, (kt, t))
        )(keys).reshape(b, t)
    return (jnp.float32(100.0) + r) * jnp.float32(0.01)


def _is_multiplicative(strategy) -> bool:
    return isinstance(
        strategy,
        (NoWithdrawal, FixedPercentWithdrawal, VariablePercentWithdrawal),
    )


def _keep_factors(strategy, n_periods: int):
    """(T,) multiplicative keep-fraction per period, for multiplicative
    strategies."""
    if isinstance(strategy, NoWithdrawal):
        return jnp.ones((n_periods,), jnp.float32)
    if isinstance(strategy, FixedPercentWithdrawal):
        keep = 1.0 - jnp.asarray(strategy.percent, jnp.float32) / 100.0
        return jnp.full((n_periods,), 1.0, jnp.float32) * keep
    sched = jnp.asarray(strategy.percent_schedule, jnp.float32)
    if sched.shape[0] < n_periods:
        # the class contract (strategies.VariablePercentWithdrawal):
        # schedules shorter than the horizon are an error, never a
        # silent keep=1.0 fill — the month-loop engines fail on the
        # shape mismatch, and the terminal-law path takes this slice
        raise ValueError(
            f"percent_schedule has {sched.shape[0]} entries but the run "
            f"has n_periods={n_periods}; provide a schedule covering "
            "every period"
        )
    return 1.0 - sched[:n_periods] / 100.0


def _keep_factors_np(strategy, n_periods: int) -> np.ndarray:
    """Numpy twin of :func:`_keep_factors` for HOST-side analytics.

    The jnp version materializes a device array, and pulling it back to
    the host (``np.asarray``) costs a device round trip, paid by
    ``analytic_moment_shift`` on every ``simulate_stats`` call. Must
    keep the same f32 keep-fraction rounding as the device path: keep
    values are computed in float32 exactly as the jnp twin does, then
    widened — so host analytics see bit-identical keep factors.
    """
    if isinstance(strategy, NoWithdrawal):
        return np.ones((n_periods,), np.float32)
    if isinstance(strategy, FixedPercentWithdrawal):
        keep = np.float32(1.0) - np.float32(strategy.percent) / np.float32(
            100.0)
        return np.full((n_periods,), keep, np.float32)
    sched = np.asarray(strategy.percent_schedule, np.float32)
    if sched.shape[0] < n_periods:
        raise ValueError(
            f"percent_schedule has {sched.shape[0]} entries but the run "
            f"has n_periods={n_periods}; provide a schedule covering "
            "every period"
        )
    return (np.float32(1.0) - sched[:n_periods] / np.float32(100.0))


def compound_final(growth, v0, strategy):
    """(B,) final values and (B,) total withdrawn from (B, T) growth."""
    b, t = growth.shape
    v0 = jnp.asarray(v0, jnp.float32)
    if _is_multiplicative(strategy):
        gk = growth * _keep_factors(strategy, t)[None, :]
        finals = v0 * jnp.prod(gk, axis=1)
        if isinstance(strategy, NoWithdrawal):
            withdrawn = jnp.zeros((b,), jnp.float32)
        else:
            # Withdrawn in period t is grown_t * (1-keep_t) where grown_t is
            # the value after growth but before the withdrawal:
            # grown_t = v0 * prod_{s<t}(gk_s) * g_t — the cumprod shifted one
            # period. No division, so keep == 0 (100% withdrawal) is exact.
            run = jnp.cumprod(gk, axis=1)
            prev = jnp.concatenate(
                [jnp.ones((b, 1), jnp.float32), run[:, :-1]], axis=1
            )
            keep = _keep_factors(strategy, t)[None, :]
            grown = v0 * prev * growth
            withdrawn = jnp.sum(grown * (1.0 - keep), axis=1)
        return finals, withdrawn

    def body(carry, x):
        value, wsum = carry
        g, idx = x
        value, dw = apply_month(strategy, idx, value, g)
        return (value, wsum + dw), None

    init = (jnp.full((b,), v0, jnp.float32), jnp.zeros((b,), jnp.float32))
    (finals, withdrawn), _ = jax.lax.scan(
        body, init, (growth.T, jnp.arange(t))
    )
    return finals, withdrawn


def compound_paths(growth, v0, strategy):
    """(B, T+1) trajectories (month 0 = initial capital) — v1 semantics."""
    b, t = growth.shape
    v0 = jnp.asarray(v0, jnp.float32)
    if _is_multiplicative(strategy):
        gk = growth * _keep_factors(strategy, t)[None, :]
        run = v0 * jnp.cumprod(gk, axis=1)
        return jnp.concatenate(
            [jnp.full((b, 1), v0, jnp.float32), run], axis=1
        )

    def body(value, x):
        g, idx = x
        value, _ = apply_month(strategy, idx, value, g)
        return value, value

    init = jnp.full((b,), v0, jnp.float32)
    _, traj = jax.lax.scan(body, init, (growth.T, jnp.arange(t)))
    return jnp.concatenate([init[None, :], traj], axis=0).T


def _law_finals_xla(law_op, root_key, path_offset, b):
    """(b,) terminal-law finals: one tile-keyed normal draw per path,
    mapped through the fitted quantile function V = scale *
    exp(Chebyshev(z / Z_MAX)) (ops/terminal_law.py). Tile keying makes
    the draw — like sample_growth's — depend only on (seed, global
    path position), so results are chunk- and sharding-invariant."""
    from stock_market_monte_carlo_jax.ops.terminal_law import (
        LAW_CLAMP, LAW_D, LAW_ZMAX,
    )

    kt = KEY_TILE
    assert b % kt == 0, (b, kt)
    first_tile = jnp.asarray(path_offset, jnp.uint32) // jnp.uint32(kt)
    keys = rng_ops.path_tile_keys(
        jax.random.fold_in(root_key, 0x1A37), first_tile, b // kt
    )
    z = jax.vmap(
        lambda k: jax.random.normal(k, (kt,), jnp.float32)
    )(keys).reshape(b)
    s = jnp.clip(z, -LAW_CLAMP, LAW_CLAMP) * jnp.float32(1.0 / LAW_ZMAX)
    law_op = jnp.asarray(law_op, jnp.float32)
    two_s = 2.0 * s
    b1 = jnp.zeros_like(s)
    b2 = jnp.zeros_like(s)
    for k in range(LAW_D - 1, 0, -1):
        b0 = two_s * b1 - b2 + law_op[1 + k]
        b2 = b1
        b1 = b0
    return law_op[0] * jnp.exp(s * b1 - b2 + law_op[1])


def chunk_stats(model, strategy, root_key, scramble_key, v0, path_offset,
                valid, target, shift=jnp.float32(0.0), *, n_periods,
                chunk_shape_b, spec, keep_finals, with_hist=True,
                sampler="icdf"):
    """Simulate one chunk and reduce to (packed_stats, histogram[, finals]).

    ``valid`` masks padding paths in the final (ragged) chunk — the moral
    equivalent of the reference's partial-block handling, done exactly
    (the reference's reduceBlock divides by blockSize even for partial
    blocks, src/simulations.cu:232; a bias we do not reproduce).

    ``shift`` centers the power-sum rows (moments of V/v0 - shift, see
    analytic_moment_shift); min/max/count-below stay uncentered and the
    host reconstruction restores raw sums in float64.

    ``sampler='law'`` draws finals in one step from the fitted terminal
    law; ``scramble_key`` then carries the (LAW_OP_LEN,) float32 law
    operand (the slot is otherwise unused by non-quasi models, which are
    the only ones terminal_law supports).
    """
    if sampler == "law":
        finals = _law_finals_xla(
            scramble_key, root_key, path_offset, chunk_shape_b
        )
        withdrawn = jnp.zeros((chunk_shape_b,), jnp.float32)
    else:
        growth = sample_growth(
            model, root_key, scramble_key, path_offset,
            (chunk_shape_b, n_periods),
        )
        finals, withdrawn = compound_final(growth, v0, strategy)
    lane = jnp.arange(chunk_shape_b, dtype=jnp.int32)
    mask = lane < valid

    # power sums accumulate on finals/v0 (f32 sums of x^4 overflow past
    # ~3e38 — realistic at large initial capital), centered about the
    # analytic shift; _absorb restores raw sums and absolute units in
    # float64
    inv0 = 1.0 / jnp.asarray(v0, jnp.float32)
    fin_s = finals * inv0
    f_stats = jnp.where(mask, fin_s - shift, 0.0)
    f2 = f_stats * f_stats
    stats = jnp.stack([
        valid.astype(jnp.float32),
        jnp.sum(f_stats),
        jnp.sum(f2),
        jnp.sum(f2 * f_stats),
        jnp.sum(f2 * f2),
        jnp.min(jnp.where(mask, fin_s, jnp.inf)),
        jnp.max(jnp.where(mask, fin_s, -jnp.inf)),
        jnp.sum(jnp.where(mask & (finals < target), 1.0, 0.0)),
        jnp.sum(jnp.where(mask, withdrawn * inv0, 0.0)),
    ])

    if with_hist:
        idx = spec.bin_index(finals)
        idx = jnp.where(mask, idx, spec.n_bins + 2)  # padding -> discard
        # counts are integer sums <= 2^24 per chunk: exact in f32
        hist = hist_ops.histogram_counts(idx, spec.n_bins + 2)
    else:
        hist = jnp.zeros((spec.n_bins + 2,), jnp.float32)

    if keep_finals:
        return stats, hist, finals
    return stats, hist


# ---------------------------------------------------------------------------
# Jit/shard-map caching.
# ---------------------------------------------------------------------------

_CHUNK_FN_CACHE = {}


def _get_chunk_fn(model_kind, strategy_kind, n_periods, chunk_b, spec,
                  keep_finals, mesh: Optional[Mesh], sampler: str = "icdf",
                  with_hist: bool = True, fuse_g: int = 1):
    # Key the mesh by contents (axis names + shape + device ids), not
    # identity: id() of a garbage-collected Mesh can be reused by CPython,
    # which would hand back a compiled fn bound to a dead mesh.
    mesh_key = (
        None if mesh is None
        else (mesh.axis_names, mesh.devices.shape,
              tuple(d.id for d in mesh.devices.flat))
    )
    cache_key = (
        model_kind, strategy_kind, n_periods, chunk_b, spec, keep_finals,
        mesh_key, sampler, with_hist, fuse_g,
    )
    fn = _CHUNK_FN_CACHE.get(cache_key)
    if fn is not None:
        return fn

    base = partial(
        chunk_stats,
        n_periods=n_periods,
        chunk_shape_b=chunk_b,
        spec=spec,
        keep_finals=keep_finals,
        with_hist=with_hist,
        sampler=sampler,
    )

    assert fuse_g == 1 or not keep_finals, (
        "fused dispatch never collects finals (engine gates it on the "
        "deferred-absorb condition)"
    )

    if mesh is None:
        if fuse_g == 1:
            fn = jax.jit(base)
        else:
            def fused(model, strategy, root_key, scramble_key, v0,
                      offsets, valids, target, shift):
                # One dispatch covering fuse_g chunks: scan over the
                # per-chunk (offset, valid) descriptors and STACK the
                # identical per-chunk (stats, hist) rows the unfused
                # path would have produced — the host absorbs each row
                # with the same float64 math in the same order, so
                # results are bit-identical to per-chunk dispatch.
                def body(carry, ov):
                    off, vld = ov
                    return carry, base(
                        model, strategy, root_key, scramble_key, v0,
                        off, vld, target, shift,
                    )
                _, outs = jax.lax.scan(
                    body, jnp.int32(0), (offsets, valids)
                )
                return outs

            fn = jax.jit(fused)
    else:
        axis = mesh.axis_names[0]

        def merge_one(out):
            s = out[0]
            # Exact cross-device merge: float sums psum in f32,
            # extrema pmin/pmax. COUNTS (row 0 = n, row 7 = count_below)
            # psum in int32: each per-device value is an exact f32
            # integer <= chunk_paths <= 2^24 (config invariant), but the
            # merged total can exceed 2^24 — inexact in f32 for odd
            # values — while int32 is exact to 2^31 (128 full chips).
            # The merged counts ride back to the host BITCAST into their
            # f32 lanes (value-preserving bit pattern; no arithmetic
            # touches them until _absorb decodes — mesh_counts=True).
            def psum_count_bits(x):
                c = jax.lax.psum(x.astype(jnp.int32), axis)
                return jax.lax.bitcast_convert_type(c, jnp.float32)[None]

            stats = jnp.concatenate([
                psum_count_bits(s[0]),
                jax.lax.psum(s[1:5], axis),
                jax.lax.pmin(s[5], axis)[None],
                jax.lax.pmax(s[6], axis)[None],
                psum_count_bits(s[7]),
                jax.lax.psum(s[8:], axis),
            ])
            # histogram counts: same exactness argument — int32 psum
            # (per-device cells are exact f32 integers <= 2^24)
            hist = jax.lax.psum(out[1].astype(jnp.int32), axis)
            return stats, hist

        if fuse_g == 1:
            def device_fn(model, strategy, root_key, scramble_key, v0,
                          offsets, valids, target, shift):
                out = base(
                    model, strategy, root_key, scramble_key, v0,
                    offsets[0], valids[0], target, shift,
                )
                stats, hist = merge_one(out)
                if keep_finals:
                    return stats, hist, out[2]
                return stats, hist

            in_off_spec = P(axis)
        else:
            def device_fn(model, strategy, root_key, scramble_key, v0,
                          offsets, valids, target, shift):
                # offsets/valids: (fuse_g, n_dev) sharded on axis 1 →
                # local (fuse_g, 1). Scan over the fuse_g chunk slots;
                # the per-chunk merges run inside the scan body, so
                # each stacked row equals the unfused dispatch's output.
                def body(carry, ov):
                    off, vld = ov
                    out = base(
                        model, strategy, root_key, scramble_key, v0,
                        off, vld, target, shift,
                    )
                    return carry, merge_one(out)
                _, outs = jax.lax.scan(
                    body, jnp.int32(0), (offsets[:, 0], valids[:, 0])
                )
                return outs

            in_off_spec = P(None, axis)

        rep = P()
        out_specs = (rep, rep, P(axis)) if keep_finals else (rep, rep)
        fn = jax.jit(
            jax.shard_map(
                device_fn,
                mesh=mesh,
                in_specs=(rep, rep, rep, rep, rep, in_off_spec,
                          in_off_spec, rep, rep),
                out_specs=out_specs,
            )
        )

    _CHUNK_FN_CACHE[cache_key] = fn
    return fn


def _validate_terminal_law(model, strategy, options) -> None:
    """Structural preconditions of EngineOptions(terminal_law=True);
    the fit itself additionally validates smoothness and keep > 0
    (ops/terminal_law.fit_terminal_law)."""
    if (getattr(model, "is_quasi", False)
            or model.kind not in ("gaussian", "historical")
            or getattr(model, "rng", "counter") != "counter"):
        raise ValueError(
            "terminal_law=True needs the iid-month structure of a "
            "counter-rng gaussian or historical model (Sobol sequences "
            f"and reference-parity rng excluded); got {model.kind!r} "
            f"rng={getattr(model, 'rng', 'counter')!r}"
        )
    if not _is_multiplicative(strategy):
        raise ValueError(
            "terminal_law=True needs a multiplicative strategy (the "
            "fixed-amount withdrawal makes V_T path-dependent beyond "
            "the terminal law); use the month-loop engine"
        )
    if strategy.kind != "none" and options.track_withdrawn:
        raise ValueError(
            "terminal_law cannot track per-path withdrawn totals "
            "(they are path-dependent; only V_T's law is sampled) — "
            "set EngineOptions(track_withdrawn=False) to run the "
            "strategy's finals at terminal-law speed"
        )


def _validate_run(model, n_paths: int, per_dispatch: int,
                  n_periods: int, draws_bootstrap: bool = True,
                  seg_paths: Optional[int] = None) -> None:
    """Hard limits of the RNG index spaces — oversized runs must error, not
    silently wrap (global path offsets are uint32; the Sobol sequence index
    is 32-bit: ops/sobol.py). ``draws_bootstrap=False`` skips the
    bootstrap-table row limit for paths that never run the umulhi index
    map (the terminal-law sampler only draws normals through the fitted
    quantile function; its FFT oracle handles any table size).
    ``seg_paths`` (simulate_stats only) arms seed segmentation: runs
    larger than one segment re-key each segment's stream
    (EngineOptions.seed_segment_paths), so only the per-SEGMENT offset
    space must fit in uint32 — n_paths itself becomes unbounded for
    counter-rng models."""
    if n_paths <= 0:
        raise ValueError(f"n_paths must be positive, got {n_paths}")
    if n_periods <= 0:
        raise ValueError(f"n_periods must be positive, got {n_periods}")
    segmented = (seg_paths is not None and n_paths > seg_paths
                 and not getattr(model, "is_quasi", False))
    if segmented:
        if getattr(model, "rng", "counter") == "reference":
            raise ValueError(
                f"n_paths={n_paths} exceeds one seed segment "
                f"({seg_paths}), but reference-parity rng streams depend "
                "only on the global path id (src/simulations.cu:140: "
                "seed = rand_pcg(tid+1)) — a fresh segment would repeat "
                "segment 0's paths exactly. Cap n_paths or run counter "
                "rng"
            )
        if seg_paths > (1 << 32) - per_dispatch:
            raise ValueError(
                f"seed_segment_paths={seg_paths} leaves no uint32 offset "
                f"headroom for a {per_dispatch}-path dispatch; lower "
                "seed_segment_paths or chunk_paths"
            )
    elif n_paths > (1 << 32) - per_dispatch:
        raise ValueError(
            f"n_paths={n_paths} exceeds the uint32 global-path-offset space "
            f"(limit {(1 << 32) - per_dispatch} at this chunk size); split "
            "the run over multiple seeds instead"
        )
    if model.kind.endswith("historical") and draws_bootstrap:
        n_table = int(np.asarray(model.returns_pct).shape[0])
        if n_table >= (1 << 15):
            raise ValueError(
                f"historical returns table has {n_table} rows; the exact "
                f"integer bootstrap index map (umulhi via 16-bit split, "
                f"ops/rng.bootstrap_index_exact) supports at most "
                f"{(1 << 15) - 1} rows — "
                "aggregate the series (e.g. monthly) or subsample it"
            )
    if model.kind.startswith("sobol"):
        n_dims = int(np.asarray(model.direction).shape[0])
        if n_periods > n_dims:
            raise ValueError(
                f"n_periods={n_periods} exceeds the model's {n_dims} Sobol "
                "dimensions; create the model with "
                f"n_periods>={n_periods} (direction numbers are "
                "per-dimension)"
            )
    if getattr(model, "is_quasi", False):
        if n_paths > (1 << 31):
            raise ValueError(
                f"n_paths={n_paths} exceeds 2^31 paths per Sobol run; "
                "split the run and position each part with "
                "index_offset (the 2^62-deep i8-parity index space)"
            )
        index_offset = getattr(model, "index_offset", 0)
        if index_offset + n_paths > (1 << 62):
            raise ValueError(
                f"index_offset {index_offset} + n_paths {n_paths} exceeds "
                "the 2^62 Sobol sequence (i8_sobol depth)"
            )
    if isinstance(model, (GaussianReturns, SobolGaussianReturns)):
        mean = float(np.asarray(model.mean_pct))
        std = float(np.asarray(model.std_pct))
        # growth (100+r)/100 goes NEGATIVE when r < -100: a loss of more
        # than everything in one month. Multiplicative engines (none /
        # percent strategies) propagate the sign through the product —
        # the reference's unclamped update_fund semantics — which is
        # almost surely not what a user with such a sigma wants. Warn
        # when the per-draw probability is non-negligible (> ~1e-12,
        # i.e. within 7 sigma).
        if std > 0 and (100.0 + mean) / std < 7.0:
            import warnings

            warnings.warn(
                f"GaussianReturns(mean={mean}, std={std}): monthly losses "
                "beyond -100% are reachable (growth factor < 0, "
                f"P ~ {0.5 * np.e ** (-0.5 * ((100 + mean) / std) ** 2):.1e}"
                " per draw); multiplicative compounding propagates the "
                "sign through the product (reference update_fund "
                "semantics, src/simulations.cpp:14-16)",
                stacklevel=3,
            )


def _xla_chunk_paths(n_periods: int, options: EngineOptions) -> int:
    """Bound the month loop's materialized (B, T) growth buffer to ~1 GiB;
    the terminal-law sampler never materializes it and uses
    chunk_paths."""
    budget = 1 << 30
    b = budget // (n_periods * 4 * 3)
    b = max(KEY_TILE, (b // KEY_TILE) * KEY_TILE)
    return min(b, options.chunk_paths)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamUpdate:
    """Partial statistics mid-run, pushed after every absorbed chunk.

    The live analog of the reference GUIs reading shared stats buffers while
    the simulation thread fills them (examples/visualize_returns_cpu.cpp:
    296-434): here the chunked dispatch loop IS the stream, and each update
    carries exact accumulated moments + histogram over the paths done so
    far (not a sample) — any target/quantile can be recomputed per frame.
    """

    done: int
    n_paths: int
    stats: np.ndarray              # packed power sums, float64
    hist: np.ndarray               # histogram counts incl. under/overflow
    spec: red.HistogramSpec
    target_amount: Optional[float]
    elapsed_s: float

    @property
    def moments(self) -> red.MomentSummary:
        return red.MomentSummary.from_packed(
            self.stats, self.target_amount is not None
        )

    def quantiles(self, qs) -> np.ndarray:
        if self.hist.sum() == 0:
            # covers both histogram=False and done == 0: quantiles over
            # all-zero counts would return meaningless values, not data
            raise ValueError(
                "no histogram counts available (EngineOptions("
                "histogram=False), or no paths absorbed yet)"
            )
        return red.quantiles_from_histogram(self.spec, self.hist, qs)

    def prob_below(self, amount: float) -> float:
        """P(final < amount) over the paths done so far, from the exact
        histogram — the recompute-on-slider-change query
        (visualize_returns_cpu.cpp:340-356). Same CDF semantics as
        SimulationResult.prob_below_amount (one shared implementation)."""
        if self.done == 0:
            return 0.0
        if self.hist.sum() == 0:
            raise ValueError(
                "no histogram available (EngineOptions(histogram=False))"
            )
        return red.prob_below_from_histogram(self.spec, self.hist, amount)


def simulate_stats(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    target_amount: Optional[float] = None,
    options: EngineOptions = EngineOptions(),
    mesh: Optional[Mesh] = None,
    progress=None,
    keep_final_values: Optional[bool] = None,
    checkpoint_path: Optional[str] = None,
    stream: Optional[Callable[[StreamUpdate], None]] = None,
) -> SimulationResult:
    """Fused simulate+reduce: O(1) host traffic regardless of n_paths.

    ``stream`` receives a :class:`StreamUpdate` after every absorbed chunk
    — exact partial moments + histogram over the paths done so far — which
    is what live visualization surfaces consume (the reference GUIs poll
    shared buffers mid-run instead, examples/visualize_returns_cpu.cpp:
    296-434).

    With ``checkpoint_path``, accumulated statistics are persisted after
    every absorbed chunk and an interrupted run resumes from the next chunk
    boundary with identical results (counter-based RNG makes chunks
    independent of execution history). The reference has no such mechanism
    (SURVEY.md section 5: checkpoint/resume "None").

    ``n_paths`` is unbounded for counter-rng models: runs larger than
    ``EngineOptions.seed_segment_paths`` (default 2^31) are partitioned
    into seed segments, each drawing an independent stream (segment 0 =
    the plain seed key, so sub-segment runs are unchanged), merged with
    the same exact float64 host reductions that combine chunks — a
    1e10-path call needs no manual seed splitting and keeps every
    invariant (chunk size, fuse_chunks, mesh, checkpoint/resume).
    Quasi-random (Sobol) models instead split via ``index_offset``;
    reference-parity rng refuses past one segment (its streams are
    keyed by global path id alone and would repeat).
    """
    t_start = time.perf_counter()
    # 'law' draws V_T from the fitted terminal law; 'icdf' runs the month
    # loop (its Gaussian draws are inverse-CDF normals)
    sampler = "law" if options.terminal_law else "icdf"
    n_dev = 1 if mesh is None else mesh.size
    # chunk_b below never exceeds options.chunk_paths, so this bound is
    # conservative for the uint32 offset-headroom check
    _validate_run(model, n_paths, options.chunk_paths * n_dev, n_periods,
                  draws_bootstrap=not options.terminal_law,
                  seg_paths=options.seed_segment_paths)
    v0f = float(initial_capital)
    if not (v0f > 0.0 and np.isfinite(v0f)):
        raise ValueError(
            f"initial_capital must be positive and finite, got "
            f"{initial_capital}"
        )
    keep_finals = (options.keep_final_values
                   if keep_final_values is None else keep_final_values)
    if keep_finals and 4 * n_paths > 8 << 30:
        # mirror simulate_paths' up-front host-memory guard: finals are
        # streamed into host parts and concatenated at the end, so a
        # multi-billion-path keep_finals run would otherwise compute for
        # minutes and then die in np.concatenate
        raise ValueError(
            f"keep_final_values at n_paths={n_paths} would materialize "
            f"~{4 * n_paths / 2**30:.0f} GiB of finals on the host; use "
            "the fused statistics/histogram (exact quantiles come from "
            "the 4096-bin histogram) or split the run"
        )
    spec = make_histogram_spec(
        model, strategy, n_periods, initial_capital, options.histogram_bins
    )

    if options.terminal_law:
        # the terminal-law path never materializes the (B, T) growth
        # buffer _xla_chunk_paths bounds — full chunks
        chunk_b = options.chunk_paths
    else:
        chunk_b = _xla_chunk_paths(n_periods, options)

    per_dispatch = chunk_b * n_dev

    root_key = jax.random.key(seed)
    scramble_key = jax.random.fold_in(root_key, 0x50B0)
    if options.terminal_law:
        from stock_market_monte_carlo_jax.ops import terminal_law as tlaw

        _validate_terminal_law(model, strategy, options)
        law_fit = tlaw.fit_terminal_law(
            model, strategy, n_periods, v0f
        )
        # the law operand rides the (otherwise unused) scramble_key slot
        # so the whole dispatch/mesh/cache machinery is shared verbatim;
        # the device upload is cached on the (cached) fit
        scramble_key = law_fit.operand_device()
    target = jnp.float32(
        np.inf if target_amount is None else target_amount
    )
    v0 = jnp.float32(initial_capital)

    # --- seed segmentation (runs larger than one segment) -----------------
    # Lifts the uint32 offset cap: paths are partitioned into fixed
    # SEG-sized segments, each drawing an independent counter-rng stream
    # (see EngineOptions.seed_segment_paths). Segment 0 runs under the
    # plain seed key, so any run that fits in one segment — every
    # previously-legal run up to 2^31 paths — is bit-identical to the
    # unsegmented engine. Statistics merge across segments through the
    # very same exact float64 host merges that combine chunks; Sobol
    # models are excluded (_validate_run: their split mechanism is
    # index_offset), reference-parity rng refuses (offset-only streams
    # would repeat verbatim).
    SEG = options.seed_segment_paths
    segmented = n_paths > SEG and not getattr(model, "is_quasi", False)
    seg = 0
    base_key = root_key
    law_operand = scramble_key if options.terminal_law else None

    def _segment_keys(s: int):
        rk = (base_key if s == 0
              else jax.random.fold_in(base_key, _SEG_FOLD + s))
        sk = (law_operand if law_operand is not None
              else jax.random.fold_in(rk, 0x50B0))
        return rk, sk

    total_stats = red.zero_packed_stats()
    total_hist = np.zeros(spec.n_bins + 2, np.float64)
    finals_parts = []
    pending = None  # (arrays, paths_done_after, valid, offset_after)
    done = 0
    offset = 0
    remaining = n_paths

    # Absorb cadence. Each per-chunk fetch is a device->host round trip;
    # the one-deep overlap below only hides it while the NEXT chunk
    # computes, so for chunks whose device time is below the round trip
    # the fetches set the pace. When nothing consumes per-chunk results —
    # no stream/progress callback, no checkpoint, no finals collection —
    # defer every absorb: queue ALL dispatches, stack the per-chunk
    # device stats, fetch once, and run the exact same f64 host merges
    # in dispatch order (bit-identical results).
    defer_absorb = (stream is None and progress is None
                    and checkpoint_path is None and not keep_finals)
    # Fused dispatch rides the same condition: when nothing consumes
    # per-chunk results, up to options.fuse_chunks chunks run as ONE
    # device dispatch (lax.scan over the chunk body, _get_chunk_fn
    # fuse_g) — identical per-chunk rows, stacked, so the f64 host
    # merges below see the same values in the same order, without a
    # per-chunk dispatch.
    fuse_max = options.fuse_chunks if defer_absorb else 1
    # each entry: (stats_rows (g, 9), hist_rows (g, n_bins+2),
    #              [(paths_done_after, valid), ...] of length g)
    deferred = []
    deferred_chunks = 0

    def _flush_deferred():
        # ONE round trip per output kind for the queued chunks,
        # then the identical sequential f64 merges (same order, same
        # math as the per-chunk path — results are bit-identical to it)
        nonlocal total_stats, total_hist, done, deferred_chunks
        if not deferred:
            return
        if len(deferred) == 1:
            # single fused block (the 100M headline path): fetch the
            # stacked rows directly — no concatenate dispatch
            s_all, h_all = jax.device_get((deferred[0][0], deferred[0][1]))
        else:
            s_all, h_all = jax.device_get((
                jnp.concatenate([d[0] for d in deferred]),
                jnp.concatenate([d[1] for d in deferred]),
            ))
        metas = [m for d in deferred for m in d[2]]
        for i, (done_after, valid) in enumerate(metas):
            total_stats, total_hist, done = _absorb(
                ((s_all[i], h_all[i]), done_after, valid), total_stats,
                total_hist, finals_parts, keep_finals, stat_scale,
                shift_c, mesh_counts=mesh is not None,
            )
        deferred.clear()
        deferred_chunks = 0

    fingerprint = None
    if checkpoint_path is not None:
        from stock_market_monte_carlo_jax.engine import checkpoint as ckpt

        if keep_finals:
            raise ValueError(
                "checkpoint_path is not supported with keep_final_values "
                "(per-path buffers are not checkpointed)"
            )
        # The stream id covers exactly what changes the sampled bit
        # stream: the sampler (month loop or terminal law). Chunk size and
        # device count are deliberately NOT included — counter-based RNG
        # makes the draws chunk- and shard-invariant, so a run checkpointed
        # on an 8-device mesh resumes on 1 (and vice versa; across chunk
        # sizes only to float32 rounding on the GPU, see EngineOptions). The
        # "xla/streams3" prefix is the generation tag of the threefry
        # streams: checkpoints written under it must keep resuming, so it
        # changes only when a sampler's recipe does (and then refuses to
        # resume stale checkpoints into a different stream).
        hist_tag = "" if options.histogram else "/nohist"
        # segmented runs sample a SEG-dependent stream family — the tag
        # keeps a checkpoint from resuming under a different
        # seed_segment_paths (or under a pre-segmentation build's stream)
        seg_tag = f"/seg{SEG}" if segmented else ""
        fingerprint = ckpt.config_fingerprint(
            model, strategy, n_paths, n_periods, initial_capital, seed,
            target_amount, spec,
            f"xla/streams3/{sampler}{hist_tag}{seg_tag}",
        )
        state = ckpt.load(checkpoint_path, fingerprint)
        if state is not None:
            total_stats = state.stats
            total_hist = state.hist
            done = state.paths_done
            offset = state.next_offset
            remaining = n_paths - done
            if segmented:
                # every checkpointed chunk except a segment's last is
                # full-valid, so the within-segment offset is derivable
                # from the exact valid count — robust to resuming with a
                # different chunk size (deliberately not fingerprinted)
                seg, offset = divmod(done, SEG)
                if seg and remaining > 0:
                    root_key, scramble_key = _segment_keys(seg)
            if progress is not None:
                progress(done, n_paths)

    # restores absolute units of the v0-normalized device power sums
    # (layout: n, s1..s4, min, max, count_below, withdrawn)
    stat_scale = np.array(
        [1.0, v0f, v0f**2, v0f**3, v0f**4, v0f, v0f, 1.0, v0f], np.float64
    )
    shift_c = analytic_moment_shift(model, strategy, n_periods)
    shift_j = jnp.float32(shift_c)

    while remaining > 0:
        if segmented:
            done_v = n_paths - remaining   # valid paths DISPATCHED so far
            s_now = done_v // SEG
            if s_now != seg:
                # crossed into a fresh segment: offsets restart at 0
                # under the segment's own keys
                seg = s_now
                offset = 0
                root_key, scramble_key = _segment_keys(seg)
            # no dispatch may straddle a segment boundary: cap this
            # iteration's valid paths at the segment's remainder (the
            # boundary chunk pads exactly like the run-end tail)
            cap = min(remaining, (seg + 1) * SEG - done_v)
        else:
            cap = remaining
        chunks_left = -(-cap // per_dispatch)
        if fuse_max > 1 and chunks_left >= 2:
            # Fused block: when the whole remainder fits under fuse_max
            # it runs as ONE dispatch (exact scan length g = chunks_left
            # — the ragged tail rides the last chunk's valid mask, so a
            # 100M-path headline run is a single device dispatch);
            # larger runs stream full fuse_max-length blocks and finish
            # with one exact-length tail block. Compiled scan lengths
            # per run: at most {fuse_max, tail} — one more XLA program
            # than the binary decomposition this replaces, for g-1
            # fewer dispatches on the tail.
            g = min(fuse_max, chunks_left)
        else:
            g = 1
        if g >= 2:
            b = chunk_b  # chunks_left >= 2 implies n_paths > per_dispatch
            fn = _get_chunk_fn(
                (model.kind, getattr(model, "rng", "counter")),
                strategy.kind, n_periods, b, spec, keep_finals,
                mesh, sampler, options.histogram, fuse_g=g,
            )
            tvts = [min(cap - i * per_dispatch, per_dispatch)
                    for i in range(g)]
            np_off1 = np.uint32(offset) + np.uint32(b * n_dev) * np.arange(
                g, dtype=np.uint32
            )
            if mesh is None:
                out = fn(
                    model, strategy, root_key, scramble_key, v0,
                    jnp.asarray(np_off1),
                    jnp.asarray(np.array(tvts, np.int32)), target, shift_j,
                )
            else:
                np_off = (np_off1[:, None] + np.uint32(b)
                          * np.arange(n_dev, dtype=np.uint32)[None, :])
                np_val = np.clip(
                    np.array(tvts, np.int64)[:, None]
                    - np.int64(b) * np.arange(n_dev, dtype=np.int64)[None, :],
                    0, b,
                ).astype(np.int32)
                shard = jax.sharding.NamedSharding(
                    mesh, P(None, mesh.axis_names[0])
                )
                offsets = jax.make_array_from_callback(
                    (g, n_dev), shard, lambda i: np_off[i]
                )
                valids = jax.make_array_from_callback(
                    (g, n_dev), shard, lambda i: np_val[i]
                )
                out = fn(
                    model, strategy, root_key, scramble_key, v0,
                    offsets, valids, target, shift_j,
                )
            metas = []
            for tvt in tvts:
                done += tvt
                metas.append((done, tvt))
            deferred.append((out[0], out[1], metas))
            deferred_chunks += g
            offset += g * b * n_dev
            remaining -= sum(tvts)
            if deferred_chunks >= _DEFER_FLUSH_CHUNKS:
                _flush_deferred()
            continue

        this_valid_total = min(cap, per_dispatch)
        # Shape policy: a run larger than one dispatch uses ONE fixed chunk
        # shape throughout — the ragged tail is padded with masked paths
        # (<=0.6% wasted compute at default sizes) rather than introducing a
        # second compiled shape (a fresh compile costs orders of magnitude
        # more than the padding). Runs smaller than a chunk get a
        # single right-sized dispatch.
        if n_paths > per_dispatch:
            b = chunk_b
        else:
            # bucket small runs to the next power of two so arbitrary path
            # counts reuse a handful of compiled shapes (compiles cost
            # seconds; padded paths cost microseconds)
            b = _round_up(_round_up(this_valid_total, n_dev) // n_dev,
                          KEY_TILE)
            b = min(chunk_b, 1 << (b - 1).bit_length())
        fn = _get_chunk_fn(
            (model.kind, getattr(model, "rng", "counter")),
            strategy.kind, n_periods, b, spec, keep_finals,
            mesh, sampler, options.histogram,
        )
        if mesh is None:
            out = fn(
                model, strategy, root_key, scramble_key, v0,
                jnp.uint32(offset), jnp.int32(this_valid_total), target,
                shift_j,
            )
        else:
            # Build the per-device offset/valid arrays with an explicit
            # sharding over the mesh: on a process-spanning mesh
            # (jax.distributed) each process materializes only its
            # addressable shards — plain host arrays would not be
            # accepted as P("paths")-sharded inputs there.
            np_off = np.uint32(offset) + np.uint32(b) * np.arange(
                n_dev, dtype=np.uint32
            )
            np_val = np.clip(
                np.int64(this_valid_total)
                - np.int64(b) * np.arange(n_dev, dtype=np.int64),
                0, b,
            ).astype(np.int32)
            shard = jax.sharding.NamedSharding(mesh, P(mesh.axis_names[0]))
            offsets = jax.make_array_from_callback(
                (n_dev,), shard, lambda i: np_off[i]
            )
            valids = jax.make_array_from_callback(
                (n_dev,), shard, lambda i: np_val[i]
            )
            out = fn(
                model, strategy, root_key, scramble_key, v0,
                offsets, valids, target, shift_j,
            )

        if defer_absorb:
            deferred.append((out[0][None], out[1][None],
                             [(done + this_valid_total, this_valid_total)]))
            deferred_chunks += 1
            done += this_valid_total
            offset += b * n_dev
            remaining -= this_valid_total
            if deferred_chunks >= _DEFER_FLUSH_CHUNKS:
                # bound the queue: each queued chunk holds a live
                # (n_bins+2,) histogram on device, so an unbounded queue
                # makes device memory (and the final stack)
                # O(n_chunks) — at 256 it stays ~4 MB
                _flush_deferred()
            continue

        # Overlap: fetch chunk k-1 while chunk k computes on device.
        if pending is not None:
            total_stats, total_hist, done = _absorb(
                pending, total_stats, total_hist, finals_parts,
                keep_finals, stat_scale, shift_c,
                mesh_counts=mesh is not None,
            )
            _maybe_checkpoint(
                checkpoint_path, fingerprint, pending[3], done,
                total_stats, total_hist,
            )
            if progress is not None:
                progress(done, n_paths)
            if stream is not None:
                stream(StreamUpdate(
                    done=done, n_paths=n_paths, stats=total_stats,
                    hist=total_hist, spec=spec,
                    target_amount=target_amount,
                    elapsed_s=time.perf_counter() - t_start,
                ))
        pending = (out, done + this_valid_total, this_valid_total,
                   offset + b * n_dev)

        offset += b * n_dev
        remaining -= this_valid_total

    _flush_deferred()
    if pending is not None:  # None when a checkpoint was already complete
        total_stats, total_hist, done = _absorb(
            pending, total_stats, total_hist, finals_parts, keep_finals,
            stat_scale, shift_c, mesh_counts=mesh is not None,
        )
        _maybe_checkpoint(
            checkpoint_path, fingerprint, pending[3], done,
            total_stats, total_hist,
        )
    if progress is not None:
        progress(done, n_paths)
    if stream is not None:
        stream(StreamUpdate(
            done=done, n_paths=n_paths, stats=total_stats,
            hist=total_hist, spec=spec, target_amount=target_amount,
            elapsed_s=time.perf_counter() - t_start,
        ))

    finals = None
    if keep_finals:
        finals = np.concatenate(finals_parts)[:n_paths]

    moments = red.MomentSummary.from_packed(
        total_stats, target_amount is not None
    )
    if not options.track_withdrawn:
        moments = dataclasses.replace(moments, total_withdrawn=0.0)
    return SimulationResult(
        n_paths=n_paths,
        n_periods=n_periods,
        initial_capital=initial_capital,
        moments=moments,
        histogram_spec=spec if options.histogram else None,
        histogram_counts=total_hist if options.histogram else None,
        target_amount=target_amount,
        final_values=finals,
        elapsed_s=time.perf_counter() - t_start,
    )


def _maybe_checkpoint(path, fingerprint, next_offset, done, stats, hist):
    if path is None:
        return
    from stock_market_monte_carlo_jax.engine import checkpoint as ckpt

    ckpt.save(path, ckpt.CheckpointState(
        fingerprint=fingerprint, next_offset=int(next_offset),
        paths_done=int(done), stats=stats, hist=hist,
    ))


def _absorb(pending, total_stats, total_hist, finals_parts, keep_finals,
            scale, shift=0.0, mesh_counts=False):
    out, done_after, valid = pending[:3]
    raw = np.asarray(out[0], np.float32)
    stats = raw.astype(np.float64)
    if mesh_counts:
        # mesh chunk fns psum the count rows in int32 and bitcast the
        # exact totals into the f32 lanes (see device_fn) — decode here
        counts = raw[np.array([0, 7])].copy().view(np.int32)
        stats[0] = counts[0]
        stats[7] = counts[1]
    if shift != 0.0:
        # the device accumulated moments of d = f - c; restore the raw
        # power sums of f in float64 (binomial expansion about c). The
        # shifted sums carry the f32 accuracy of the SMALL centered
        # quantities, so the reconstructed raw sums are far more accurate
        # than direct f32 accumulation of f^k.
        c = float(shift)
        n, d1, d2, d3, d4 = stats[0], stats[1], stats[2], stats[3], stats[4]
        s1 = d1 + n * c
        s2 = d2 + 2 * c * d1 + n * c**2
        s3 = d3 + 3 * c * d2 + 3 * c**2 * d1 + n * c**3
        s4 = d4 + 4 * c * d3 + 6 * c**2 * d2 + 4 * c**3 * d1 + n * c**4
        stats = stats.copy()
        stats[1:5] = [s1, s2, s3, s4]
    stats = stats * scale
    hist = np.asarray(out[1], np.float64)
    merged = np.concatenate([
        total_stats[:5] + stats[:5],
        [min(total_stats[5], stats[5]), max(total_stats[6], stats[6])],
        total_stats[7:] + stats[7:],
    ])
    if keep_finals:
        finals_parts.append(np.asarray(out[2], np.float32).ravel()[:valid])
    return merged, total_hist + hist, done_after


def simulate_final_values(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    options: EngineOptions = EngineOptions(),
    mesh: Optional[Mesh] = None,
    progress=None,
) -> np.ndarray:
    """v2 semantics: per-path final values (host np.ndarray)."""
    result = simulate_stats(
        model, n_paths, n_periods, initial_capital, seed, strategy,
        None, options, mesh, progress, keep_final_values=True,
    )
    return result.final_values


@partial(jax.jit, static_argnames=("n_paths", "n_periods", "dtype"))
def _paths_jit(model, strategy, root_key, scramble_key, v0, path_offset,
               n_paths, n_periods, dtype="float32"):
    growth = sample_growth(
        model, root_key, scramble_key, path_offset, (n_paths, n_periods)
    )
    traj = compound_paths(growth, v0, strategy)
    if dtype == "bfloat16":
        traj = traj.astype(jnp.bfloat16)
    return traj


def simulate_paths(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    path_offset: int = 0,
    dtype: str = "float32",
) -> np.ndarray:
    """v1 semantics: (n_paths, n_periods+1) float32 host trajectories,
    month 0 = capital.

    Intended for visualization-scale path counts (the reference likewise
    caps drawn trajectories, examples/visualize_returns_cpu_v2.cpp:176-202);
    memory is O(n_paths * n_periods). Large exports are dispatched in
    KEY_TILE-multiple row chunks so each chunk's device->host fetch
    overlaps the next chunk's compute (counter-based RNG makes the split
    invisible: identical values to one big call). ``dtype='bfloat16'``
    transfers half the bytes — the bottleneck for keepdata exports in
    transfer-bound environments — losing ~3 decimal digits per sample;
    the returned array is float32 either way.
    """
    est_bytes = 4 * (n_paths + KEY_TILE) * (n_periods + 1) * 3
    if est_bytes > 8 << 30:
        raise ValueError(
            f"simulate_paths would materialize ~{est_bytes / 2**30:.0f} GiB "
            f"of trajectories ({n_paths} paths x {n_periods + 1} months); "
            "use simulate_stats/simulate_final_values for statistics at "
            "scale, or cap the trajectory count (run(keep_trajectories=N))."
        )
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {dtype!r}")
    # RNG streams are keyed per KEY_TILE-aligned tile (sample_growth), so
    # the dispatch window aligns DOWN to the tile boundary and the first
    # `lead` computed rows are dropped — path_offset may be arbitrary and
    # rows [path_offset, path_offset + n_paths) of the global stream are
    # returned exactly (tested against the slice of a from-zero call)
    lead = int(path_offset) % KEY_TILE
    base = int(path_offset) - lead
    b = _round_up(lead + n_paths, KEY_TILE)
    root_key = jax.random.key(seed)
    scramble_key = jax.random.fold_in(root_key, 0x50B0)
    v0 = jnp.float32(initial_capital)

    chunk = 2 * KEY_TILE
    parts = []
    for off in range(0, b, chunk):
        rows = min(chunk, b - off)
        parts.append(_paths_jit(
            model, strategy, root_key, scramble_key, v0,
            jnp.uint32(base + off), rows, n_periods, dtype,
        ))
    # all chunks are dispatched (async) before any fetch: chunk k's
    # transfer rides under chunk k+1's compute
    out = np.empty((n_paths, n_periods + 1), np.float32)
    done = 0
    skip = lead
    for part in parts:
        if skip >= part.shape[0]:
            skip -= part.shape[0]
            continue
        p = part[skip:] if skip else part
        skip = 0
        take = min(p.shape[0], n_paths - done)
        if take > 0:
            out[done:done + take] = np.asarray(p[:take], np.float32)
            done += take
    return out


def simulate(config, model, strategy=NoWithdrawal(),
             options: EngineOptions = EngineOptions(),
             mesh: Optional[Mesh] = None, progress=None) -> SimulationResult:
    """Config-object entry point: run a ``SimulationConfig`` experiment."""
    return simulate_stats(
        model, config.n_paths, config.n_periods, config.initial_capital,
        config.seed, strategy, config.target_amount, options, mesh,
        progress,
    )


def run(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    target_amount: Optional[float] = None,
    options: EngineOptions = EngineOptions(),
    mesh: Optional[Mesh] = None,
    progress=None,
    keep_trajectories: int = 0,
    stream: Optional[Callable[[StreamUpdate], None]] = None,
) -> SimulationResult:
    """One-call experiment: fused stats plus (optionally) a capped set of
    trajectories for fan plots — the v2-stats + v1-viz two-thread pattern of
    the reference GUIs (examples/visualize_returns_cpu_v2.cpp:184-202) in a
    single dispatch pipeline."""
    result = simulate_stats(
        model, n_paths, n_periods, initial_capital, seed, strategy,
        target_amount, options, mesh, progress, stream=stream,
    )
    if keep_trajectories > 0:
        k = min(keep_trajectories, n_paths)
        result.trajectories = simulate_paths(
            model, k, n_periods, initial_capital, seed, strategy,
            dtype=options.trajectory_dtype,
        )
    return result
