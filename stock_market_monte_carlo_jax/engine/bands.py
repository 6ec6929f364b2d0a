"""Device-side trajectory decimation: percentile bands without
materializing (n_paths, T+1) anywhere.

The reference's keep-data engine stores every trajectory
(src/simulations.cpp:139-202; ~28 GB at 100M x 360, README.md:70) and its
GUIs then draw <= 100 of them. Here the band statistics are computed on
device: each chunk's trajectories are reduced to per-month z-score
histograms (T+1 months x n_bins), accumulated across chunks, and only that
O(T * n_bins) table crosses to the host — bands for 100M paths transfer
~1 MB instead of ~144 GB.

Method: month t's fund values are approximately log-normal with log-center
log(v0) + t*mu_l and log-scale sigma_l*sqrt(t) (mu_l, sigma_l the log
growth moments the histogram spec already uses). Binning the z-score
z = (log V_t - center_t) / scale_t on a fixed [-12, 12] grid gives every
month the same *relative* resolution, so band quantiles are accurate to a
fraction of a bin width at any horizon. Depleted paths (V=0 under
withdrawals) land in the underflow bin exactly.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stock_market_monte_carlo_jax.config import EngineOptions
from stock_market_monte_carlo_jax.models.strategies import NoWithdrawal
from stock_market_monte_carlo_jax.ops import histogram as hist_ops

Z_RANGE = 12.0


@dataclasses.dataclass
class TrajectoryBands:
    """Percentile bands over time + a capped set of sample trajectories."""

    quantile_levels: Tuple[float, ...]
    values: np.ndarray          # (len(levels), T+1) fund values
    months: np.ndarray          # (T+1,)
    sample_paths: np.ndarray    # (k, T+1)
    n_paths: int
    month_hist: np.ndarray      # (T+1, n_bins+2) accumulated counts; in
    # band_mode="cdf" this is the (T+1, K) counts-BELOW table instead
    centers: np.ndarray         # (T+1,) log centers
    scales: np.ndarray          # (T+1,) log scales
    mode: str = "hist"
    log_thresholds: np.ndarray | None = None  # (T+1, K), cdf mode only

    def band(self, level: float) -> np.ndarray:
        return self.values[self.quantile_levels.index(level)]


def _chunk_traj(model, strategy, root_key, scramble_key, v0, offset, valid,
                b, t):
    """(b, t+1) trajectories of one chunk and the (b, 1) valid-lane
    mask."""
    from stock_market_monte_carlo_jax.engine import engine as eng

    growth = eng.sample_growth(model, root_key, scramble_key, offset, (b, t))
    traj = eng.compound_paths(growth, v0, strategy)        # (b, t+1)
    lane = jnp.arange(b, dtype=jnp.int32)[:, None]
    return traj, lane < valid


@partial(jax.jit, static_argnames=("b", "t", "n_bins", "linear"))
def _chunk_month_hist(model, strategy, root_key, scramble_key, v0,
                      offset, valid, centers, inv_scales, b, t, n_bins,
                      linear):
    traj, live = _chunk_traj(model, strategy, root_key, scramble_key, v0,
                             offset, valid, b, t)
    if linear:
        # non-multiplicative (fixed-amount) strategies shift values
        # additively — bin V/hi_t linearly on [0, 1]; exact zeros
        # (depleted) go to the underflow bin
        z01 = traj * inv_scales[None, :]
        raw = jnp.floor(z01 * n_bins)
        idx = jnp.clip(raw.astype(jnp.int32) + 1, 1, n_bins + 1)
        idx = jnp.where(traj <= 0.0, 0, idx)
    else:
        logv = jnp.log(jnp.maximum(traj, 1e-37))
        z = (logv - centers[None, :]) * inv_scales[None, :]
        raw = jnp.floor((z + Z_RANGE) * (n_bins / (2 * Z_RANGE)))
        idx = jnp.clip(raw.astype(jnp.int32) + 1, 0, n_bins + 1)
        idx = jnp.where(logv <= np.log(1e-37), 0, idx)     # depleted
    idx = jnp.where(live, idx, n_bins + 2)                 # padding -> discard
    return hist_ops.month_histogram_counts(idx, n_bins + 2)


@partial(jax.jit, static_argnames=("b", "t"))
def _chunk_month_cdf(model, strategy, root_key, scramble_key, v0, offset,
                     valid, thresholds, b, t):
    """(T+1, K) int32 counts of valid paths strictly below each month's
    K value thresholds: one broadcast compare and a sum over paths, which
    XLA fuses (no (b, T+1, K) buffer)."""
    traj, live = _chunk_traj(model, strategy, root_key, scramble_key, v0,
                             offset, valid, b, t)
    # padding lanes to +inf: never below any finite threshold
    traj = jnp.where(live, traj, jnp.inf)
    below = traj[:, :, None] < thresholds[None, :, :]
    return jnp.sum(below, axis=0, dtype=jnp.int32)


_BAND_MESH_FN_CACHE = {}


def _band_mesh_fn(mesh, use_cdf, model_kind, rng, strategy_kind, n_periods,
                  chunk_b, n_bins, linear):
    """jit(shard_map(...)) of a band chunk fn over the path axis: each
    device computes its shard's per-month counts and they merge with one
    psum — the multi-device band launcher. Signature of the returned fn:
    (offsets, valids, model, strategy, root_key, scramble_key, v0, aux_a,
    aux_b) with offsets/valids P("paths")-sharded and everything else
    replicated. aux_a/aux_b are the hist mode's (centers, inv_scales), or
    the cdf mode's (thresholds, unused)."""
    from jax.sharding import PartitionSpec as P

    mesh_key = (mesh.axis_names, mesh.devices.shape,
                tuple(d.id for d in mesh.devices.flat))
    key = (use_cdf, model_kind, rng, strategy_kind, n_periods, chunk_b,
           n_bins, linear, mesh_key)
    fn = _BAND_MESH_FN_CACHE.get(key)
    if fn is not None:
        return fn
    axis = mesh.axis_names[0]

    if use_cdf:
        def base(off, val, model, strategy, root_key, scramble_key, v0,
                 aux_a, aux_b):
            del aux_b
            return _chunk_month_cdf(
                model, strategy, root_key, scramble_key, v0, off, val,
                aux_a, chunk_b, n_periods,
            )
    else:
        def base(off, val, model, strategy, root_key, scramble_key, v0,
                 aux_a, aux_b):
            return _chunk_month_hist(
                model, strategy, root_key, scramble_key, v0, off, val,
                aux_a, aux_b, chunk_b, n_periods, n_bins, linear,
            )

    def device_fn(offsets, valids, *rest):
        # Each device's counts are exact integers <= chunk_b (f32 counts
        # are exact to 2^24), but a b*n_dev-path dispatch can concentrate
        # MORE than 2^24 paths in one cell (month-0 / underflow bins),
        # where f32 addition rounds. Merge across devices in int32 —
        # exact to 2^31; the f32->int32 cast is lossless at <= 2^24.
        c = base(offsets[0], valids[0], *rest).astype(jnp.int32)
        return jax.lax.psum(c, axis)

    rep = P()
    fn = jax.jit(jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(P(axis), P(axis)) + (rep,) * 7,
        out_specs=rep,
    ))
    _BAND_MESH_FN_CACHE[key] = fn
    return fn


def simulate_bands(
    model,
    n_paths: int,
    n_periods: int,
    initial_capital: float = 1000.0,
    seed: int = 0,
    strategy=NoWithdrawal(),
    quantile_levels: Sequence[float] = (0.05, 0.25, 0.5, 0.75, 0.95),
    sample_paths: int = 32,
    n_bins: int = 1024,
    options: EngineOptions = EngineOptions(),
    progress=None,
    mesh=None,
    band_mode: str = "hist",
    n_thresholds: int = 32,
) -> TrajectoryBands:
    """Percentile bands over the full horizon for any number of paths.

    Host transfer is O(T * n_bins) regardless of n_paths — the capability
    of the reference's store-everything v1 engine at v2's memory cost.
    With a ``mesh``, each chunk shards over the path axis and the
    per-month histograms merge with a psum (counter-based streams make
    the result identical to the single-device run).

    ``band_mode="cdf"`` (opt-in) replaces the per-month histogram with
    counts below ``n_thresholds`` analytically-placed value thresholds
    per month and inverts quantiles by probit interpolation — the same
    sample (identical RNG streams) as the hist mode, reduced to K counts
    per month. Multiplicative strategies only. The returned
    ``month_hist`` is then the counts-below table and ``log_thresholds``
    holds the threshold grid.

    ``band_mode="analytic"`` returns the EXACT infinite-path bands: the
    month-t marginal of V is a closed t-fold convolution law, so the
    quantiles come from one FFT + T characteristic-function powers on
    the host (ops/analytic.marginal_value_quantiles, ~1e-4 relative) —
    zero device time, ``n_paths`` ignored except for the sampled fan
    curves. Gaussian/historical models, multiplicative strategies.
    """
    from stock_market_monte_carlo_jax.engine import engine as eng

    eng._validate_run(model, n_paths, options.chunk_paths, n_periods)
    mu_l, sigma_l = eng.log_growth_moments(model)
    months = np.arange(n_periods + 1)
    linear = not eng._is_multiplicative(strategy)
    centers = np.log(initial_capital) + months * mu_l
    if linear:
        # fixed-amount withdrawals shift values additively, which a
        # log-z grid cannot bracket — bin linearly on [0, hi_t] with
        # hi_t the +12-sigma lognormal envelope of the withdrawal-free
        # fund (withdrawals only lower values)
        hi = np.exp(centers + Z_RANGE * sigma_l
                    * np.sqrt(np.maximum(months, 1)))
        scales = hi
        centers = np.zeros_like(hi)
        inv_scales_j = jnp.asarray(1.0 / hi, jnp.float32)
    else:
        if not isinstance(strategy, NoWithdrawal):
            # percent withdrawals shift the log center by log(keep)/month;
            # split the difference so both tails stay inside +/-12 z
            centers = centers + months * np.log(max(
                1e-6,
                float(np.min(np.asarray(eng._keep_factors(
                    strategy, max(n_periods, 1))))),
            )) * 0.5
        scales = np.maximum(sigma_l * np.sqrt(np.maximum(months, 1)), 1e-9)
        inv_scales_j = jnp.asarray(1.0 / scales, jnp.float32)
    centers_j = jnp.asarray(centers, jnp.float32)

    # cap at 2^24 paths/chunk: per-month counts accumulate in float32,
    # and month 0 puts EVERY path of a chunk in one bin — counts past
    # 2^24 would silently stop incrementing
    b = min(eng._xla_chunk_paths(n_periods, options), options.chunk_paths,
            1 << 24)
    root_key = jax.random.key(seed)
    scramble_key = jax.random.fold_in(root_key, 0x50B0)
    v0 = jnp.float32(initial_capital)

    if band_mode not in ("hist", "cdf", "analytic"):
        raise ValueError(f"band_mode must be 'hist', 'cdf', or "
                         f"'analytic', got {band_mode!r}")
    if getattr(options, "terminal_law", False):
        raise ValueError(
            "terminal_law samples only the FINAL value's law; bands are "
            "month-resolved — use band_mode='analytic' for the exact "
            "infinite-path bands, or the default month-loop engine"
        )
    if band_mode == "analytic":
        # EXACT infinite-path bands: no sampling at all — month t's
        # marginal is the t-fold convolution law, computed by one FFT +
        # T incremental characteristic-function powers on the host
        # (ops/analytic.marginal_value_quantiles). n_paths is ignored
        # except for the optional sampled fan curves.
        from stock_market_monte_carlo_jax.ops import analytic as ana

        if linear:
            raise ValueError(
                "band_mode='analytic' needs a multiplicative strategy "
                "(fixed-amount withdrawals have no closed marginal law)"
            )
        if model.kind not in ("gaussian", "historical"):
            raise ValueError(
                "band_mode='analytic' supports gaussian/historical "
                f"models (the marginal law is closed-form); got "
                f"{model.kind!r}"
            )
        if model.kind == "gaussian":
            kind, params = "gaussian", (float(np.asarray(model.mean_pct)),
                                        float(np.asarray(model.std_pct)))
        else:
            kind, params = "bootstrap", np.asarray(model.returns_pct,
                                                   np.float64)
        keep = (None if isinstance(strategy, NoWithdrawal)
                else np.asarray(eng._keep_factors(strategy, n_periods),
                                np.float64))
        qs = tuple(quantile_levels)
        values = ana.marginal_value_quantiles(
            kind, params, n_periods, float(initial_capital), qs,
            keep=keep,
        )
        k = min(sample_paths, n_paths)
        sample = np.asarray(eng.simulate_paths(
            model, k, n_periods, initial_capital, seed, strategy
        )) if k > 0 else np.empty((0, n_periods + 1))
        return TrajectoryBands(
            quantile_levels=qs,
            values=values,
            months=months,
            sample_paths=sample,
            n_paths=0,      # exact law, not an n-path estimate
            month_hist=np.zeros((n_periods + 1, 0)),
            centers=centers,
            scales=scales if not linear else np.asarray(scales),
            mode="analytic",
        )
    use_cdf = band_mode == "cdf"
    if use_cdf:
        if linear:
            raise ValueError(
                "band_mode='cdf' needs a multiplicative strategy (the "
                "log-space threshold grid cannot bracket fixed-amount "
                "withdrawals) — use band_mode='hist'"
            )
        if n_thresholds < 4:
            raise ValueError(
                "band_mode='cdf' needs n_thresholds >= 4 (two guard rows "
                f"around a uniform interior grid), got {n_thresholds}"
            )
        # threshold grid: interior rows 1..K-2 at uniform z in
        # [-Z_INT, Z_INT]; guard rows 0 / K-1 at -/+Z_GUARD expressed as
        # fractional k on the same affine-in-k log grid
        z_int, z_guard = 6.0, 14.0
        dz = 2.0 * z_int / (n_thresholds - 3)
        z0 = -z_int - dz
        kap_lo = (-z_guard - z0) / dz
        kap_hi = (z_guard - z0) / dz
        kkv = np.arange(n_thresholds, dtype=np.float64)
        kkv[0], kkv[-1] = kap_lo, kap_hi
        cdf_a = (centers + z0 * scales).astype(np.float32)   # (T+1,)
        cdf_b = (dz * scales).astype(np.float32)
        logthr = (cdf_a[:, None]
                  + kkv.astype(np.float32)[None, :] * cdf_b[:, None]
                  ).astype(np.float64)
        # the device compares values against exp of the f32 log grid, so
        # the host inversion uses (to 1 ulp of the exp) the thresholds
        # the counts are taken against
        thr_j = jnp.asarray(np.exp(logthr).astype(np.float32))

    n_dev = 1 if mesh is None else mesh.size
    per_dispatch = b * n_dev
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        if use_cdf:
            aux_a, aux_b = thr_j, jnp.zeros((1,), jnp.float32)
        else:
            aux_a, aux_b = centers_j, inv_scales_j

    total = np.zeros(
        (n_periods + 1, n_thresholds if use_cdf else n_bins + 2),
        np.float64)
    done, offset, remaining = 0, 0, n_paths
    pending = None  # (device counts, valid) — fetch overlaps next chunk
    while remaining > 0:
        valid = min(remaining, per_dispatch)
        if n_paths > per_dispatch:
            this_b = b
        else:
            # bucket small runs to the next power of two — the engine's
            # policy (engine.py small-run branch): compiles cost seconds,
            # padded tiles cost microseconds, so a sweep over small
            # n_paths must reuse a handful of compiled shapes instead of
            # one per value
            this_b = eng._round_up(
                eng._round_up(valid, n_dev) // n_dev, eng.KEY_TILE
            )
            this_b = min(b, 1 << (this_b - 1).bit_length())
        if mesh is not None:
            fn = _band_mesh_fn(
                mesh, use_cdf, model.kind,
                getattr(model, "rng", "counter"), strategy.kind,
                n_periods, this_b, n_bins, linear,
            )
            np_off = np.uint32(offset) + np.uint32(this_b) * np.arange(
                n_dev, dtype=np.uint32
            )
            np_val = np.clip(
                np.int64(valid) - np.int64(this_b)
                * np.arange(n_dev, dtype=np.int64),
                0, this_b,
            ).astype(np.int32)
            offsets = jax.make_array_from_callback(
                (n_dev,), shard, lambda i: np_off[i]
            )
            valids = jax.make_array_from_callback(
                (n_dev,), shard, lambda i: np_val[i]
            )
            counts = fn(offsets, valids, model, strategy, root_key,
                        scramble_key, v0, aux_a, aux_b)
        elif use_cdf:
            counts = _chunk_month_cdf(
                model, strategy, root_key, scramble_key, v0,
                jnp.uint32(offset), jnp.int32(valid), thr_j, this_b,
                n_periods,
            )
        else:
            counts = _chunk_month_hist(
                model, strategy, root_key, scramble_key, v0,
                jnp.uint32(offset), jnp.int32(valid), centers_j,
                inv_scales_j, this_b, n_periods, n_bins, linear,
            )
        if pending is not None:
            # absorb chunk k-1 on the host while chunk k computes — the
            # float64 accumulation is the reason counts must cross per
            # chunk (f32 device totals would saturate at 2^24 per bin)
            total += np.asarray(pending[0], np.float64)
            done += pending[1]
            if progress is not None:
                progress(done, n_paths)
        pending = (counts, valid)
        offset += this_b * n_dev
        remaining -= valid
    if pending is not None:
        total += np.asarray(pending[0], np.float64)
        done += pending[1]
        if progress is not None:
            progress(done, n_paths)

    # invert the z-grid to fund values per quantile per month (host, O(T))
    # via the shared histogram-quantile inversion (ops/reductions.py)
    from stock_market_monte_carlo_jax.ops import reductions as red

    qs = tuple(quantile_levels)
    values = np.empty((len(qs), n_periods + 1))
    if use_cdf:
        # probit-space interpolation of the K-point per-month CDF; ranks
        # below the underflow-guard threshold (depleted mass) -> 0.0
        values[:, 0] = initial_capital  # month 0 is exactly v0
        for tt in range(1, n_periods + 1):
            lq = red.cdf_band_quantiles(total[tt], logthr[tt], qs,
                                        n_paths)
            v = np.exp(lq)
            v[~np.isfinite(lq)] = 0.0
            values[:, tt] = v
        k = min(sample_paths, n_paths)
        sample = np.asarray(eng.simulate_paths(
            model, k, n_periods, initial_capital, seed, strategy
        )) if k > 0 else np.empty((0, n_periods + 1))
        return TrajectoryBands(
            quantile_levels=qs,
            values=values,
            months=months,
            sample_paths=sample,
            n_paths=n_paths,
            month_hist=total,
            centers=centers,
            scales=scales,
            mode="cdf",
            log_thresholds=logthr,
        )
    if linear:
        z_edges = np.linspace(0.0, 1.0, n_bins + 1)
    else:
        z_edges = np.linspace(-Z_RANGE, Z_RANGE, n_bins + 1)
    pad = z_edges[1] - z_edges[0]
    full_edges = np.concatenate(
        [[z_edges[0] - pad], z_edges, [z_edges[-1] + pad]]
    )
    for tt in range(n_periods + 1):
        zq = red.grid_quantiles(total[tt], full_edges, qs)
        depleted = zq < z_edges[0]   # rank fell in the underflow bin
        if linear:
            v = zq * scales[tt]
        else:
            v = np.exp(centers[tt] + zq * scales[tt])
        v[depleted] = 0.0
        values[:, tt] = v

    k = min(sample_paths, n_paths)
    sample = np.asarray(eng.simulate_paths(
        model, k, n_periods, initial_capital, seed, strategy
    )) if k > 0 else np.empty((0, n_periods + 1))

    return TrajectoryBands(
        quantile_levels=qs,
        values=values,
        months=months,
        sample_paths=sample,
        n_paths=n_paths,
        month_hist=total,
        centers=centers,
        scales=scales,
    )
