"""Configuration dataclasses for the simulation engine.

The reference's "config system" is positional argv per binary plus hard-coded
constants (reference: examples/benchmark_mc_gpu.cpp:50-61, THREADS_PER_BLOCK
in src/simulations.cu:17, initial_capital=1000 in examples/benchmark_mc_cpu.cpp).
Here configuration is explicit and serializable; the CLI layer maps the
reference's argv conventions onto these dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DEFAULT_INITIAL_CAPITAL = 1000.0
# Gaussian market defaults: 6%/yr mean, 10%/yr std, expressed monthly in
# percent (reference: examples/monte_carlo_simulated.cpp:11-13).
DEFAULT_GAUSSIAN_MEAN_PCT = 6.0 / 12
DEFAULT_GAUSSIAN_STD_PCT = 10.0 / 12


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Execution knobs of the (single, plain-JAX) engine.

    Paths are drawn in tiles of 8192 (engine.KEY_TILE, the moral
    equivalent of the reference's THREADS_PER_BLOCK=256,
    src/simulations.cu:17), and the tile doubles as the RNG granularity:
    a tile's stream depends only on its *global* index, so the draws are
    invariant to chunking and sharding. Results are bit-identical across
    repeats, fused/unfused dispatch, checkpoint resume and sharding at one
    chunk size. Across chunk sizes the month loop's per-path finals may
    differ on the GPU by the float32 rounding of the T-month product (at
    most T * 2^-24 relative): XLA picks the reduction's association by
    shape. The CPU is bit-identical across chunk sizes too.
    """

    # Paths per single device dispatch; large runs loop over macro-chunks of
    # this size so the host can report progress and stay under memory
    # limits.
    chunk_paths: int = 2**24
    # Final-value histogram resolution (log-spaced interior bins). The
    # default makes interior + underflow + overflow = 4096.
    histogram_bins: int = 4094
    # False skips the final-value histogram entirely — the reference's
    # reduceBlock benchmark computes ONLY mean/variance
    # (src/simulations.cu:185-247), so this is the like-for-like mode.
    # SimulationResult.quantiles()/prob_below_amount() then raise unless
    # keep_final_values captures exact finals.
    histogram: bool = True
    # False skips the per-path withdrawn-total accumulation (reported
    # total_withdrawn becomes 0.0). Required by terminal_law=True with a
    # withdrawal strategy: per-path withdrawn totals are path-dependent
    # and cannot be sampled from the terminal law.
    track_withdrawn: bool = True
    # When True, compute per-path final values in addition to fused stats
    # (needed for exact quantiles; costs a device write of 4 bytes/path).
    keep_final_values: bool = False
    # Terminal-law sampling (ops/terminal_law.py): draw V_T in ONE step
    # from its exact T-fold-convolution law (FFT oracle -> Chebyshev fit
    # of the probit quantile function, evaluated on device by a Clenshaw
    # recurrence) instead of looping T months — ~two orders of magnitude
    # less device work at T=360, sampling the identical distribution to
    # the fit tolerance (measured ~1e-7 log error at T>=12; the fit
    # validates itself and raises when a law is too rough, e.g. a 1-month
    # bootstrap step function). Applies to simulate_stats /
    # simulate_final_values with counter-rng gaussian/historical models
    # and multiplicative strategies (keep > 0; strategy runs need
    # track_withdrawn=False — per-path withdrawn totals are
    # path-dependent and cannot be sampled from the terminal law).
    # Streams are NOT samplewise-comparable to the month-loop engine.
    # The reference has no analog.
    terminal_law: bool = False
    # Max chunks fused into ONE device dispatch (a lax.scan over the
    # chunk body) when nothing consumes per-chunk results — the same
    # condition as deferred absorb (no stream/progress/checkpoint/
    # keep_final_values). Fusing emits the identical per-chunk (stats,
    # histogram) rows stacked, so host float64 merges run in the same
    # order on the same f32 values — results are BIT-IDENTICAL to
    # unfused dispatch. A run dispatches full fuse_chunks-length blocks
    # plus ONE exact-length tail block (a run of <= fuse_chunks chunks is
    # a single device dispatch); at most two scan lengths compile per
    # run and no padded compute is wasted. 0 or 1 disables.
    fuse_chunks: int = 64
    # Paths per seed segment. simulate_stats runs larger n_paths as a
    # sequence of segments of this size, each drawing from an
    # independent stream (segment 0 uses the plain seed key — runs at or
    # below one segment are bit-identical to a build without
    # segmentation; segment s >= 1 folds s into the key:
    # engine._segment_keys). This lifts the uint32 global-path-offset cap
    # (~4.29e9 paths): a 1e10-path run is one call whose statistics merge
    # exactly in float64 on the host, and whose result is invariant to
    # chunk size, fuse_chunks, device count, and checkpoint/resume — the
    # same invariants as within-segment chunking. The default 2^31 keeps
    # the per-segment offset space comfortably inside uint32 for any
    # legal chunk size. Changing it changes the sampled streams of runs
    # larger than one segment (the value is part of the checkpoint
    # fingerprint for such runs); it does NOT affect runs that fit in
    # one segment. Excluded: Sobol models (their documented split
    # mechanism is index_offset over the 2^62 sequence) and
    # reference-parity rng (streams depend only on the global path id,
    # so a fresh segment would REPEAT segment 0's paths — simulate_stats
    # refuses).
    seed_segment_paths: int = 1 << 31
    # Device->host dtype for exported trajectories (run(keep_trajectories),
    # simulate_paths). "bfloat16" halves the transfer bytes at ~3 decimal
    # digits of per-sample precision: ideal for visualization consumers,
    # wrong for exact-quantile tests. Values are converted back to f32 on
    # the host either way.
    trajectory_dtype: str = "float32"

    def __post_init__(self):
        if self.chunk_paths % 8192 != 0:
            raise ValueError(
                "chunk_paths must be a multiple of 8192 (the RNG/path tile),"
                f" got {self.chunk_paths}"
            )
        if self.chunk_paths > 2**24:
            # Per-device count exactness invariant: path counts,
            # count-below and histogram cells accumulate in f32 on
            # device. f32 represents every integer only up to 2^24, so
            # one device-chunk must not exceed it — at 2^24 all
            # intermediate partial sums are integers <= 2^24 and hence
            # exact. Cross-device merges (engine device_fn) psum counts
            # in int32 (exact to 2^31) and the host merges in float64,
            # so total run size is unbounded; only the per-dispatch
            # device chunk is capped.
            raise ValueError(
                "chunk_paths must be <= 2**24 to keep on-device f32 path "
                f"counts exact, got {self.chunk_paths}"
            )
        if not (0 <= self.fuse_chunks <= 64
                and (self.fuse_chunks & (self.fuse_chunks - 1)) == 0):
            # the cap bounds per-dispatch device occupancy (64 x 2^24 =
            # 1.07e9 paths in one dispatch); power-of-two is kept as a
            # stable public contract (scan lengths are exact-sized per
            # run regardless, see engine's fused-block dispatch)
            raise ValueError(
                "fuse_chunks must be a power of two <= 64 (0/1 disables),"
                f" got {self.fuse_chunks}"
            )
        if (self.seed_segment_paths <= 0
                or self.seed_segment_paths % 8192 != 0):
            # tile alignment keeps segment starts on RNG-tile boundaries
            raise ValueError(
                "seed_segment_paths must be a positive multiple of 8192, "
                f"got {self.seed_segment_paths}"
            )
        if self.trajectory_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "trajectory_dtype must be 'float32' or 'bfloat16', "
                f"got {self.trajectory_dtype!r}"
            )


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """One Monte Carlo experiment.

    Mirrors the reference entry-point signature (max_n_simulations,
    n_periods, initial_capital, returns-source; reference:
    include/stock_market_monte_carlo/simulations.h:49-87) plus seed and
    withdrawal strategy (the reference's open TODO, README.md:130-133).
    """

    n_paths: int
    n_periods: int
    initial_capital: float = DEFAULT_INITIAL_CAPITAL
    seed: int = 0
    # Below-target probability threshold (the GUI slider / count_below input,
    # reference: examples/visualize_returns_cpu.cpp:121-134). None disables.
    target_amount: Optional[float] = None

    def __post_init__(self):
        if self.n_paths <= 0:
            raise ValueError(f"n_paths must be positive, got {self.n_paths}")
        if self.n_periods <= 0:
            raise ValueError(
                f"n_periods must be positive, got {self.n_periods}"
            )
