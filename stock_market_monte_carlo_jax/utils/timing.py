"""Tracing and phase timing.

The reference instruments with Nsight Compute (profiling/howto.sh) and
manual ``std::chrono`` phase timers around every alloc/transfer/kernel
segment (src/simulations.cu:351-411). The equivalents here:

- ``PhaseTimer`` — named wall-clock phases that force device completion at
  the boundary (``jax.block_until_ready``), so a phase's time is real device
  time, not dispatch time. Prints a per-phase table like the reference's
  fmt::print timer blocks.
- ``trace`` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable device trace (the Nsight replacement; see
  docs/profiling.md).

``PhaseTimer.stop`` fetches a scalar from the tagged arrays in addition to
``block_until_ready``, so a phase ends only when its results exist.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple


class PhaseTimer:
    """Accumulating named phase timer with device-sync boundaries.

    Usage::

        pt = PhaseTimer()
        with pt.phase("simulate", out):   # out: arrays the phase produced
            ...
        print(pt.report())
    """

    def __init__(self):
        self.phases: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str, *sync_arrays):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _force(sync_arrays)
            self.phases.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        totals = self.totals()
        width = max((len(n) for n in totals), default=5)
        lines = [f"{'phase':<{width}s}    seconds"]
        total = 0.0
        for name, dt in totals.items():
            lines.append(f"{name:<{width}s}  {dt:9.4f}")
            total += dt
        lines.append(f"{'TOTAL':<{width}s}  {total:9.4f}")
        return "\n".join(lines)


def _force(arrays):
    import jax
    import numpy as np

    for a in arrays:
        if a is None:
            continue
        jax.block_until_ready(a)
        try:
            leaf = jax.tree_util.tree_leaves(a)
            if leaf:
                np.asarray(jax.numpy.ravel(leaf[0])[0])  # true completion
        except Exception:
            pass


@contextlib.contextmanager
def trace(log_dir: str = "outputs/trace"):
    """Capture a profiler trace viewable in TensorBoard/Perfetto —
    the Nsight Compute replacement (reference: profiling/howto.sh)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, warmup: int = 1, reps: int = 3,
            label: Optional[str] = None) -> float:
    """Best-of-reps wall time of a jitted callable with forced completion.
    Returns seconds; prints when ``label`` given."""
    for _ in range(warmup):
        _force([fn(*args)])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _force([fn(*args)])
        best = min(best, time.perf_counter() - t0)
    if label:
        print(f"{label}: {best * 1e3:.2f} ms")
    return best
