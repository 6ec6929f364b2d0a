"""Device mesh construction for path-parallel simulation.

This workload has exactly one parallelizable axis — independent simulation
paths (SURVEY.md section 2.3: the reference's only distribution strategy is
a static N/n_gpus split over devices, src/simulations.cu:512,602). Here
it is a 1-D ``jax.sharding.Mesh`` named ``"paths"``; the engine
``shard_map``s each chunk over it and merges statistics with
psum/pmin/pmax between devices (engine/engine.py:_get_chunk_fn). The mesh
follows the algorithm alone: every device reaches every other.

Multi-host: initialize ``jax.distributed`` before calling ``paths_mesh()``
and every process passes its full ``jax.devices()`` — the mesh then spans
the slice and the same engine code runs unchanged; only final statistics
(a few KB) ever cross DCN, mirroring the reduceBlock design goal at pod
scale. This is proven, not just claimed: tests/test_multihost.py spawns a
real 2-process ``jax.distributed`` CPU cluster (4 virtual devices each),
runs ``simulate_stats`` over the process-spanning 8-device mesh, and
checks both processes report statistics matching a single-process run
(identical histogram/counts; moments to collective-rounding tolerance).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from jax.sharding import Mesh

PATHS_AXIS = "paths"


def device_count() -> int:
    import jax

    return len(jax.devices())


def paths_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """1-D mesh over the path axis.

    - ``n_devices=None``: use every visible device.
    - ``n_devices=1``: returns None (the engine's single-device path is
      cheaper than a degenerate mesh).
    - asking for more devices than exist raises, like the reference's
      cudaSetDevice would fail past device count.
    """
    import jax

    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices <= 0:
        raise ValueError(
            f"n_devices must be >= 1, got {n_devices} (the reference's "
            "cudaSetDevice would likewise reject it)"
        )
    if n_devices == 1:
        return None
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} available"
        )
    return Mesh(np.asarray(devices[:n_devices]), (PATHS_AXIS,))
