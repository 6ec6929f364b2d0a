"""Streaming checkpoint/resume for long simulation runs.

The reference has no checkpointing at all (SURVEY.md section 5: persistence
is CSV outputs; the atomic progress counter enables live partial statistics
but not resumption). Here the engine's chunked dispatch loop makes resume
natural: accumulated statistics are tiny (a packed stats vector + histogram
counts), so after every chunk the engine can persist

    {next_offset, paths_done, packed_stats, histogram, config_fingerprint}

and a restarted run continues from the next chunk boundary with bit-identical
results — the counter-based RNG (ops/rng.py) guarantees chunk k's draws
don't depend on who computed chunks 0..k-1.

Format: a single .npz (atomic rename on write). The fingerprint covers every
input that affects the stream (model kind+params hash, strategy, seed,
n_paths, n_periods, capital, histogram spec, and the stream tag of the
sampler); mismatches refuse to resume. It deliberately does NOT cover chunk
size or device count — chunk/sharding invariance of the counter-based RNG
means a run checkpointed on an 8-device mesh resumes on 1 device (or any
other topology) with identical draws; at another chunk size a GPU run's
month-loop finals may differ by float32 rounding of the month product
(EngineOptions docstring).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np


def config_fingerprint(model, strategy, n_paths, n_periods,
                       initial_capital, seed, target_amount, spec,
                       stream_tag) -> str:
    import jax

    def _leaf_repr(x):
        arr = np.asarray(x)
        return [str(arr.dtype), arr.shape,
                hashlib.sha256(arr.tobytes()).hexdigest()[:16]]

    payload = {
        "model_kind": model.kind,
        "model_leaves": [
            _leaf_repr(leaf) for leaf in jax.tree_util.tree_leaves(model)
        ],
        # treedef reprs carry the pytree AUX data — static fields like
        # HistoricalBootstrap.rng and Sobol index_offset are meta_fields,
        # invisible to tree_leaves, yet they change the sampled bit
        # stream; omitting them let a checkpoint resume across different
        # streams and silently mix partial sums
        "model_treedef": repr(jax.tree_util.tree_structure(model)),
        "strategy_kind": strategy.kind,
        "strategy_leaves": [
            _leaf_repr(leaf) for leaf in jax.tree_util.tree_leaves(strategy)
        ],
        "strategy_treedef": repr(jax.tree_util.tree_structure(strategy)),
        "n_paths": int(n_paths),
        "n_periods": int(n_periods),
        "initial_capital": float(initial_capital),
        "seed": int(seed),
        "target_amount": (None if target_amount is None
                          else float(target_amount)),
        "spec": [spec.lo, spec.hi, spec.n_bins],
        # the key keeps its historical name so existing checkpoints'
        # fingerprints are unchanged
        "backend": stream_tag,
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass
class CheckpointState:
    fingerprint: str
    next_offset: int
    paths_done: int
    stats: np.ndarray      # packed stats vector (float64)
    hist: np.ndarray       # histogram counts (float64)


def save(path: str, state: CheckpointState) -> None:
    """Atomic write: tmp file + rename, so a crash never corrupts."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                fingerprint=np.frombuffer(
                    state.fingerprint.encode(), dtype=np.uint8
                ),
                next_offset=np.int64(state.next_offset),
                paths_done=np.int64(state.paths_done),
                stats=state.stats.astype(np.float64),
                hist=state.hist.astype(np.float64),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, expected_fingerprint: str) -> Optional[CheckpointState]:
    """Load a checkpoint; None if absent. Raises on fingerprint mismatch
    (resuming a different experiment would silently corrupt statistics)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != expected_fingerprint:
            raise ValueError(
                f"checkpoint {path!r} belongs to a different run "
                f"(fingerprint {fp[:12]}... != expected "
                f"{expected_fingerprint[:12]}...); delete it or point "
                "checkpoint_path elsewhere"
            )
        return CheckpointState(
            fingerprint=fp,
            next_offset=int(z["next_offset"]),
            paths_done=int(z["paths_done"]),
            stats=np.asarray(z["stats"], np.float64),
            hist=np.asarray(z["hist"], np.float64),
        )
