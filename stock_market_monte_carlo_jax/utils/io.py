"""CSV outputs, schema-compatible with the reference.

``write_data_file`` reproduces the exact two-row layout of the reference's
helpers (src/helpers.cpp:23-38): a ``Returns,,`` row (note the double comma —
returns has one fewer entry than values and the reference pads a blank cell)
and a ``Values,`` row, every cell comma-terminated, written into
``./outputs/``. python/plot_returns.py-style tooling parses these unchanged.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np


def _fmt(x: float) -> str:
    # std::ofstream << float defaults to 6 significant digits; match it so
    # downstream parsers see familiar magnitudes.
    return f"{float(x):g}"


def print_vector(v: Sequence[float]) -> None:
    """Port of print_vector (src/helpers.cpp:10-16)."""
    body = " ".join(f"{float(x):6.3f}" for x in v)
    print(f"v = [ {body}  ]")


def write_vector_file(fname: str, v: Iterable[float]) -> None:
    """Port of write_vector_file (src/helpers.cpp:18-21): flat
    comma-terminated values, no header, no directory handling."""
    with open(fname, "w") as f:
        for x in v:
            f.write(f"{_fmt(x)},")


def write_data_file(fname: str, returns: Sequence[float],
                    values: Sequence[float], out_dir: str = "./outputs/",
                    verbose: bool = True) -> str:
    """Write one simulation's returns+values CSV into ``out_dir``.

    Returns the full path written. Tries the native C++ writer first (bulk
    runs write thousands of files; reference: src/simulations.cpp:57-136).
    """
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, fname)
    if verbose:
        print(f"Writing data to csv file {path}")

    try:
        from stock_market_monte_carlo_jax.native import native_write_data_file

        if native_write_data_file(
            path, np.asarray(returns, np.float32),
            np.asarray(values, np.float32),
        ):
            return path
    except ImportError:
        pass

    with open(path, "w") as f:
        f.write("Returns,,")
        for x in returns:
            f.write(f"{_fmt(x)},")
        f.write("\nValues,")
        for x in values:
            f.write(f"{_fmt(x)},")
    return path


def read_data_file(path: str):
    """Parse a ``Returns,,/Values,`` CSV back into (returns, values) float32
    arrays — the inverse of write_data_file, as plot_returns.py consumes it."""
    returns, values = [], []
    with open(path) as f:
        for line in f:
            cells = [c for c in line.strip().split(",")]
            if not cells:
                continue
            tag = cells[0]
            nums = [float(c) for c in cells[1:] if c not in ("", "\n")]
            if tag == "Returns":
                returns = nums
            elif tag == "Values":
                values = nums
    return (np.asarray(returns, np.float32), np.asarray(values, np.float32))
