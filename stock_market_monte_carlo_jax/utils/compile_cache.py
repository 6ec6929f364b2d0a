"""Where JAX's persistent compilation cache lives.

Compiled executables persist across processes, so a second process — a
checkpoint resume, the next benchmark run — loads a program instead of
compiling it again. If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets nothing. Otherwise the cache goes to a fixed
directory inside the checkout (``.jax_cache`` at the repository root,
listed in ``.gitignore``): the path is part of the cache's identity, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Configure the cache (at package import); returns its directory."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
