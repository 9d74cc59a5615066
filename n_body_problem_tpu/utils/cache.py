"""Persistent XLA compilation cache, one place for every entry point.

Compiling the treecode at a million bodies takes minutes; the cache keeps
compiled programs across processes. ``JAX_COMPILATION_CACHE_DIR`` wins
when it is set (JAX reads it itself; nothing else is configured here).
Otherwise the cache lives at a fixed path inside the checkout,
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part of
what makes a later process find the entries again.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
