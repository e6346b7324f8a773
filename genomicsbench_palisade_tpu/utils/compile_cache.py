"""Persistent XLA compilation cache for the CLI drivers.

Bucketed drivers (chain, phmm, fmi) compile one executable per shape
bucket; the persistent cache lets a rerun skip those compiles.  The cache
lives where JAX_COMPILATION_CACHE_DIR says when it is set, otherwise at
the fixed <repo>/.jax_cache (git-ignored): a fixed path, because the path
is part of the cache key.  Called by every CLI main(); safe to call more
than once.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable() -> str:
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
