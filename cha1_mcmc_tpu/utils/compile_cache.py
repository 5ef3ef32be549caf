"""Persistent XLA compilation cache for fit entry points.

A fit compiles its sampler programs once per shape; the cache lets a
rerun (a resumed fit, the next molecule, the CLI in a fresh process) load
them instead. The cache directory is part of what makes an entry findable,
so it sits at one fixed path: JAX_COMPILATION_CACHE_DIR when set (JAX reads
it into `jax_compilation_cache_dir` itself, and nothing here overrides it),
else `.jax_cache/` at the root of this checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Idempotently enable JAX's persistent compilation cache and return
    its directory. A directory already configured (JAX_COMPILATION_CACHE_DIR
    or `jax_compilation_cache_dir`) is left untouched; otherwise
    DEFAULT_CACHE_DIR is created and set."""
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
