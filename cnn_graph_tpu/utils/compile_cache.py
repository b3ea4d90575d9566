"""Persistent XLA compilation cache for the entry-point scripts."""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "CHECKOUT_CACHE"]

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key,
# so a directory that moves never hits), listed in .gitignore.
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands:
    JAX reads it itself and no other directory is set in code.
    Otherwise the cache lives in ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
