"""Persistent XLA compilation cache.

Every driver pays XLA and kernel compilation on each *process* launch;
JAX's persistent cache turns recompiles across processes into disk hits.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets no other directory. Otherwise the cache lives at a fixed
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of what a
later run must find again, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable_persistent_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; call before building
    jitted programs.

    :return: the cache directory in use.
    """
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
