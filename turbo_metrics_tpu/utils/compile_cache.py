"""JAX's persistent compilation cache: one place decides where it lives.

A cold 1080p compile of the metric step takes tens of seconds; the cache
makes every later process with the same program start warm.
"""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache (listed in .gitignore).
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself, so
    no other directory is configured), else ``<checkout>/.jax_cache``."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
