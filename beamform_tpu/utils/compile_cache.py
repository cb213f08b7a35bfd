"""Persistent XLA compilation cache for the entry points.

One policy for the CLI, ``bench.py`` and ``chip_smoke.py``: when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no other
directory is set here; otherwise the cache lives in ``.jax_cache/`` at the
root of the checkout (gitignored). The path is part of the cache key, so a
fixed directory is what lets a later process hit it.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
