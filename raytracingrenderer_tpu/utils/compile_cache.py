"""The one persistent-compile-cache rule for every entry point.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and nothing is set
here.  Otherwise the cache lives at `<checkout>/.jax_cache`: a fixed
path, so a later process (a respawned worker, the next run) finds what
an earlier one compiled.
"""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".."))


def enable() -> str:
    """Apply the rule; returns the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
