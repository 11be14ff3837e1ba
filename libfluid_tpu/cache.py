"""Persistent XLA compilation cache for the benches, drivers and chip_smoke.

Compiling the 128^3 substep and the renderer takes minutes in a fresh
process. The cache keys on (HLO, backend, flags) and is exact, so repeat runs
skip straight to execution. ``JAX_COMPILATION_CACHE_DIR``, when set, is the
only directory used; otherwise the cache lives at the fixed ``<repo>/.jax_cache``
(the path is part of the cache key, so a moving directory never hits). Tests
don't use it: they run on the CPU, where compiles are cheap and semantics
checks should see fresh compiles.
"""

from __future__ import annotations

import os

import jax

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_persistent_cache() -> str:
    """Enable the on-disk compilation cache (idempotent). Returns the dir."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
