"""Process-wide JAX configuration for spacedust_tpu.

Persistent compilation cache: the engine compiles one executable per
(length bucket, direction); caching them on disk lets a repeat run skip
the compiles.  The cache is JAX_COMPILATION_CACHE_DIR where that is set,
and no other directory; otherwise a fixed path inside the checkout,
`<repo>/.jax_cache` (listed in .gitignore): the path is part of the
cache's key, so it must not move between runs.

The backend is chosen by JAX_PLATFORMS alone.
"""

from __future__ import annotations

import os
from pathlib import Path

_DONE = False

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The compilation cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def configure_jax() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
