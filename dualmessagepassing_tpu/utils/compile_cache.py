"""JAX's persistent compilation cache, shared by every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
module sets nothing. Otherwise the cache lives at the fixed path
`<checkout>/.jax_cache`: the directory is part of the cache key, so a
path built from a temporary name, a process id or the time would never
hit again.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the
    checkout's."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `cache_dir()`; call before the
    first compilation. Returns the directory."""
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
