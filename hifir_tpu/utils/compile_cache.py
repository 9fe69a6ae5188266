"""Persistent XLA compilation cache location.

One rule for every entry point (``chip_smoke.py``, ``bench.py``,
``__graft_entry__.py``): where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here; otherwise the cache lives at a
fixed path inside the checkout, ``<repo>/.jax_cache`` (gitignored).  The
path is part of what makes a cache hit, so it never depends on a temporary
directory, a pid or the time.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
