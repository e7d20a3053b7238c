"""Placement of JAX's persistent compilation cache.

One rule for every entry point (``cli.main``, ``bench.py``,
``chip_smoke.py``): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it itself and nothing is set in code; otherwise the cache lives at one
fixed directory inside the checkout (``<repo>/.jax_cache``, listed in
``.gitignore``).  The path is part of the cache key, so it is never
derived from a temp name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir` and return it.  Sets
    nothing when the environment variable already does."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
