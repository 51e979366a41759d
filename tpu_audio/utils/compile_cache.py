"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the app, bench.py, examples/soak.py,
chip_smoke.py): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here sets another directory; otherwise the cache goes
to one fixed path inside the checkout, ``<repo>/.jax_cache`` (listed in
``.gitignore``). The path is part of what makes a later run hit the cache,
so it is never built from a temporary name, a pid or a time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the fixed
    in-checkout default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
