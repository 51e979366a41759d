"""Per-instance memoization of built (jitted) callables.

``jax.jit`` caches traces on the *wrapper object*: a wrapper created fresh
inside a method re-traces, re-lowers, and — on remote backends — re-LOADS
the executable on every call even though the compilation itself hits the
persistent cache, which turns per-call setup (e.g. the offline bounce's
per-rep engine init) into pure overhead. Rule of thumb: never write
``jax.jit(...)`` inside a function that runs per block/bounce — build once,
memoize here, call many.

The cache lives in the instance ``__dict__`` (engines are plain mutable
dataclasses), so it follows the object: the offline renderer's memoized
virtual engines keep their warmed functions across bounces, and a
short-lived engine drops its cache with itself.
"""

from __future__ import annotations


def instance_cached(obj, key, builder):
    """Return ``builder()`` memoized on ``obj`` under ``key``.

    ``key`` must capture every closure-baked configuration of the built
    callable (shapes, static flags, mesh identity) — the instance itself
    scopes engine geometry, so per-engine constants can stay out of it.
    """
    cache = obj.__dict__.setdefault("_instance_jit_cache", {})
    if key not in cache:
        cache[key] = builder()
    return cache[key]
