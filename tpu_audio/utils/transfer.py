"""Host<->device transfers that move complex arrays as planar f32 pairs.

Some PJRT backends support complex64 *compute* but not complex64
host<->device *transfers*. All framework transfer paths route through
these helpers: complex arrays move as planar float32 re/im pairs and are
combined/split on the device, which costs one fused elementwise op and
nothing else. (The CUDA backend transfers complex64 directly; whether the
helpers can go is an open ROADMAP item.)
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def device_put_maybe_complex(x, sharding=None):
    """device_put that stages complex arrays as two f32 transfers.

    Accepts host values AND device-resident jax.Arrays: a device complex
    leaf is split on-device (jit) rather than read back — ``np.asarray``
    on it would itself be the forbidden complex host crossing."""
    if isinstance(x, jax.Array):
        if not jnp.iscomplexobj(x):
            return jax.device_put(x, sharding) if sharding is not None else x
        re, im = jax.jit(lambda v: (jnp.real(v), jnp.imag(v)))(x)
        if sharding is not None:
            re = jax.device_put(re, sharding)
            im = jax.device_put(im, sharding)
            return jax.jit(jax.lax.complex, out_shardings=sharding)(re, im)
        return jax.jit(jax.lax.complex)(re, im)
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        return jax.device_put(x, sharding) if sharding is not None else \
            jax.device_put(x)
    re = np.ascontiguousarray(x.real, dtype=np.float32)
    im = np.ascontiguousarray(x.imag, dtype=np.float32)
    if sharding is not None:
        re_d = jax.device_put(re, sharding)
        im_d = jax.device_put(im, sharding)
        return jax.jit(jax.lax.complex, out_shardings=sharding)(re_d, im_d)
    re_d = jax.device_put(re)
    im_d = jax.device_put(im)
    return jax.jit(jax.lax.complex)(re_d, im_d)


def to_host_maybe_complex(x) -> np.ndarray:
    """Device->host read that splits complex arrays on-device first."""
    if not jnp.iscomplexobj(x):
        return np.asarray(x)
    re, im = jax.jit(lambda v: (jnp.real(v), jnp.imag(v)))(x)
    return np.asarray(re) + 1j * np.asarray(im).astype(np.complex64)


def tree_device_put_maybe_complex(tree, shardings=None):
    """device_put a pytree, staging complex leaves as f32 pairs."""
    if shardings is None:
        return jax.tree.map(device_put_maybe_complex, tree)
    return jax.tree.map(device_put_maybe_complex, tree, shardings)


def tree_to_host_maybe_complex(tree):
    return jax.tree.map(to_host_maybe_complex, tree)
