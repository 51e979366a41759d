"""Accelerator selection and enumeration.

Capability equivalent of the reference's GPU selection (reference
src/gpu.cu:38-90, ``selectGpu``): enumerate devices, pick one, and log a
property table. JAX already orders platforms (a GPU before the CPU) and
enumerates the devices of the chosen one, so "selection" means checking
that the platform is the one asked for and taking its first device for
single-device paths; multi-device scaling goes through tpu_audio.parallel.

The CPU is a platform only on request: ``JAX_PLATFORMS=cpu`` (tests, CI).
Without that request a process that finds no GPU fails loudly instead of
quietly running a real-time server on the host.
"""

from __future__ import annotations

import os

import jax

from tpu_audio.utils.log import Log


def device_summary(device) -> str:
    bits = [f"platform={device.platform}", f"id={device.id}"]
    for attr in ("device_kind", "process_index"):
        val = getattr(device, attr, None)
        if val is not None:
            bits.append(f"{attr}={val}")
    return " ".join(str(b) for b in bits)


def requested_platforms(raw: str | None = None) -> list[str]:
    """Platforms named by `raw`, else by the jax_platforms config or
    JAX_PLATFORMS, lower-cased in order."""
    if raw is None:
        raw = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return [p.strip().lower() for p in raw.split(",") if p.strip()]


def select_device(verbose: bool = True):
    """Return the device single-device paths run on, logging the table.

    Raises RuntimeError when the first device is the CPU but the CPU was
    not requested explicitly, or when a GPU was requested and another
    platform came up."""
    requested = requested_platforms()
    try:
        devices = jax.devices()
    except RuntimeError as exc:
        raise RuntimeError(
            f"no usable device for platforms {requested or 'default'}: "
            f"{exc}") from exc
    best = devices[0]
    platform = best.platform.lower()
    if platform == "cpu" and "cpu" not in requested:
        raise RuntimeError(
            "no GPU found (JAX came up on the CPU); set JAX_PLATFORMS=cpu "
            "to run on the CPU on purpose")
    if {"gpu", "cuda"} & set(requested) and platform not in ("gpu", "cuda"):
        raise RuntimeError(f"GPU requested ({','.join(requested)}) but JAX "
                           f"came up on {platform!r}")
    if verbose:
        Log.info("device", "%d device(s) visible on platform '%s'",
                 len(devices), best.platform)
        for d in devices:
            Log.newline(device_summary(d))
        Log.info("device", "selected: %s", device_summary(best))
    return best
