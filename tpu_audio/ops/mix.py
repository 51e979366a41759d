"""Block mixing math: pan law, predelay + residual overlap-add, dry mix.

Semantics match the reference's output stage (reference src/conv.cu:89-140,
386-427) and are golden-tested against it:

  - pan law (src/conv.cu:386-389):   gainL = pan >= 0 ? 1 - pan : 1
                                     gainR = pan <= 0 ? 1 + pan : 1
  - wet assembly (f_pointwiseAdd, src/conv.cu:89-100):
        out[s] = clamp(residual[s] + (s >= predelay ? wet[s - predelay] : 0),
                       -1, 1)
  - dry mix (f_addDryInterleaved, src/conv.cu:126-140): both input channels
    mix into both outputs, each with its own dry·pan·level gains, added
    UNclamped after the wet clamp, over the first nframes only.

Deliberate fix vs the reference: the reference writes only fftSize samples of
the extended (fftSize + maxPredelay) output buffer (src/conv.cu:411 passes
n=_fftSize), silently dropping up to `predelay` samples of wet tail each
block when predelay > the IR's zero padding. Here the delayed wet tail is
carried in full.

All functions are jittable with static shapes; `predelay` may be traced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# the dry 2x2 mix carries the program material itself. HIGH read
# bit-identical output on the GPU (the mix is not a TF32 GEMM at the
# measured shapes); HIGHEST keeps it exact at any shape, at no measured
# cost (PERF.md)
DRY_PRECISION = jax.lax.Precision.HIGHEST


def pan_gains(pan: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Constant-sum pan law over pan in [-1, 1] (reference src/conv.cu:386-389)."""
    pan = jnp.asarray(pan)
    gain_l = jnp.where(pan >= 0, 1.0 - pan, 1.0)
    gain_r = jnp.where(pan <= 0, 1.0 + pan, 1.0)
    return gain_l, gain_r


def delay_and_clamp_add(residual: jnp.ndarray, wet: jnp.ndarray,
                        predelay: jnp.ndarray) -> jnp.ndarray:
    """clamp(residual + wet shifted right by predelay, -1, 1), elementwise
    over the last axis. `wet` is zero-padded at the front; samples pushed
    past the buffer end are dropped only if the caller sized `residual`
    shorter than len(wet) + max predelay.

    residual: [..., E]; wet: [..., W] with W <= E; returns [..., E].
    """
    e = residual.shape[-1]
    w = wet.shape[-1]
    padded = jnp.pad(wet, [(0, 0)] * (wet.ndim - 1) + [(0, e - w)])
    # shift right by `predelay` along the last axis: out[s] = wet[s - predelay]
    idx = jnp.arange(e)
    shifted = jnp.where(idx >= predelay,
                        jnp.roll(padded, predelay, axis=-1),
                        0.0)
    return jnp.clip(residual + shifted, -1.0, 1.0)


def dry_mix_2x2(out_l: jnp.ndarray, out_r: jnp.ndarray,
                in1: jnp.ndarray, in2: jnp.ndarray,
                gains: tuple) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Add dry signal into the first len(in1) samples of both outputs.

    gains = (l1, r1, l2, r2): channel-1 dry gain into L/R, channel-2 dry gain
    into L/R, each already folded as dry·pan·level (reference src/conv.cu:
    417-427). Added after the wet clamp, not re-clamped (reference behaviour).
    """
    l1, r1, l2, r2 = gains
    nb = in1.shape[-1]
    dry_l = in1 * l1 + in2 * l2
    dry_r = in1 * r1 + in2 * r2
    out_l = out_l.at[..., :nb].add(dry_l)
    out_r = out_r.at[..., :nb].add(dry_r)
    return out_l, out_r


def wet_scale(params) -> "jnp.ndarray":
    """[V, I, O] wet output gain: constant-power wet pan x level, shared by
    every engine (reference folds pan*level into the inverse-FFT scale,
    src/conv.cu:392-401)."""
    gl, gr = pan_gains(params.pan_wet)
    return jnp.stack([gl, gr], axis=-1) * params.level[..., None]


def add_dry(out, x, params) -> "jnp.ndarray":
    """Dry 2x2 pan mix added UNCLAMPED after the wet clamp (reference
    kernel order, src/conv.cu:411-427); shared by every engine."""
    gl, gr = pan_gains(params.pan_dry)
    dry_gain = (jnp.stack([gl, gr], axis=-1)
                * (params.dry * params.level)[..., None])
    return out + jnp.einsum("vib,vio->vob", x, dry_gain,
                            precision=DRY_PRECISION)
