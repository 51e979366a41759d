"""The core algorithm: uniform partitioned overlap-save convolution.

Replaces the reference's per-block monolithic FFT (1 fwd + 2 inv transforms
of fftSize=131072 per 256-frame block, reference src/conv.cu:367-408) with
uniform partitioned overlap-save: the IR lives as P block-sized partition
spectra in device memory, each block pays two small-N (N = 2B) transforms and a
frequency-domain multiply-accumulate over the partition axis. IR length is
unbounded (grow P), which is what makes >4 s IRs possible at 256-frame
latency — the reference caps IRs at fftSize-1024 ≈ 2.95 s.

Two state representations, equivalence-tested against each other and against
the monolithic reference engine:

  - ``materialized``: the active IR spectra are a [V,2,2,P,F] buffer slewed
    toward bank[select]*wet every block — a direct transplant of the
    reference's f_interpolate (src/conv.cu:15-32), which the reference
    itself flags as "one of the most time consuming parts" (conv.cu:337).

  - ``coef`` (default, the batched design): because the slew step is the
    SAME scalar for every bin, the active spectrum is always an affine
    combination  active = a·base + c·bank[select]  of a frozen snapshot
    `base` and the currently selected bank entry. The per-block slew
      active' = active + (bank[sel]·wet − active)·r,  r = 1/(vsteps+5)
    becomes two SCALAR recursions
      a' = a·(1−r),   c' = c·(1−r) + wet·r
    — bit-identical crossfade trajectory, zero spectra traffic. The MAC
    reads base and bank[sel] directly:
      Y = Σ_p fdl[p] ⊙ (a'·base[p] + c'·bank[sel][p]).
    On IR re-select the affine form must be re-based: the HOST (which owns
    the MIDI event that caused the change) calls collapse() between blocks,
    materialising base ← a·base + c·bank[old_sel], a ← 1, c ← 0. Once a
    crossfade has decayed (a ≈ 0, host-computable analytically), the
    steady-state step drops the base term entirely — the hot loop then
    touches only fdl and bank[sel]: the reference's biggest kernel is gone
    from the common case.

Mix/predelay/clamp semantics match the monolithic engine (and the
reference): wet streams from both engine channels mix into both outputs
with pan·level gains; the wet stream is delayed by channel 0's predelay
(reference quirk, src/conv.cu:411-415), clamped to ±1, and the dry mix is
added unclamped. The partitioned wet path computes the exact linear
convolution, so it equals the monolithic residual accumulation whenever the
wet stream stays inside ±1 (clamping partial sums differs only in clip).

Crossfade semantics — documented deviation from the reference: with a
TIME-VARYING IR the two convolution structures differ mid-fade. The
reference/monolithic engine is *input-synchronous* (each input block is
convolved once with the IR snapshot at its arrival time; its tail is frozen
into the residual), while partitioned OLS is *output-synchronous* (every
output block recombines the past P input spectra with the CURRENT IR). The
coef form makes the partitioned behaviour explicit: the output is an
output-domain blend  a_t·(x ⊛ base) + c_t·(x ⊛ bank[sel])  whose blend
weights follow the reference's exact exponential slew recursion — i.e. the
industry-standard two-slot output crossfade, with the reference's fade
curve. Both semantics are click-free, coincide whenever the IR is not
actively fading (a steady `wet` included, since wet folds into c), and
converge to identical steady states; the two partitioned variants are
bit-equivalent to each other at all times (tests/test_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp

from tpu_audio.engine.params import VoiceParams
from tpu_audio.ops.fft import SpectralTransform
from tpu_audio.ops.mix import add_dry, pan_gains, wet_scale
from tpu_audio.ops.smoother import slew_spectra

# precision of the complex MAC and coefficient contractions: this engine is
# the executable semantics reference, so exact f32 (HIGH read the same
# golden error on the GPU, 2.4e-8; PERF.md)
MAC_PRECISION = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclass
class PartitionedState:
    fdl: jax.Array       # complex64 [V, 2, P, F] input-spectra delay line
    prev_in: jax.Array   # float32 [V, 2, B] previous input block (OLS segment)
    wet_ring: jax.Array  # float32 [V, 2, maxPD + B] wet delay ring
    # coef representation (ignored by the materialized variant):
    base: jax.Array      # complex64 [V, 2, 2, P, F] frozen spectra snapshot
    coef_a: jax.Array    # float32 [V, 2] weight of base
    coef_c: jax.Array    # float32 [V, 2] weight of bank[select]
    # materialized representation (None/zeros in coef variant):
    active: jax.Array    # complex64 [V, 2, 2, P, F] slewed spectra


class PartitionedConvolution:
    """V stereo voices of partitioned-OLS convolution reverb."""

    def __init__(self, num_voices: int, block: int, partitions: int,
                 max_predelay: int = 8192, backend: str = "auto",
                 variant: str = "coef"):
        if variant not in ("coef", "materialized"):
            raise ValueError(f"unknown variant {variant!r}")
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions
        self.max_predelay = max_predelay
        self.variant = variant
        self.xf = SpectralTransform(2 * block, backend=backend)
        self.num_bins = self.xf.num_bins
        self.ring = max_predelay + block

    # -- offline / cloning interface ------------------------------------------------

    def with_voices(self, num_voices: int) -> "PartitionedConvolution":
        """Same geometry/variant at another voice count; banks are
        voice-independent (the runtime/offline.py renderer seam)."""
        return PartitionedConvolution(
            num_voices, self.block, self.partitions,
            max_predelay=self.max_predelay, backend=self.xf.backend,
            variant=self.variant)

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output
        block at converged params (fdl depth + predelay ring + margin);
        see fmajor.history_blocks for the offline-renderer contract."""
        return self.partitions + self.max_predelay // self.block + 3

    # -- state ---------------------------------------------------------------------
    #
    # State constructors are jitted: complex buffers must be DEVICE-generated
    # — eagerly-created complex constants require a complex host->device
    # transfer, which some backends lack entirely (see
    # tpu_audio.utils.transfer).

    def _zeros(self, with_active: bool, with_base: bool) -> PartitionedState:
        v, b, p, f = self.num_voices, self.block, self.partitions, self.num_bins
        spectra = (v, 2, 2, p, f)
        return PartitionedState(
            fdl=jnp.zeros((v, 2, p, f), jnp.complex64),
            prev_in=jnp.zeros((v, 2, b), jnp.float32),
            wet_ring=jnp.zeros((v, 2, self.ring), jnp.float32),
            base=jnp.zeros(spectra if with_base else (v, 2, 2, 1, 1), jnp.complex64),
            coef_a=jnp.zeros((v, 2), jnp.float32),
            coef_c=jnp.zeros((v, 2), jnp.float32),
            active=jnp.zeros(spectra if with_active else (v, 2, 2, 1, 1), jnp.complex64),
        )

    def init_state(self) -> PartitionedState:
        """Zero state: crossfade slews up from silence (reference behaviour
        with zeroed buffers)."""
        from tpu_audio.utils.jitcache import instance_cached

        return instance_cached(self, "init_state", lambda: jax.jit(
            lambda: self._zeros(
                with_active=self.variant == "materialized",
                with_base=self.variant == "coef")))()

    def init_converged(self, bank: jax.Array, params: VoiceParams) -> PartitionedState:
        """Crossfade pre-settled at bank[select]*wet."""

        def build(bank, params):
            state = self._zeros(with_active=self.variant == "materialized",
                                with_base=self.variant == "coef")
            if self.variant == "coef":
                # active = 0·base + wet·bank[sel]; +0.0 forces a fresh buffer
                # (the state is donated per block; aliasing params.wet would
                # invalidate the caller's params)
                return replace(state,
                               coef_c=params.wet.astype(jnp.float32) + 0.0)
            target = jnp.take(bank, params.select, axis=0)
            active = target * params.wet[..., None, None, None]
            return replace(state, active=active.astype(jnp.complex64))

        from tpu_audio.utils.jitcache import instance_cached

        return instance_cached(self, "init_converged",
                               lambda: jax.jit(build))(bank, params)

    # -- shared pieces -----------------------------------------------------------------

    def _analyze(self, state: PartitionedState, x: jax.Array):
        """OLS segment FFT + frequency-domain delay-line push."""
        seg = jnp.concatenate([state.prev_in, x], axis=-1)      # [V, 2, 2B]
        spec = self.xf.rfft(seg)                                 # [V, 2, F]
        fdl = jnp.roll(state.fdl, 1, axis=2).at[:, :, 0].set(spec)
        return fdl

    def _wet_scale(self, params: VoiceParams) -> jax.Array:
        return wet_scale(params)                                  # [V,2,2]

    def _finish(self, state: PartitionedState, params: VoiceParams,
                x: jax.Array, spec_out: jax.Array, **updates):
        """Inverse transform, predelay accumulation ring, clamp, dry mix.

        The ring is a future-output accumulator (the residual buffer's moral
        equivalent): each block's wet lands at offset `predelay`, so a
        predelay change affects only NEW wet — exactly the reference's
        residual semantics (src/conv.cu:89-100,440-451), where already
        accumulated tail keeps its old delay.
        """
        b = self.block
        wet = self.xf.irfft(spec_out)[..., b:]                  # [V, 2, B] OLS tail

        # shift the accumulator left by one block, zero-fill the far end
        ring = jnp.concatenate(
            [state.wet_ring[..., b:],
             jnp.zeros(state.wet_ring.shape[:-1] + (b,), jnp.float32)], axis=-1)

        # scatter-add wet at offset pd (reference quirk: channel 0's predelay
        # applies to both outputs, src/conv.cu:411-415)
        pd = params.predelay[:, 0]

        def _add_at(r, w, s):
            cur = jax.lax.dynamic_slice_in_dim(r, s, b, axis=-1)
            return jax.lax.dynamic_update_slice_in_dim(r, cur + w, s, axis=-1)

        ring = jax.vmap(_add_at)(ring, wet, pd)

        out = add_dry(jnp.clip(ring[..., :b], -1.0, 1.0), x, params)

        new_state = replace(state, prev_in=x, wet_ring=ring, **updates)
        return new_state, out

    # -- hot steps -----------------------------------------------------------------------

    def step(self, state: PartitionedState, bank: jax.Array, params: VoiceParams,
             x: jax.Array) -> tuple[PartitionedState, jax.Array]:
        if self.variant == "coef":
            return self.step_coef(state, bank, params, x)
        return self.step_materialized(state, bank, params, x)

    def step_materialized(self, state, bank, params, x):
        """Reference-transplant variant: slew full spectra, single MAC."""
        fdl = self._analyze(state, x)
        target = jnp.take(bank, params.select, axis=0)           # [V,2,2,P,F]
        active = slew_spectra(
            state.active, target,
            params.wet[..., None, None, None], params.vsteps[..., None, None, None])
        scale = self._wet_scale(params).astype(jnp.complex64)
        spec_out = jnp.einsum("vipf,viopf,vio->vof", fdl, active, scale,
                              precision=MAC_PRECISION)
        return self._finish(state, params, x, spec_out, fdl=fdl, active=active)

    def step_coef(self, state, bank, params, x,
                  with_base: bool = True):
        """Affine-coefficient variant: scalar slew, MAC over base+bank[sel]."""
        fdl = self._analyze(state, x)
        r = 1.0 / (params.vsteps.astype(jnp.float32) + 5.0)      # [V, 2]
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = self._wet_scale(params)                          # [V, 2, 2]

        target = jnp.take(bank, params.select, axis=0)           # [V,2,2,P,F]
        hi = MAC_PRECISION
        mac_sel = jnp.einsum("vipf,viopf->viof", fdl, target, precision=hi)
        spec_out = jnp.einsum("viof,vio->vof", mac_sel,
                              (c[..., None] * scale).astype(jnp.complex64),
                              precision=hi)
        if with_base:
            mac_base = jnp.einsum("vipf,viopf->viof", fdl, state.base,
                                  precision=hi)
            spec_out = spec_out + jnp.einsum(
                "viof,vio->vof", mac_base,
                (a[..., None] * scale).astype(jnp.complex64), precision=hi)
        return self._finish(state, params, x, spec_out,
                            fdl=fdl, coef_a=a, coef_c=c)

    def step_coef_steady(self, state, bank, params, x):
        """Steady-state hot path: crossfade fully decayed (coef_a ≈ 0), the
        base term is skipped — per-block HBM traffic is fdl + bank[select]
        only. The host switches to this variant once it has analytically
        determined a < threshold (see runtime.stream)."""
        return self.step_coef(state, bank, params, x, with_base=False)

    # -- rare path ------------------------------------------------------------------------

    def collapse(self, state: PartitionedState, bank: jax.Array,
                 old_select: jax.Array, changed: jax.Array) -> PartitionedState:
        """Re-base the affine form after an IR re-select (host-triggered,
        between blocks): base ← a·base + c·bank[old_select] where `changed`,
        so the scalar recursion continues from the exact current spectrum.

        old_select/changed: [V, 2] — the selection BEFORE the change and a
        mask of which (voice, channel) re-selected this block.
        """
        old_target = jnp.take(bank, old_select, axis=0)
        collapsed = (state.coef_a[..., None, None, None] * state.base
                     + state.coef_c[..., None, None, None] * old_target)
        mask = changed[..., None, None, None]
        return replace(
            state,
            base=jnp.where(mask, collapsed, state.base),
            coef_a=jnp.where(changed, 1.0, state.coef_a),
            coef_c=jnp.where(changed, 0.0, state.coef_c),
        )
