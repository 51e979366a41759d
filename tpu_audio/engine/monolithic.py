"""Reference-parity engine: monolithic-FFT overlap-add convolution.

This is the reference algorithm (reference src/conv.cu:287-466) re-expressed
as a pure jitted state-threading function — one full-size spectrum per IR,
one forward + inverse transform per block, spectral slew crossfade, predelay
+ residual overlap-add with clamping, 2x2 wet/dry mix. It exists for

  1. golden parity: it is the executable specification the partitioned
     engine is equivalence-tested against (same slew trajectory, same mix
     math), and
  2. small-IR configs where a single FFT is perfectly fine.

Deviations from the reference (documented, deliberate):
  - batched rfft per channel instead of the 2-channels-in-1-complex-FFT
    packing trick (half the spectrum, no unpack pass; the packing ops live
    in tpu_audio.ops.hermitian for parity tests);
  - the extended output tail is carried in full: the reference writes only
    fftSize of its fftSize+8192 output buffer (src/conv.cu:411), dropping up
    to `predelay` samples of wet tail per block;
  - voices are batched [V, ...] — the reference runs one instance per
    stereo pair.

Kept reference quirks: channel 0's predelay is applied to BOTH outputs
(src/conv.cu:411-415 passes cc[0].value.predelay twice); the wet clamp runs
before the dry add and the dry add is not re-clamped (src/conv.cu:417-427).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from tpu_audio.engine.params import VoiceParams
from tpu_audio.ops.fft import SpectralTransform
from tpu_audio.ops.mix import delay_and_clamp_add, pan_gains
from tpu_audio.ops.smoother import slew_spectra

# precision of the complex wet MAC and the dry 2x2 mix: this engine is the
# reference oracle, so exact f32. HIGH read the same golden error on the
# GPU (3.3e-8) and no lower cost (PERF.md)
MAC_PRECISION = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclass
class MonolithicState:
    active: jax.Array    # complex64 [V, 2, 2, Fm] slewed IR spectra
    residual: jax.Array  # float32 [V, 2, E] overlap-add tail, E = N + maxPD


class MonolithicConvolution:
    """V stereo voices of reference-style convolution reverb."""

    def __init__(self, num_voices: int, fft_size: int, block: int = 256,
                 max_predelay: int = 8192, backend: str = "auto"):
        if block >= fft_size:
            raise ValueError("block must be < fft_size")
        self.num_voices = num_voices
        self.fft_size = fft_size
        self.block = block
        self.max_predelay = max_predelay
        self.xf = SpectralTransform(fft_size, backend=backend)
        self.num_bins = self.xf.num_bins
        self.ext = fft_size + max_predelay

    # -- offline / cloning interface ----------------------------------------------

    def with_voices(self, num_voices: int) -> "MonolithicConvolution":
        """Same geometry at another voice count; banks are
        voice-independent (the runtime/offline.py renderer seam)."""
        return MonolithicConvolution(
            num_voices, self.fft_size, self.block,
            max_predelay=self.max_predelay, backend=self.xf.backend)

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output
        block at converged params: the residual carry spans
        fft_size + max_predelay samples (see fmajor.history_blocks for
        the offline-renderer contract)."""
        return -(-self.ext // self.block) + 2

    # -- state ------------------------------------------------------------------

    # jitted so complex buffers are device-generated (some backends cannot
    # transfer eagerly-created complex constants; see utils.transfer)
    def init_state(self) -> MonolithicState:
        from tpu_audio.utils.jitcache import instance_cached

        v, fm = self.num_voices, self.num_bins
        return instance_cached(self, "init_state", lambda: jax.jit(
            lambda: MonolithicState(
                active=jnp.zeros((v, 2, 2, fm), jnp.complex64),
                residual=jnp.zeros((v, 2, self.ext), jnp.float32),
            )))()

    def init_converged(self, bank: jax.Array, params: VoiceParams) -> MonolithicState:
        """State with the crossfade already settled at bank[select]*wet
        (skips the reference's silence fade-in from zero-initialised
        spectra)."""

        from tpu_audio.utils.jitcache import instance_cached

        def build(bank, params):
            target = jnp.take(bank, params.select, axis=0)  # [V, 2, 2, Fm]
            active = target * params.wet[..., None, None]
            return MonolithicState(
                active=active.astype(jnp.complex64),
                residual=jnp.zeros((self.num_voices, 2, self.ext), jnp.float32))

        return instance_cached(self, "init_converged",
                               lambda: jax.jit(build))(bank, params)

    # -- hot step ------------------------------------------------------------------

    def step(self, state: MonolithicState, bank: jax.Array, params: VoiceParams,
             x: jax.Array) -> tuple[MonolithicState, jax.Array]:
        """One audio block.

        state, bank [K, 2, Fm], params, x [V, 2, B] ->
        (state', out [V, 2, B]).
        """
        v, b, n = self.num_voices, self.block, self.fft_size

        # input spectra: zero-padded block FFT (reference conv.cu:321-328,367)
        xpad = jnp.pad(x, ((0, 0), (0, 0), (0, n - b)))
        spec_in = self.xf.rfft(xpad)  # [V, 2, Fm]

        # spectral slew toward bank[select]*wet (reference f_interpolate,
        # conv.cu:339-353); uniform per-bin step
        target = jnp.take(bank, params.select, axis=0)  # [V, 2, 2, Fm]
        active = slew_spectra(
            state.active, target,
            params.wet[..., None, None], params.vsteps[..., None, None])

        # wet mix: both engine channels convolve and mix into both outputs
        # with pan*level scales (conv.cu:386-401); 1/N folds into irfft
        gl, gr = pan_gains(params.pan_wet)            # [V, 2]
        scale = jnp.stack([gl, gr], axis=-1) * params.level[..., None]  # [V,2,2]
        spec_out = jnp.einsum("vif,viof,vio->vof", spec_in, active,
                              scale.astype(jnp.complex64),
                              precision=MAC_PRECISION)
        wet = self.xf.irfft(spec_out)  # [V, 2, N]

        # predelay + residual + clamp (f_pointwiseAdd, conv.cu:89-100,411-415;
        # reference quirk kept: channel 0's predelay for both outputs)
        pd = params.predelay[:, 0]
        out_ext = jax.vmap(delay_and_clamp_add)(state.residual, wet, pd)  # [V,2,E]

        # dry 2x2 mix into the first B samples, not re-clamped
        # (f_addDryInterleaved, conv.cu:417-427)
        dgl, dgr = pan_gains(params.pan_dry)
        dry_gain = (jnp.stack([dgl, dgr], axis=-1)
                    * (params.dry * params.level)[..., None])  # [V, 2, 2]
        dry = jnp.einsum("vib,vio->vob", x, dry_gain,
                         precision=MAC_PRECISION)
        out = out_ext[..., :b] + dry

        residual = jnp.concatenate(
            [out_ext[..., b:], jnp.zeros((v, 2, b), jnp.float32)], axis=-1)
        return MonolithicState(active=active, residual=residual), out
