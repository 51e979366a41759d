"""tpu-audio: a real-time audio convolution framework in JAX, run on the GPU.

A from-scratch JAX/XLA rebuild of the capabilities of limitz/cuda-audio
(reference at /root/reference): streaming convolution reverb over banks of
impulse-response WAV files, block-streamed at real-time deadlines, with live
MIDI-style parameter control (IR select with click-free spectral crossfade,
predelay, dry/wet, pan, level, crossfade speed), a settings-file configuration
system, and latency instrumentation.

Architecture (a redesign, not a port):
  - the reference's monolithic-FFT overlap-add on a JACK RT callback
    (reference src/conv.cu:287-466) becomes a jitted, state-threading
    *uniform partitioned overlap-save* engine with device-resident IR partition
    spectra and a frequency-domain multiply-accumulate over the partition axis;
  - per-voice batching via vmap; multi-device scaling via jax.sharding.Mesh +
    shard_map over ('voice', 'part') axes;
  - the host runtime (block transport, deadlines, MIDI framing) lives in
    tpu_audio.runtime with an optional C++ native layer in csrc/.
"""

from tpu_audio.version import __version__

__all__ = ["__version__"]
