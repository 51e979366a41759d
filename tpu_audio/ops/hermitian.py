"""Two-real-channels-through-one-complex-FFT packing (Hermitian trick).

Capability equivalent of the reference kernels f_pack2R2C and f_unpackC22R
(reference src/conv.cu:35-73): pack L and R as the real/imag parts of one
complex signal, take a single C2C FFT, and split the two channels' spectra
using Hermitian symmetry:

    L[k] = (V[k] + conj(V[N-k])) / 2
    R[k] = -j (V[k] - conj(V[N-k])) / 2

The engines prefer batched ``rfft`` (half the work with no packing
round-trip — the packing trick exists in the reference because cuFFT C2C was
convenient), but these ops are kept as first-class, tested primitives: they
define the reference's spectral layout, are used in golden tests, and let a
user port reference-style pipelines 1:1.

All functions are jittable and operate on the last axis.
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_2r_to_c(l: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """L + j*R (reference f_pack2R2C, src/conv.cu:35-45)."""
    return jnp.asarray(l) + 1j * jnp.asarray(r)


def _reverse_index(v: jnp.ndarray) -> jnp.ndarray:
    """v[..., (N - k) mod N]."""
    return jnp.roll(jnp.flip(v, axis=-1), 1, axis=-1)


def unpack_c_to_2r(spectrum: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split the FFT of (L + jR) into L and R full-length spectra.

    Reference f_unpackC22R (src/conv.cu:47-73). Vectorised over the full
    spectrum instead of the reference's half-loop + mirror writes; the
    result is identical including the Hermitian mirror halves.
    """
    v = jnp.asarray(spectrum)
    v_neg = jnp.conj(_reverse_index(v))
    left = 0.5 * (v + v_neg)
    right = -0.5j * (v - v_neg)
    return left, right


def full_spectrum_from_half(half: jnp.ndarray, n: int) -> jnp.ndarray:
    """Expand an rfft half-spectrum [..., n//2+1] to the full length-n
    Hermitian spectrum (bins n//2+1.. are conjugate mirrors). Even n
    only (the engines' 2*block transforms are always even)."""
    if n % 2:
        raise ValueError(f"full_spectrum_from_half handles even n only "
                         f"(got {n}): odd-n mirrors include the last bin")
    if half.shape[-1] != n // 2 + 1:
        raise ValueError(f"half-spectrum has {half.shape[-1]} bins, "
                         f"expected n//2+1 = {n // 2 + 1}")
    mirror = jnp.conj(jnp.flip(half[..., 1:-1], axis=-1))
    return jnp.concatenate([half, mirror], axis=-1)


def rfft_via_pack(l: jnp.ndarray, r: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-style spectra of two real channels via one C2C FFT.

    Returns full-length (not half) spectra, matching the reference's layout
    where _irBuffers[idx] holds [L-spectrum | R-spectrum] each of fftSize
    bins (src/conv.cu:246, src/conv.h:77).
    """
    return unpack_c_to_2r(jnp.fft.fft(pack_2r_to_c(l, r), axis=-1))
