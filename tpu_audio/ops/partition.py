"""IR partitioning and spectra precompute.

The reference convolves against one monolithic fftSize-point IR spectrum,
which caps the IR at fftSize - 1024 frames and costs an O(fftSize log fftSize)
FFT per 256-frame block (reference src/conv.cu:207-253,367). This
engine instead uses **uniform partitioned overlap-save**: the IR is split
into P = ceil(L / B) block-sized partitions, each zero-padded to N = 2B and
transformed once at load time; per block the engine pays two small-N
transforms plus a frequency-domain MAC over the partition axis. IR length is
then unbounded (grow P, not the FFT), which is what allows > 4 s IRs.

Spectra layout: [P, F] complex64 per channel with F = N//2 + 1; banks stack
to [K, C, P, F] and live in HBM.
"""

from __future__ import annotations

import numpy as np

from tpu_audio.ops.fft import SpectralTransform


def num_partitions(ir_len: int, block: int) -> int:
    return max(1, -(-ir_len // block))


def partition_ir(ir: np.ndarray, block: int, max_partitions: int | None = None,
                 ) -> np.ndarray:
    """Split a time-domain IR [..., L] into zero-padded partitions
    [..., P, 2*block] (each partition holds `block` IR samples followed by
    `block` zeros, the overlap-save layout)."""
    ir = np.asarray(ir, dtype=np.float32)
    length = ir.shape[-1]
    p = num_partitions(length, block)
    if max_partitions is not None:
        p = min(p, max_partitions)
    padded = np.zeros(ir.shape[:-1] + (p * block,), np.float32)
    keep = min(length, p * block)
    padded[..., :keep] = ir[..., :keep]
    parts = padded.reshape(ir.shape[:-1] + (p, block))
    return np.concatenate(
        [parts, np.zeros(ir.shape[:-1] + (p, block), np.float32)], axis=-1)


def partition_spectra(ir: np.ndarray, block: int,
                      max_partitions: int | None = None,
                      backend: str = "numpy") -> np.ndarray:
    """Time-domain IR [..., L] -> partition spectra [..., P, F] complex64.

    Load-time preprocessing runs host-side in numpy: it is one FFT pass per
    bank load, and device round-trips would require complex host<->device
    transfers some backends lack (see tpu_audio.utils.transfer).
    """
    parts = partition_ir(ir, block, max_partitions)
    if backend == "numpy":
        return np.fft.rfft(parts, axis=-1).astype(np.complex64)
    from tpu_audio.utils.transfer import to_host_maybe_complex
    xf = SpectralTransform(2 * block, backend=backend)
    # planar readback: a raw np.asarray of the device complex result would
    # be the forbidden complex host crossing (utils/transfer.py)
    return to_host_maybe_complex(xf.rfft(parts)).astype(np.complex64)


def monolithic_spectrum(ir: np.ndarray, fft_size: int, reserve: int = 1024,
                        ) -> np.ndarray:
    """Reference-style single spectrum: IR truncated to fft_size - reserve
    frames (reference src/conv.cu:239, default nframes=1024 src/conv.h:63),
    zero-padded to fft_size, full complex spectrum [..., fft_size]."""
    ir = np.asarray(ir, dtype=np.float32)
    keep = min(ir.shape[-1], fft_size - reserve)
    padded = np.zeros(ir.shape[:-1] + (fft_size,), np.float32)
    padded[..., :keep] = ir[..., :keep]
    return np.fft.fft(padded, axis=-1).astype(np.complex64)
