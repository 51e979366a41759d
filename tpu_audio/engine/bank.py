"""IR bank: host-side loading + precomputed device spectra.

Capability equivalent of the reference's `_irBuffers` spectra map filled by
``Convolution::prepare`` (reference src/conv.cu:207-253, wired from index
files at src/main.cu:72-81), redesigned for batched device execution:

  - spectra are precomputed ONCE per bank into a single dense HBM array
    ([K, 2, P, F] partition spectra or [K, 2, Fm] monolithic half-spectra)
    so per-block IR selection is a pure gather by traced index — no
    recompile, no host transfer, click-free crossfade via the engine slew;
  - ``prepare(idx, wav)`` supports live per-slot replacement like the
    reference (conv.cu:206 "TODO make thread safe" — here it is: replace is
    a host-side swap of an immutable device array between blocks);
  - spectra banks are cacheable to disk keyed by content+geometry hash
    (the reference recomputes FFTs of all 152 IRs on every startup).

Unlike the reference, which silently shares one `_irBuffers` map between the
two channels of a pair (src/main.cu:74-81 overwrites channel 0's bank with
channel 1's when their index files differ), a bank here is an explicit
object; give two channels the same bank by giving them the same object.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from tpu_audio.io.index import load_index
from tpu_audio.io.wav import WavFile, read_wav
from tpu_audio.ops.partition import monolithic_spectrum, num_partitions, partition_spectra
from tpu_audio.utils.log import Log


def _resample(ir: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Polyphase resample [..., L] (the reference assumes 44.1 kHz and
    would misplay mismatched IRs, src/wav.cu has no rate handling)."""
    if from_rate == to_rate:
        return ir
    try:
        from math import gcd

        from scipy.signal import resample_poly
        g = gcd(from_rate, to_rate)
        return resample_poly(ir, to_rate // g, from_rate // g,
                             axis=-1).astype(np.float32)
    except ImportError:  # linear fallback without scipy
        length = int(round(ir.shape[-1] * to_rate / from_rate))
        xp = np.linspace(0.0, 1.0, ir.shape[-1])
        xq = np.linspace(0.0, 1.0, length)
        return np.stack([np.interp(xq, xp, ch) for ch in ir]).astype(np.float32)


class IRBank:
    """Ordered collection of stereo IRs with precomputed spectra."""

    def __init__(self, sample_rate: int = 44100):
        self.sample_rate = sample_rate
        self._irs: list[np.ndarray] = []  # each [2, L] float32
        self._paths: list[str] = []

    # -- construction ------------------------------------------------------------

    @classmethod
    def from_index(cls, index_path: str | os.PathLike, sample_rate: int = 44100,
                   root: str | os.PathLike | None = None,
                   max_seconds: float | None = None,
                   verbose: bool = True) -> "IRBank":
        bank = cls(sample_rate)
        for path in load_index(index_path, root=root):
            bank.append(read_wav(path, verbose=verbose), max_seconds=max_seconds)
        return bank

    def append(self, wav: WavFile | np.ndarray, path: str = "",
               max_seconds: float | None = None) -> int:
        idx = len(self._irs)
        self._insert(idx, wav, path, max_seconds)
        return idx

    def extend(self, other: "IRBank") -> int:
        """Concatenate another bank's entries after this one's (the merged-K
        layout behind per-channel banks); returns the offset of the first
        appended entry."""
        offset = len(self._irs)
        self._irs.extend(other._irs)
        self._paths.extend(other._paths)
        return offset

    def prepare(self, idx: int, wav: WavFile | np.ndarray, path: str = "",
                max_seconds: float | None = None) -> None:
        """Replace/extend slot `idx` (reference prepare, src/conv.cu:207-253)."""
        while len(self._irs) <= idx:
            self._irs.append(np.zeros((2, 1), np.float32))
            self._paths.append("")
        self._insert(idx, wav, path, max_seconds)

    def _insert(self, idx: int, wav, path: str, max_seconds: float | None):
        if isinstance(wav, WavFile):
            ir = np.ascontiguousarray(wav.stereo().T, dtype=np.float32)
            path = path or wav.path
            if wav.sample_rate != self.sample_rate:
                ir = _resample(ir, wav.sample_rate, self.sample_rate)
                Log.info("bank", "resampled IR %s: %d Hz -> %d Hz",
                         path, wav.sample_rate, self.sample_rate)
        else:
            ir = np.asarray(wav, dtype=np.float32)
            if ir.ndim == 1:
                ir = np.stack([ir, ir])
        if max_seconds is not None:
            ir = ir[:, : int(max_seconds * self.sample_rate)]
        if idx < len(self._irs):
            self._irs[idx] = ir
            self._paths[idx] = path
        else:
            self._irs.append(ir)
            self._paths.append(path)

    # -- introspection -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._irs)

    @property
    def paths(self) -> list[str]:
        return list(self._paths)

    def ir(self, idx: int) -> np.ndarray:
        return self._irs[idx]

    @property
    def max_length(self) -> int:
        return max((ir.shape[-1] for ir in self._irs), default=1)

    def max_partitions(self, block: int) -> int:
        return num_partitions(self.max_length, block)

    # -- conditioning -----------------------------------------------------------

    def normalize(self, mode: str = "energy", target: float = 0.125) -> None:
        """Equalise IR loudness across the bank so switching IRs does not jump
        the wet level (the reference plays IRs at raw file scale; the Voxengo
        and EchoThief sets differ by many dB).

        mode="energy": each IR is scaled so sum(ir^2) == target^2 * length
        (equal RMS); mode="peak": scaled to peak == target.
        """
        for i, ir in enumerate(self._irs):
            if mode == "energy":
                rms = float(np.sqrt(np.mean(ir.astype(np.float64) ** 2)))
                gain = target / max(rms, 1e-12)
            elif mode == "peak":
                gain = target / max(float(np.abs(ir).max()), 1e-12)
            else:
                raise ValueError(f"unknown normalize mode {mode!r}")
            self._irs[i] = (ir * np.float32(gain))

    def spectral_taper(self, fft_size: int | None = None) -> None:
        """Apply the reference's (disabled) cube-root-Hamming spectral taper
        to every IR (reference f_lowpass, src/conv.cu:76-87, compiled out at
        src/conv.cu:373-384): H'(f) = H(f) * cbrt(0.54 - 0.46*cos(2*pi*f/N)).

        The reference applied it per-block to the monolithic spectrum; here
        it is (equivalently, since it is a fixed linear filter) baked into
        the time-domain IRs once at load time, so every engine gets it for
        free. `fft_size` controls taper resolution (default: next pow2 of
        the longest IR). IRs keep their length: the circular wrap tail of
        the (very short) taper kernel is dropped, an approximation below
        ~-60 dB; pass fft_size == IR length for exact circular semantics.
        """
        n = fft_size or 1 << max(int(np.ceil(np.log2(max(self.max_length, 2)))), 4)
        freqs = np.arange(n // 2 + 1)
        taper = np.cbrt(0.54 - 0.46 * np.cos(2.0 * np.pi * freqs / n))
        for i, ir in enumerate(self._irs):
            spec = np.fft.rfft(ir, n=n, axis=-1) * taper
            self._irs[i] = np.fft.irfft(spec, n=n, axis=-1)[
                ..., : ir.shape[-1]].astype(np.float32)

    # -- spectra -----------------------------------------------------------------

    def partitioned_spectra(self, block: int,
                            max_partitions: int | None = None,
                            backend: str = "numpy",
                            offset: int = 0) -> np.ndarray:
        """[K, 2, P, F] complex64 uniform partition spectra (F = block + 1).

        Every IR is padded to the bank-wide partition count so selection is
        a plain gather; zero partitions cost only the bank's HBM footprint,
        never per-block compute beyond the uniform MAC. ``offset`` skips the
        IRs' first samples (the cascade engine's tail stage partitions
        ir[offset:] at a larger block size)."""
        p = max_partitions or num_partitions(
            max(self.max_length - offset, 1), block)
        # Deliberately a per-IR loop: numpy's pocketfft runs rfft on a 3-D
        # [2, P, 2B] array ~100x faster than one batched 4-D [K, 2, P, 2B]
        # call on this host (measured 0.09 s vs 9.3 s for 16 x 4 s IRs) —
        # do NOT "optimize" this into a single batched transform.
        out = np.zeros((len(self._irs), 2, p, block + 1), np.complex64)
        for i, ir in enumerate(self._irs):
            spec = partition_spectra(ir[..., offset:], block,
                                     max_partitions=p, backend=backend)
            out[i, :, : spec.shape[1]] = spec
        return out

    def monolithic_spectra(self, fft_size: int, reserve: int = 1024) -> np.ndarray:
        """[K, 2, fft_size//2+1] complex64 half-spectra, IRs truncated to
        fft_size - reserve (reference src/conv.cu:239)."""
        fm = fft_size // 2 + 1
        out = np.zeros((len(self._irs), 2, fm), np.complex64)
        for k, ir in enumerate(self._irs):
            full = monolithic_spectrum(ir, fft_size, reserve)
            out[k] = full[..., :fm]
        return out

    # -- disk cache -----------------------------------------------------------------

    def _cache_key(self, kind: str, *geometry) -> str:
        h = hashlib.sha256()
        h.update(repr((kind, geometry, self.sample_rate)).encode())
        for ir in self._irs:
            # per-IR shape separators: without them two banks whose IR
            # lists concatenate to the same byte stream (different splits
            # of the same sample data) would collide to one entry
            h.update(repr(np.asarray(ir).shape).encode())
            h.update(np.ascontiguousarray(ir).tobytes())
        return h.hexdigest()[:24]

    def cached_partitioned_spectra(self, block: int, cache_dir: str | os.PathLike,
                                   max_partitions: int | None = None,
                                   offset: int = 0) -> np.ndarray:
        """partitioned_spectra with a content-addressed disk cache.

        Raw .npy (mmap'd on read), not .npz: python's zipfile layer reads
        multi-hundred-MB entries at single-digit MB/s on a 1-core host
        (CRC + chunked copies). Legacy .npz entries are still honoured."""
        os.makedirs(cache_dir, exist_ok=True)
        key = self._cache_key("part", block, max_partitions, offset)
        base = os.path.join(os.fspath(cache_dir), f"bank_{key}")
        if os.path.exists(base + ".npy"):
            Log.info("bank", "spectra cache hit: %s.npy", base)
            return np.load(base + ".npy", mmap_mode="r")
        if os.path.exists(base + ".npz"):
            Log.info("bank", "spectra cache hit: %s.npz", base)
            return np.load(base + ".npz")["spectra"]
        spectra = self.partitioned_spectra(block, max_partitions,
                                           offset=offset)
        tmp = base + ".tmp.npy"
        np.save(tmp, spectra)
        os.replace(tmp, base + ".npy")
        Log.info("bank", "spectra cache write: %s.npy", base)
        return spectra
