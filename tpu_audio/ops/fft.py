"""Real FFT transforms behind one static-shape API, three backends.

The reference leans on cuFFT C2C (reference src/conv.cu:181-194,367,405-408).
Every engine reaches its transforms through ``SpectralTransform``:

  - ``fft``:    jnp.fft.rfft/irfft — XLA's FFT, which is cuFFT on an
                NVIDIA GPU.
  - ``matmul``: DFT-as-matmul against precomputed cos/sin twiddle matrices:
                X = x @ [C | S], x = X_re @ Ci + X_im @ Si. ~57x the FLOPs
                of an FFT at n=512 and O(n^2) twiddle bytes.
  - ``split``:  four-step (Bailey) FFT: n = n1*n2, DFT_n1 as a matmul, an
                [n1, n2] twiddle multiply, DFT_n2 as a matmul, all in
                planar-real f32. O(n*(n1+n2)) MACs with KB-sized tables.

``backend="auto"`` takes the per-size winner measured on the card
(``AUTO_BACKENDS``; PERF.md has both numbers for each size), and ``fft``
for sizes that were not measured. The matmul forms run their contractions
at ``MATMUL_PRECISION``.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# backend per transform size under backend="auto", each the winner inside
# the jitted steady step on the H100 (PERF.md has both numbers per size):
# 512 (fmajor and the cascade head) and 8192 (the cascade tail at ratio
# 16) take cuFFT; 131072 (the monolithic reference engine, two transforms
# of batch 2 per block) takes the four-step split, 36% faster there
AUTO_BACKENDS = {512: "fft", 8192: "fft", 131072: "split"}
# the matmul and split forms' contractions: HIGH is TF32 on the GPU
# (~4e-4 relative spectrum error); HIGHEST is f32-exact (~8e-7) and the
# split form still beats cuFFT at 131072 with it
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def auto_backend(n: int) -> str:
    """The backend ``backend="auto"`` resolves to at size n."""
    return AUTO_BACKENDS.get(n, "fft")


@lru_cache(maxsize=16)
def _twiddles_fwd(n: int) -> tuple[np.ndarray, np.ndarray]:
    """[n, n//2+1] cos/-sin matrices: X = x @ (C + jS)."""
    f = n // 2 + 1
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(f, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * m / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=16)
def _twiddles_inv(n: int) -> tuple[np.ndarray, np.ndarray]:
    """[n//2+1, n] inverse matrices folding Hermitian weights and 1/n:
    x = X_re @ Ci + X_im @ Si."""
    f = n // 2 + 1
    m = np.arange(f, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * m * k / n
    w = np.full((f, 1), 2.0, dtype=np.float64)
    w[0, 0] = 1.0
    if n % 2 == 0:
        w[-1, 0] = 1.0
    ci = (np.cos(ang) * w / n).astype(np.float32)
    si = (-np.sin(ang) * w / n).astype(np.float32)
    return ci, si


def _split_factors(n: int) -> tuple[int, int]:
    """n = n1 * n2 with n1 <= n2, both powers of two, as square as
    possible (minimizes n1 + n2, the per-sample MAC count)."""
    half_bits = (n.bit_length() - 1) // 2
    n1 = 1 << half_bits
    return n1, n // n1


@lru_cache(maxsize=16)
def _twiddles_split_fwd(n: int):
    """Four-step forward tables: stage-1 DFT_{n1} [n1, n1], the [n1, n2]
    inter-stage twiddle, and stage-2 DFT_{n2} [n2, n2/2+1] (only k2 <=
    n2/2 is computed: output bin k = k2*n1 + k1 <= n/2 implies it)."""
    n1, n2 = _split_factors(n)
    j1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    a1 = -2.0 * np.pi * np.outer(j1, j1) / n1          # [j1, k1]
    tw = -2.0 * np.pi * np.outer(j1, j2) / n           # [k1, j2]
    a2 = -2.0 * np.pi * np.outer(j2, j2[: n2 // 2 + 1]) / n2  # [j2, k2]
    return (np.cos(a1).astype(np.float32), np.sin(a1).astype(np.float32),
            np.cos(tw).astype(np.float32), np.sin(tw).astype(np.float32),
            np.cos(a2).astype(np.float32), np.sin(a2).astype(np.float32))


@lru_cache(maxsize=16)
def _twiddles_split_inv(n: int):
    """Four-step inverse tables over the HALF spectrum: Hermitian symmetry
    is folded into per-bin weights (x = Re sum_{k<=n/2} w_k X[k] e^{2pi i
    jk/n}, w = [1, 2, .., 2, 1]/n), so the k2 axis only spans n2/2+1 rows
    and no spectrum mirror (a minor-axis reverse) is ever materialized.
    Stage-1
    iDFT over k2 [n2/2+1, n2], twiddle [j2, k1], stage-2 iDFT over k1
    [n1, n1]; the real part of stage 2 is the signal."""
    n1, n2 = _split_factors(n)
    k1 = np.arange(n1, dtype=np.float64)
    k2h = np.arange(n2 // 2 + 1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    b2 = 2.0 * np.pi * np.outer(k2h, j2) / n2          # [k2, j2]
    tw = 2.0 * np.pi * np.outer(j2, k1) / n            # [j2, k1]
    b1 = 2.0 * np.pi * np.outer(k1, k1) / n1           # [k1, j1]
    return (np.cos(b2).astype(np.float32), np.sin(b2).astype(np.float32),
            np.cos(tw).astype(np.float32), np.sin(tw).astype(np.float32),
            np.cos(b1).astype(np.float32), np.sin(b1).astype(np.float32))


def _cmatmul(ar, ai, br, bi):
    """(ar + i*ai) @ (br + i*bi) as four real matmuls."""
    return (jnp.matmul(ar, br, precision=MATMUL_PRECISION)
            - jnp.matmul(ai, bi, precision=MATMUL_PRECISION),
            jnp.matmul(ar, bi, precision=MATMUL_PRECISION)
            + jnp.matmul(ai, br, precision=MATMUL_PRECISION))


class SpectralTransform:
    """Static-size rfft/irfft over the last axis: [..., n] <-> [..., n//2+1]."""

    def __init__(self, n: int, backend: str = "auto"):
        if n & (n - 1):
            raise ValueError(f"fft size must be a power of two, got {n}")
        if backend == "auto":
            backend = auto_backend(n)
        if backend not in ("fft", "matmul", "split"):
            raise ValueError(f"unknown backend {backend!r}")
        self.n = n
        self.num_bins = n // 2 + 1
        self.backend = backend

    def rfft(self, x: jnp.ndarray) -> jnp.ndarray:
        """float32 [..., n] -> complex64 [..., n//2+1]."""
        if self.backend == "fft":
            return jnp.fft.rfft(x, axis=-1)
        if self.backend == "split":
            return self._rfft_split(x)
        c, s = _twiddles_fwd(self.n)
        xf = x.astype(jnp.float32)
        re = jnp.matmul(xf, c, precision=MATMUL_PRECISION)
        im = jnp.matmul(xf, s, precision=MATMUL_PRECISION)
        return jax.lax.complex(re, im)

    def irfft(self, spec: jnp.ndarray) -> jnp.ndarray:
        """complex64 [..., n//2+1] -> float32 [..., n]."""
        if self.backend == "fft":
            return jnp.fft.irfft(spec, n=self.n, axis=-1)
        if self.backend == "split":
            return self._irfft_split(spec)
        ci, si = _twiddles_inv(self.n)
        re = jnp.real(spec)
        im = jnp.imag(spec)
        return (jnp.matmul(re, ci, precision=MATMUL_PRECISION)
                + jnp.matmul(im, si, precision=MATMUL_PRECISION))

    def _rfft_split(self, x: jnp.ndarray) -> jnp.ndarray:
        """Four-step: X[k2*n1 + k1] = DFT_{n2,j2}( tw[k1,j2] *
        DFT_{n1,j1}(x[j1*n2 + j2]) ). Real input; planar-f32 throughout."""
        n1, n2 = _split_factors(self.n)
        c1, s1, twc, tws, c2, s2 = _twiddles_split_fwd(self.n)
        lead = x.shape[:-1]
        xg = x.reshape(lead + (n1, n2)).astype(jnp.float32)
        # stage 1 (real input): A[k1, j2] = sum_j1 W1[j1, k1] x[j1, j2]
        ar = jnp.einsum("...jn,jk->...kn", xg, c1, precision=MATMUL_PRECISION)
        ai = jnp.einsum("...jn,jk->...kn", xg, s1, precision=MATMUL_PRECISION)
        # inter-stage twiddle (elementwise [n1, n2])
        br = ar * twc - ai * tws
        bi = ar * tws + ai * twc
        # stage 2: X[k1, k2] = sum_j2 B[k1, j2] W2[j2, k2], k2 <= n2/2
        xr, xi = _cmatmul(br, bi, c2, s2)
        # flatten k = k2*n1 + k1 and keep bins 0..n/2
        xr = jnp.swapaxes(xr, -1, -2).reshape(lead + (-1,))[..., : self.num_bins]
        xi = jnp.swapaxes(xi, -1, -2).reshape(lead + (-1,))[..., : self.num_bins]
        return jax.lax.complex(xr, xi)

    def _irfft_split(self, spec: jnp.ndarray) -> jnp.ndarray:
        """Inverse four-step on the weighted half spectrum (no Hermitian
        mirror; see _twiddles_split_inv): x[j1*n2 + j2] = Re sum_{k1}
        E1[k1, j1] ( tw[j2, k1] * sum_{k2<=n2/2} E2[k2, j2] Y[k2*n1+k1] )
        with Y = w * X / n."""
        n1, n2 = _split_factors(self.n)
        c2, s2, twc, tws, c1, s1 = _twiddles_split_inv(self.n)
        lead = spec.shape[:-1]
        # Hermitian weights / n, then zero-pad the (n1 - 1) grid slots
        # past bin n/2 (their weight is zero by construction)
        w = jnp.full((self.num_bins,), 2.0 / self.n, jnp.float32)
        w = w.at[0].set(1.0 / self.n).at[-1].set(1.0 / self.n)
        pad = [(0, 0)] * len(lead) + [(0, n1 - 1)]
        zr = jnp.pad(jnp.real(spec) * w, pad).reshape(lead + (-1, n1))
        zi = jnp.pad(jnp.imag(spec) * w, pad).reshape(lead + (-1, n1))
        # stage 1: B[j2, k1] = sum_k2 E2[k2, j2] Y[k2, k1]
        br = (jnp.einsum("...kn,kj->...jn", zr, c2, precision=MATMUL_PRECISION)
              - jnp.einsum("...kn,kj->...jn", zi, s2, precision=MATMUL_PRECISION))
        bi = (jnp.einsum("...kn,kj->...jn", zr, s2, precision=MATMUL_PRECISION)
              + jnp.einsum("...kn,kj->...jn", zi, c2, precision=MATMUL_PRECISION))
        # twiddle [j2, k1]
        cr = br * twc - bi * tws
        ci_ = br * tws + bi * twc
        # stage 2: x[j1, j2] = Re sum_k1 C[j2, k1] E1[k1, j1]
        xr = (jnp.einsum("...jk,kl->...lj", cr, c1, precision=MATMUL_PRECISION)
              - jnp.einsum("...jk,kl->...lj", ci_, s1, precision=MATMUL_PRECISION))
        return xr.reshape(lead + (self.n,))

    def __repr__(self):
        return f"SpectralTransform(n={self.n}, backend={self.backend!r})"
