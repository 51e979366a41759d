import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_audio.ops import (
    SpectralTransform, pack_2r_to_c, unpack_c_to_2r, full_spectrum_from_half,
    rfft_via_pack, pan_gains, delay_and_clamp_add, dry_mix_2x2,
    slew_spectra, vsteps_decrement, num_partitions, partition_ir,
    partition_spectra, monolithic_spectrum,
)

RNG = np.random.default_rng(42)


# ---------------------------------------------------------------- hermitian

def test_pack_unpack_roundtrip_matches_rfft():
    """Hermitian 2-in-1 trick must reproduce the per-channel spectra
    (reference f_pack2R2C/f_unpackC22R semantics, src/conv.cu:35-73)."""
    n = 256
    l = RNG.standard_normal(n).astype(np.float32)
    r = RNG.standard_normal(n).astype(np.float32)
    spec_l, spec_r = rfft_via_pack(l, r)
    np.testing.assert_allclose(np.asarray(spec_l), np.fft.fft(l), atol=1e-3)
    np.testing.assert_allclose(np.asarray(spec_r), np.fft.fft(r), atol=1e-3)


def test_unpack_is_hermitian():
    n = 128
    l = RNG.standard_normal(n).astype(np.float32)
    r = RNG.standard_normal(n).astype(np.float32)
    spec_l, _ = rfft_via_pack(l, r)
    spec_l = np.asarray(spec_l)
    # mirror half must be the conjugate of the lower half
    for k in range(1, n // 2):
        assert abs(spec_l[n - k] - np.conj(spec_l[k])) < 1e-3


def test_full_spectrum_from_half():
    n = 64
    x = RNG.standard_normal(n).astype(np.float32)
    half = np.fft.rfft(x)
    full = np.asarray(full_spectrum_from_half(jnp.asarray(half), n))
    np.testing.assert_allclose(full, np.fft.fft(x), atol=1e-4)


def test_pack_batched():
    l = RNG.standard_normal((3, 64)).astype(np.float32)
    r = RNG.standard_normal((3, 64)).astype(np.float32)
    spec_l, spec_r = rfft_via_pack(l, r)
    assert spec_l.shape == (3, 64)
    np.testing.assert_allclose(np.asarray(spec_l)[1], np.fft.fft(l[1]), atol=1e-3)


# ---------------------------------------------------------------- fft backends

@pytest.mark.parametrize("n", [64, 512, 2048])
def test_matmul_backend_matches_fft_backend(n):
    x = RNG.standard_normal((4, n)).astype(np.float32)
    ref = SpectralTransform(n, backend="fft")
    mm = SpectralTransform(n, backend="matmul")
    s_ref = np.asarray(ref.rfft(jnp.asarray(x)))
    s_mm = np.asarray(mm.rfft(jnp.asarray(x)))
    np.testing.assert_allclose(s_mm, s_ref, atol=2e-3 * np.sqrt(n))
    y_ref = np.asarray(ref.irfft(jnp.asarray(s_ref)))
    y_mm = np.asarray(mm.irfft(jnp.asarray(s_ref)))
    np.testing.assert_allclose(y_ref, x, atol=1e-3)
    np.testing.assert_allclose(y_mm, x, atol=1e-3)


@pytest.mark.parametrize("n", [4096, 8192, 32768])
def test_split_backend_matches_numpy(n):
    """Four-step FFT as two matmul stages (n = n1 * n2)."""
    from tpu_audio.ops.fft import _split_factors, auto_backend
    n1, n2 = _split_factors(n)
    assert n1 * n2 == n and n1 <= n2 <= 2 * n1
    x = RNG.standard_normal((2, 3, n)).astype(np.float32)
    sp = SpectralTransform(n, backend="split")
    # auto: the per-size table measured on the GPU
    assert SpectralTransform(n).backend == auto_backend(n)
    got = np.asarray(jax.jit(sp.rfft)(jnp.asarray(x)))
    want = np.fft.rfft(x, axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)
    gotr = np.asarray(jax.jit(sp.irfft)(
        jnp.asarray(want.astype(np.complex64))))
    wantr = np.fft.irfft(want, n=n, axis=-1)
    np.testing.assert_allclose(gotr, wantr, atol=1e-5)
    rt = np.asarray(jax.jit(lambda y: sp.irfft(sp.rfft(y)))(jnp.asarray(x)))
    np.testing.assert_allclose(rt, x, atol=1e-5)


@pytest.mark.parametrize("n", [512, 8192])
@pytest.mark.parametrize("backend", ["fft", "matmul", "split"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_backends_match_float64_at_the_engine_sizes(n, backend, direction):
    """Every backend against float64 numpy at the sizes the engines use
    (512: fmajor and the cascade head; 8192: the cascade tail)."""
    from tpu_audio.ops import fft as fftmod

    xf = SpectralTransform(n, backend=backend)
    x = RNG.standard_normal((3, n))
    spec = np.fft.rfft(x, axis=-1)
    try:
        if direction == "forward":
            got = np.asarray(jax.jit(xf.rfft)(jnp.asarray(x, jnp.float32)))
            scale = np.abs(spec).max()
            np.testing.assert_allclose(got / scale, spec / scale, atol=3e-6)
        else:
            got = np.asarray(jax.jit(xf.irfft)(
                jnp.asarray(spec.astype(np.complex64))))
            np.testing.assert_allclose(got, x, atol=3e-5)
    finally:
        # the matmul backend's [n, n/2+1] tables are 134 MB each at 8192
        fftmod._twiddles_fwd.cache_clear()
        fftmod._twiddles_inv.cache_clear()


@pytest.mark.parametrize("backend", ["fft", "split"])
def test_backends_at_the_monolithic_size(backend):
    """n = 131072, the monolithic reference engine's transform: forward
    against float64 numpy and the round trip."""
    n = 131072
    xf = SpectralTransform(n, backend=backend)
    x = RNG.standard_normal((2, n)).astype(np.float32)
    got = np.asarray(jax.jit(xf.rfft)(jnp.asarray(x)))
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-6)
    rt = np.asarray(jax.jit(lambda y: xf.irfft(xf.rfft(y)))(jnp.asarray(x)))
    np.testing.assert_allclose(rt, x, atol=3e-5)


@pytest.mark.parametrize("n", [512, 8192, 131072, 1024])
def test_auto_resolves_through_the_measured_table(n):
    """backend='auto' takes AUTO_BACKENDS' entry for a measured size and
    the plain FFT for any other size."""
    from tpu_audio.ops.fft import AUTO_BACKENDS, auto_backend

    want = AUTO_BACKENDS.get(n, "fft")
    assert auto_backend(n) == want
    assert SpectralTransform(n).backend == want
    assert SpectralTransform(n, backend="auto").backend == want


def test_auto_table_covers_the_engine_sizes_with_known_backends():
    from tpu_audio.ops.fft import AUTO_BACKENDS

    assert {512, 8192, 131072} <= set(AUTO_BACKENDS)
    assert set(AUTO_BACKENDS.values()) <= {"fft", "matmul", "split"}


def test_roundtrip_convolution_equivalence():
    """OLS building block: irfft(rfft(x) * rfft(h)) == circular conv."""
    n = 512
    x = RNG.standard_normal(n).astype(np.float32)
    h = RNG.standard_normal(n).astype(np.float32)
    want = np.real(np.fft.ifft(np.fft.fft(x) * np.fft.fft(h)))
    for backend in ("fft", "matmul"):
        xf = SpectralTransform(n, backend=backend)
        got = np.asarray(xf.irfft(xf.rfft(jnp.asarray(x)) * xf.rfft(jnp.asarray(h))))
        np.testing.assert_allclose(got, want, atol=5e-2)


def test_non_power_of_two_rejected():
    with pytest.raises(ValueError):
        SpectralTransform(300)


def test_jittable():
    xf = SpectralTransform(256, backend="matmul")
    f = jax.jit(lambda x: xf.irfft(xf.rfft(x)))
    x = jnp.asarray(RNG.standard_normal((2, 256)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(x), atol=1e-4)


# ---------------------------------------------------------------- mix

def test_pan_gains_reference_law():
    """gainL = pan>=0 ? 1-pan : 1; gainR = pan<=0 ? 1+pan : 1
    (src/conv.cu:386-389)."""
    pans = jnp.asarray([-1.0, -0.5, 0.0, 0.5, 1.0])
    gl, gr = pan_gains(pans)
    np.testing.assert_allclose(np.asarray(gl), [1.0, 1.0, 1.0, 0.5, 0.0])
    np.testing.assert_allclose(np.asarray(gr), [0.0, 0.5, 1.0, 1.0, 1.0])


def test_delay_and_clamp_add():
    e = 16
    residual = jnp.zeros(e).at[0].set(0.25)
    wet = jnp.asarray([1.0, 2.0, 3.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    out = np.asarray(delay_and_clamp_add(residual, wet, jnp.asarray(2)))
    # predelay shifts wet right 2; clamp caps at 1.0; residual added
    assert out[0] == pytest.approx(0.25)
    assert out[1] == 0.0
    assert out[2] == pytest.approx(1.0)  # 1.0 clamped? no: 1.0 exactly
    assert out[3] == pytest.approx(1.0)  # 2.0 clamped
    assert out[4] == pytest.approx(1.0)  # 3.0 clamped
    assert out[5] == 0.0


def test_delay_zero_is_identity_plus_residual():
    wet = jnp.asarray(RNG.standard_normal(8).astype(np.float32) * 0.1)
    residual = jnp.asarray(RNG.standard_normal(16).astype(np.float32) * 0.1)
    out = np.asarray(delay_and_clamp_add(residual, wet, jnp.asarray(0)))
    want = np.asarray(residual).copy()
    want[:8] += np.asarray(wet)
    np.testing.assert_allclose(out, np.clip(want, -1, 1), atol=1e-6)


def test_dry_mix_2x2():
    nb = 4
    out_l = jnp.zeros(8)
    out_r = jnp.zeros(8)
    in1 = jnp.ones(nb)
    in2 = jnp.full(nb, 2.0)
    out_l, out_r = dry_mix_2x2(out_l, out_r, in1, in2, (0.5, 0.25, 0.1, 0.2))
    np.testing.assert_allclose(np.asarray(out_l)[:nb], 0.5 + 0.2)
    np.testing.assert_allclose(np.asarray(out_r)[:nb], 0.25 + 0.4)
    np.testing.assert_allclose(np.asarray(out_l)[nb:], 0.0)


# ---------------------------------------------------------------- smoother

def test_slew_matches_reference_recurrence():
    """active += (target*wet - active) / (vsteps + 5), vsteps counting down
    (reference f_interpolate, src/conv.cu:15-32)."""
    f = 33
    active = RNG.standard_normal(f).astype(np.complex64)
    target = (RNG.standard_normal(f) + 1j * RNG.standard_normal(f)).astype(np.complex64)
    wet, vsteps = 0.7, 10
    cur_np = active.copy()
    cur_jx = jnp.asarray(active)
    vs = vsteps
    for _ in range(30):
        cur_np = cur_np + (target * np.float32(wet) - cur_np) / np.float32(vs + 5)
        cur_jx = slew_spectra(cur_jx, jnp.asarray(target), wet, vs)
        vs = max(vs - 1, 0)
    np.testing.assert_allclose(np.asarray(cur_jx), cur_np, atol=1e-4)
    # after many steps at vsteps=0 it converges to target*wet
    for _ in range(200):
        cur_jx = slew_spectra(cur_jx, jnp.asarray(target), wet, 0)
    np.testing.assert_allclose(np.asarray(cur_jx), target * np.float32(wet), atol=1e-3)


def test_vsteps_decrement_floors_at_zero():
    assert int(vsteps_decrement(jnp.asarray(5))) == 4
    assert int(vsteps_decrement(jnp.asarray(0))) == 0


def test_slew_commutes_with_partitioning():
    """Per-bin slew with a uniform step commutes with the linear transform:
    slewing partition spectra == partitioning the slewed IR. This is the
    property that lets the partitioned engine keep reference crossfade
    semantics."""
    block = 32
    ir_a = RNG.standard_normal(100).astype(np.float32)
    ir_b = RNG.standard_normal(100).astype(np.float32)
    wet, vsteps = 0.8, 7
    # path 1: slew in time domain, then partition
    slewed = ir_a + (ir_b * np.float32(wet) - ir_a) / np.float32(vsteps + 5)
    spec_path1 = partition_spectra(slewed, block, backend="fft")
    # path 2: partition both, slew spectra
    sa = partition_spectra(ir_a, block, backend="fft")
    sb = partition_spectra(ir_b, block, backend="fft")
    spec_path2 = np.asarray(slew_spectra(jnp.asarray(sa), jnp.asarray(sb), wet, vsteps))
    np.testing.assert_allclose(spec_path2, spec_path1, atol=1e-4)


# ---------------------------------------------------------------- partition

def test_num_partitions():
    assert num_partitions(256, 256) == 1
    assert num_partitions(257, 256) == 2
    assert num_partitions(1, 256) == 1
    assert num_partitions(176400, 256) == 690  # 4 s @ 44.1 kHz


def test_partition_ir_layout():
    block = 8
    ir = np.arange(20, dtype=np.float32)
    parts = partition_ir(ir, block)
    assert parts.shape == (3, 16)
    np.testing.assert_allclose(parts[0, :8], ir[:8])
    np.testing.assert_allclose(parts[2, :8], np.concatenate([ir[16:], np.zeros(4)]))
    np.testing.assert_allclose(parts[:, 8:], 0.0)


def test_partition_spectra_shape():
    spec = partition_spectra(RNG.standard_normal((2, 100)).astype(np.float32), 32)
    assert spec.shape == (2, 4, 33)
    assert spec.dtype == np.complex64


def test_monolithic_spectrum_truncation():
    """IR is truncated to fft_size - reserve frames (src/conv.cu:239)."""
    fft_size, reserve = 256, 64
    ir = RNG.standard_normal(1000).astype(np.float32)
    spec = monolithic_spectrum(ir, fft_size, reserve)
    assert spec.shape == (fft_size,)
    want = np.fft.fft(np.concatenate([ir[:fft_size - reserve], np.zeros(reserve)]))
    np.testing.assert_allclose(spec, want.astype(np.complex64), atol=1e-3)


def test_full_spectrum_validation_errors():
    from tpu_audio.ops.hermitian import full_spectrum_from_half

    half = jnp.zeros((5,), jnp.complex64)
    with pytest.raises(ValueError, match="even"):
        full_spectrum_from_half(half, 9)
    with pytest.raises(ValueError, match="bins"):
        full_spectrum_from_half(half, 16)
