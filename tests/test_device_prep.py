"""On-device IR preparation (engine/device_prep.py) must produce the
same banks as the host numpy prep path to the device FFT backend's
tolerance — the reference computes IR spectra on the GPU
(src/conv.cu:207-253) and this is the same architecture in JAX."""

import numpy as np
import pytest

from tpu_audio.engine import IRBank
from tpu_audio.engine import device_prep as dp
from tpu_audio.engine.cascade import CascadeConvolution
from tpu_audio.engine.fmajor import FMajorPartitionedConvolution


def _bank(num_irs=3, seconds=0.06, sr=44100, seed=0, grid16=False):
    rng = np.random.default_rng(seed)
    bank = IRBank(sample_rate=sr)
    n = int(seconds * sr)
    for k in range(num_irs):
        env = np.exp(-np.arange(n, dtype=np.float32) / (0.4 * n))
        ir = rng.standard_normal((2, n - 7 * k)).astype(np.float32)
        ir *= env[: ir.shape[-1]] * 0.3
        if grid16:
            ir = np.round(np.clip(ir, -0.5, 0.4999) * 65536.0) / 65536.0
            ir = ir.astype(np.float32)
        bank.append(ir)
    return bank


def _close(a, b, rtol=2e-5):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-9)
    diff = float(np.abs(a - b).max())
    assert diff <= rtol * scale, f"maxdiff {diff:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("ring,strategy", [(True, "allk"),
                                           (True, "selected"),
                                           (False, "allk")])
def test_fmajor_device_prep_matches_host(ring, strategy):
    bank = _bank()
    block = 256
    parts = bank.max_partitions(block)
    def eng():
        return FMajorPartitionedConvolution(
            2, block, parts, max_predelay=1024, ring=ring,
            mac_strategy=strategy, num_irs=len(bank))
    host = eng().prepare_bank(bank.partitioned_spectra(block))
    dev = dp.prepare_fmajor_bank_device(eng(), bank)
    for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2"):
        _close(getattr(dev, name), getattr(host, name))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cascade_device_prep_matches_host(dtype):
    bank = _bank(seconds=0.12)
    block = 256
    parts = bank.max_partitions(block)
    def eng():
        return CascadeConvolution(4, block, parts, ratio=2,
                                  max_predelay=1024, num_irs=len(bank),
                                  mac_dtype=dtype)
    host = eng().prepare_bank(bank)
    dev = dp.prepare_cascade_bank_device(eng(), bank)
    # bf16: both paths cast the SAME f32 values, so the tolerance is the
    # f32 FFT tolerance plus one rounding step of the larger operand
    rtol = 2e-5 if dtype == "f32" else 1e-2
    _close(dev.head_rhs2, host.head_rhs2, rtol)
    _close(dev.tail_rhs2, host.tail_rhs2, rtol)


def test_cascade_device_prep_engine_output_equivalence():
    """The device-prepped bank must SERVE like the host bank: run the
    real cascade step over both and compare audio."""
    import jax
    import jax.numpy as jnp

    from tpu_audio.engine import ControlPlane

    bank = _bank(seconds=0.12)
    block = 256
    parts = bank.max_partitions(block)
    def eng():
        return CascadeConvolution(4, block, parts, ratio=2,
                                  max_predelay=1024, num_irs=len(bank))
    e = eng()
    control = ControlPlane(4, len(bank))
    control.wet[:] = 0.8
    control.dry[:] = 0.1
    control.predelay[:] = 300
    params = jax.tree.map(jnp.asarray, control.snapshot())
    rng = np.random.default_rng(3)
    blocks = [jnp.asarray(rng.standard_normal((4, 2, block))
                          .astype(np.float32) * 0.1) for _ in range(30)]

    def run(spectra):
        st = e.init_converged(spectra, params)
        step = jax.jit(e.step_coef_steady, donate_argnums=(0,))
        outs = []
        for xb in blocks:
            st, y = step(st, spectra, params, xb)
            outs.append(np.asarray(y))
        return np.concatenate(outs, axis=-1)

    y_host = run(e.prepare_bank(bank))
    y_dev = run(dp.prepare_cascade_bank_device(eng(), bank))
    peak = float(np.abs(y_host).max())
    assert peak > 1e-4
    assert float(np.abs(y_host - y_dev).max()) <= 3e-5 * peak


def test_pcm16_wire_exact_roundtrip():
    bank = _bank(grid16=True)
    td = dp.bank_time_domain(bank)
    q = dp.encode_pcm16_exact(td)
    assert q is not None and q.dtype == np.int16
    dev, wire = dp.upload_bank_td(td, "auto")
    assert wire == "pcm16"
    assert np.array_equal(np.asarray(dev), td)     # bit-exact decode


def test_pcm16_wire_refuses_off_grid():
    bank = _bank()
    bank.normalize()                                # off the 16-bit grid
    td = dp.bank_time_domain(bank)
    assert dp.encode_pcm16_exact(td) is None
    dev, wire = dp.upload_bank_td(td, "auto")
    assert wire == "f32"
    assert np.array_equal(np.asarray(dev), td)
    with pytest.raises(ValueError):
        dp.upload_bank_td(td, "pcm16")


def test_prep_jit_is_memoized_per_geometry():
    """Per-fault/per-bounce reuse must not re-trace (jitcache contract)."""
    bank = _bank()
    block = 256
    parts = bank.max_partitions(block)
    e = FMajorPartitionedConvolution(2, block, parts, max_predelay=1024,
                                     mac_strategy="allk", num_irs=len(bank))
    td = dp.bank_time_domain(bank)
    f1 = dp._prep_fn(e, "fmajor", td.shape)
    f2 = dp._prep_fn(e, "fmajor", td.shape)
    assert f1 is f2


# -- model-layer wiring (bank_prep='device') -----------------------------------


def _session_audio(model, x, events, num_voices, block):
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.runtime.backends import WavSink, WavSource
    from tpu_audio.runtime.stream import MidiSchedule

    model.control.wet[:] = 0.8
    model.control.dry[:] = 0.1
    model.control.speed[:] = 6
    model.control.set_mapping(0, 0, CCMapping(message=0xB0, select=0x15))
    sink = WavSink("/dev/null", keep_data=True)
    sess = model.session(WavSource(x, num_voices, block), sink, warmup=0,
                         donate=False)
    sess.run(model.init_state(), midi=MidiSchedule(list(events)))
    return sink.data


@pytest.mark.parametrize("engine", ["fmajor", "cascade"])
def test_model_bank_prep_device_serves_like_host(engine):
    """ConvolutionReverb(bank_prep='device') must serve the same audio as
    the host-prep model to the device FFT's tolerance (the only
    difference is WHERE the spectra were computed)."""
    from tpu_audio.models.reverb import ConvolutionReverb

    v, block = 4, 256
    bank = _bank(num_irs=4, seconds=0.12)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((v, 2, block * 24)) * 0.05).astype(np.float32)
    events = [(6, "", bytes([0xB0, 0x15, 70]))]
    kw = dict(num_voices=v, block=block, max_predelay=1024, engine=engine)
    if engine == "cascade":
        kw["cascade_ratio"] = 2
    want = _session_audio(ConvolutionReverb(bank, **kw), x, events, v, block)
    got = _session_audio(ConvolutionReverb(bank, bank_prep="device", **kw),
                         x, events, v, block)
    peak = float(np.abs(want).max())
    assert peak > 1e-3
    assert float(np.abs(got - want).max()) <= 5e-5 * peak


def test_ws_td_fault_session_equals_full_bank():
    """The flagship round-5 path: bank_prep='device' + working-set
    residency resolves fault_upload='td' — residents upload as PCM, every
    fault uploads ONE time-domain IR and the FFT+pack runs in the
    slot-update jit. A MIDI sweep with misses/evictions must match the
    full-bank host model to FFT tolerance."""
    from tpu_audio.models.reverb import ConvolutionReverb

    v, block, cap = 2, 32, 4
    bank = _bank(num_irs=9, seconds=0.01, seed=2)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((v, 2, block * 90)) * 0.05).astype(np.float32)
    events = [(10, "", bytes([0xB0, 0x15, 75])),    # full 5
              (35, "", bytes([0xB0, 0x15, 120])),   # full 8
              (65, "", bytes([0xB0, 0x15, 30]))]    # full 2

    ws_model = ConvolutionReverb(bank, num_voices=v, block=block,
                                 max_predelay=64, engine="fmajor",
                                 bank_capacity=cap, bank_prep="device")
    assert ws_model.engine.fault_upload == "td"
    ws_model.working_set.min_age_blocks = 20
    got = _session_audio(ws_model, x, events, v, block)
    assert ws_model.working_set.misses >= 3
    full = ConvolutionReverb(bank, num_voices=v, block=block,
                             max_predelay=64, engine="fmajor")
    want = _session_audio(full, x, events, v, block)
    peak = float(np.abs(want).max())
    assert peak > 1e-3
    assert float(np.abs(got - want).max()) <= 5e-5 * peak


@pytest.mark.parametrize("ring", [True, False])
def test_td_fault_slot_update_matches_host_pack(ring):
    """update_bank_slot(fault_upload='td') — raw [O, L] payload, FFT+pack
    in-jit — must land the same slot contents as the host spectra pack,
    to FFT tolerance, in both ring (serving) and roll (multichip) modes."""
    bank = _bank(num_irs=4)
    block = 256
    parts = bank.max_partitions(block)

    def eng(fu):
        return FMajorPartitionedConvolution(
            2, block, parts, max_predelay=1024, ring=ring,
            mac_strategy="allk", num_irs=len(bank), fault_upload=fu)

    spectra = bank.partitioned_spectra(block)
    e_host = eng("dual")
    want = e_host.prepare_bank(spectra)
    e_td = eng("td")
    start = e_td.prepare_bank(spectra)
    # overwrite slot 2 with ITS OWN IR via the td path: result must match
    # the host-packed bank wherever slot 2's columns live
    got = e_td.update_bank_slot(start, 2, bank.ir(2))
    for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2"):
        _close(getattr(got, name), getattr(want, name), rtol=2e-5)


def test_bank_prep_validation():
    from tpu_audio.models.reverb import ConvolutionReverb

    bank = _bank()
    with pytest.raises(ValueError, match="unknown bank_prep"):
        ConvolutionReverb(bank, bank_prep="gpu")
    with pytest.raises(ValueError, match="covers the fmajor and"):
        ConvolutionReverb(bank, engine="monolithic", bank_prep="device")
    with pytest.raises(ValueError, match="fault_upload='td'"):
        ConvolutionReverb(bank, engine="fmajor", bank_capacity=2,
                          bank_prep="device", fault_upload="derived")


def test_cascade_device_prep_short_resident_bank():
    """Review repro (round 5): a working-set compact sub-bank whose
    longest resident IR is SHORTER than the cascade head (2*ratio*block)
    made partition_fd's tail slice start past the input length
    (TypeError: slice limit_indices...) while the host prepare_bank
    zero-pads the same case. The engine geometry is sized by the FULL
    bank, so short residents are a normal configuration."""
    rng = np.random.default_rng(4)
    full = IRBank(sample_rate=44100)
    full.append((rng.standard_normal((2, 9000)) * 0.1).astype(np.float32))
    for _ in range(3):   # residents far shorter than head = 2*2*256
        full.append((rng.standard_normal((2, 400)) * 0.1
                     ).astype(np.float32))
    block = 256
    parts = full.max_partitions(block)
    compact = IRBank(sample_rate=44100)
    for k in (1, 2, 3):
        compact.append(full.ir(k))

    def eng():
        return CascadeConvolution(4, block, parts, ratio=2,
                                  max_predelay=1024, num_irs=3)
    host = eng().prepare_bank(compact)
    dev = dp.prepare_cascade_bank_device(eng(), compact)
    _close(dev.head_rhs2, host.head_rhs2)
    _close(dev.tail_rhs2, host.tail_rhs2)
