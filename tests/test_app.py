import os

import numpy as np
import pytest

from tpu_audio.engine import IRBank
from tpu_audio.io.index import write_index
from tpu_audio.io.settings import Settings
from tpu_audio.io.wav import read_wav, write_wav
from tpu_audio.models.reverb import ConvolutionReverb

SETTINGS_TEMPLATE = """
conv.count 2
conv[0].fftSize 2048
conv[0].maxPredelay 128
conv[0].index {index}
conv[0].cc.device hw:9,0
conv[0].cc.message 176
conv[0].cc.select 21
conv[0].cc.predelay 22
conv[0].cc.dry 23
conv[0].cc.wet 24
conv[0].cc.speed 25
conv[0].cc.panDry 26
conv[0].cc.panWet 26
conv[0].cc.level 28
conv[0].value.select 1
conv[0].value.predelay 16
conv[0].value.dry 0.4
conv[0].value.wet 0.6
conv[0].value.speed 50
conv[0].value.panDry 0
conv[0].value.panWet 0
conv[0].value.level 0.9
conv[1].fftSize 2048
conv[1].maxPredelay 128
conv[1].index {index}
conv[1].cc.device hw:9,0
conv[1].cc.message 176
conv[1].cc.select 21
conv[1].cc.predelay 22
conv[1].cc.dry 23
conv[1].cc.wet 24
conv[1].cc.speed 25
conv[1].cc.panDry 27
conv[1].cc.panWet 27
conv[1].cc.level 28
conv[1].value.select 0
conv[1].value.predelay 16
conv[1].value.dry 0.4
conv[1].value.wet 0.6
conv[1].value.speed 50
conv[1].value.panDry 0
conv[1].value.panWet 0
conv[1].value.level 0.9
"""


@pytest.fixture
def settings_env(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for k in range(2):
        ir = rng.uniform(-0.3, 0.3, (150, 2)).astype(np.float32)
        p = tmp_path / f"ir{k}.wav"
        write_wav(p, ir, 44100)
        paths.append(str(p))
    idx = tmp_path / "bank.index"
    write_index(idx, paths)
    sfile = tmp_path / "settings.txt"
    sfile.write_text(SETTINGS_TEMPLATE.format(index=idx))
    return sfile, tmp_path


def test_from_settings_wiring(settings_env):
    """Reference wiring semantics (src/main.cu:25-70)."""
    sfile, _ = settings_env
    model = ConvolutionReverb.from_settings(
        str(sfile), block=64, verbose=False)
    assert model.engine.num_voices == 1
    assert len(model.bank) == 2
    cp = model.control
    assert cp.select[0, 0] == 1 and cp.select[0, 1] == 0
    assert cp.predelay[0, 0] == 16
    assert cp.dry[0, 0] == np.float32(0.4)
    assert cp.speed[0, 1] == 50
    assert cp.level[0, 0] == np.float32(0.9)
    m = cp.mappings[(0, 1)]
    assert m.device == "hw:9,0"
    assert m.pan_dry == 27 and m.pan_wet == 27
    assert cp.mappings[(0, 0)].pan_dry == 26


def test_from_settings_voice_scaleout(settings_env):
    """num_voices beyond conv.count/2 replicates voice 0's config."""
    sfile, _ = settings_env
    model = ConvolutionReverb.from_settings(str(sfile), block=64,
                                            num_voices=4, verbose=False)
    assert model.engine.num_voices == 4
    assert model.control.select[3, 0] == 1
    assert model.control.mappings[(3, 1)].message == 176


def test_from_settings_odd_count_rejected(tmp_path):
    sfile = tmp_path / "s.txt"
    sfile.write_text("conv.count 3\n")
    with pytest.raises(ValueError):
        ConvolutionReverb.from_settings(str(sfile), verbose=False)


def test_app_cli_end_to_end(settings_env, tmp_path):
    """Drive the CLI main() like a user: settings + input WAV -> output WAV."""
    from tpu_audio.app.main import main
    sfile, base = settings_env
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.2, 0.2, (800, 2)).astype(np.float32)
    write_wav(base / "in.wav", x, 44100, scale="full")
    out = base / "out.wav"
    rc = main(["--settings", str(sfile), "--input", str(base / "in.wav"),
               "--output", str(out), "--block-size", "64", "--quiet"])
    assert rc == 0
    assert os.path.exists(out)
    w = read_wav(out, scale="full", verbose=False)
    assert w.num_frames >= 800
    assert np.abs(w.frames).max() > 1e-4  # produced signal
    assert np.abs(w.frames).max() <= 1.5


def test_app_cli_with_midi_schedule(settings_env, tmp_path):
    from tpu_audio.app.main import main
    sfile, base = settings_env
    midi = base / "events.txt"
    midi.write_text("2 B0 15 7F\n4 B0 18 40\n")  # select + dry change
    out = base / "imp.wav"
    rc = main(["--settings", str(sfile), "--signal", "impulse",
               "--blocks", "8", "--block-size", "64",
               "--output", str(out), "--midi", str(midi), "--quiet"])
    assert rc == 0
    assert os.path.exists(out)


def test_app_missing_settings_errors(tmp_path):
    from tpu_audio.app.main import main
    assert main(["--settings", str(tmp_path / "nope.txt"), "--quiet"]) == 2


def test_from_settings_per_channel_banks(tmp_path):
    """Differing conv[0].index / conv[1].index give each engine channel its
    OWN bank (the capability the reference intends at src/main.cu:72-81 but
    breaks with a shared map): merged along K, per-channel select windows,
    and the audio proves each channel convolved its own IR."""
    from scipy.signal import fftconvolve

    from tpu_audio.runtime.backends import ImpulseSource, WavSink

    rng = np.random.default_rng(5)
    paths = {}
    irs = {}
    for name, seed in (("a0", 10), ("a1", 11), ("b0", 20)):
        ir = rng.uniform(-0.3, 0.3, (120, 2)).astype(np.float32)
        p = tmp_path / f"{name}.wav"
        write_wav(p, ir, 44100, bits=32)
        irs[name] = ir.T  # [2, L]
        paths[name] = str(p)
    write_index(tmp_path / "bank_a.index", [paths["a0"], paths["a1"]])
    write_index(tmp_path / "bank_b.index", [paths["b0"]])

    sfile = tmp_path / "s.txt"
    sfile.write_text(
        "conv.count 2\n"
        "conv[0].fftSize 2048\nconv[1].fftSize 2048\n"
        f"conv[0].index {tmp_path / 'bank_a.index'}\n"
        f"conv[1].index {tmp_path / 'bank_b.index'}\n"
        "conv[0].value.select 1\n"   # -> a1, within channel 0's window
        "conv[1].value.select 0\n"   # -> b0, within channel 1's window
        "conv[0].value.wet 1.0\nconv[1].value.wet 1.0\n"
        "conv[0].value.dry 0.0\nconv[1].value.dry 0.0\n")
    model = ConvolutionReverb.from_settings(str(sfile), engine="fmajor",
                                            block=64, verbose=False)
    assert len(model.bank) == 3
    np.testing.assert_array_equal(model.control.select, [[1, 2]])
    np.testing.assert_array_equal(model.control.select_base, [[0, 2]])
    np.testing.assert_array_equal(model.control.select_span, [[2, 1]])

    # stream an impulse on both input channels: with wet=1, dry=0 and
    # centered pans (gain 1 each side, conv.cu:386-389) each output o gets
    # x0 (*) ir_sel(0)[o] + x1 (*) ir_sel(1)[o] = a1[o] + b0[o]
    sink = WavSink("/dev/null", keep_data=True)
    model.process(ImpulseSource(1, 64, 8), sink, warmup=0)
    got = sink.data[0]
    x = np.zeros(64 * 8, np.float32)
    x[0] = 1.0
    # compare against the IRs as the bank loader itself reads them
    a1 = read_wav(paths["a1"], verbose=False).stereo().T
    b0 = read_wav(paths["b0"], verbose=False).stereo().T
    for o in range(2):
        want = (fftconvolve(x, a1[o]) + fftconvolve(x, b0[o]))[:len(x)]
        np.testing.assert_allclose(got[o], np.clip(want, -1, 1), atol=3e-5)


def test_per_channel_select_cc_stays_in_window():
    """A select CC on a windowed channel scales within ITS bank and never
    escapes the window."""
    from tpu_audio.engine.params import CCMapping, ControlPlane

    cp = ControlPlane(1, 5)
    cp.set_channel_banks([(0, 2), (2, 3)])
    cp.set_mapping(0, 0, CCMapping(message=0xB0, select=0x15))
    cp.set_mapping(0, 1, CCMapping(message=0xB0, select=0x15))
    cp.apply_cc(0, 0, 0xB0, 0x15, 127)   # ch0: 127*2//128 = 1
    cp.apply_cc(0, 1, 0xB0, 0x15, 127)   # ch1: 2 + 127*3//128 = 4
    assert cp.select[0, 0] == 1
    assert cp.select[0, 1] == 4
    cp.apply_cc(0, 1, 0xB0, 0x15, 0)     # ch1 floor = its own offset
    assert cp.select[0, 1] == 2


def test_app_cleans_rings_on_setup_failure(tmp_path, settings_env):
    """A setup error AFTER ring creation (here: invalid session options)
    must still unlink the shm segments."""
    import pytest as _pytest

    from tpu_audio.app.main import main
    from tpu_audio.runtime import native

    if not native.native_available():
        _pytest.skip("native toolchain unavailable")
    sfile, root = settings_env
    name = f"/rvb_cleanup_{os.getpid()}"
    with _pytest.raises(ValueError):
        main(["--settings", str(sfile), "--root", str(root),
              "--input-ring", name, "--blocks", "2", "--block-size", "32",
              "--fetch-batch", "2", "--chunk-blocks", "2", "--quiet"])
    # the segment must be gone: opening it again must fail
    with _pytest.raises(RuntimeError):
        native.NativeRing.open(name)


def test_reverb_groups_heterogeneous_fft_sizes(tmp_path):
    """Two conv pairs with DIFFERENT fftSize and different index files
    (reference src/main.cu:31-39 builds one independent instance per pair)
    must build two engine groups and stream: the summed output equals the
    sum of the two single-pair models run separately on the same input."""
    from tpu_audio.models.reverb import ConvolutionReverb, ReverbGroups

    rng = np.random.default_rng(9)
    banks = []
    for g in range(2):
        paths = []
        for k in range(2):
            ir = rng.uniform(-0.3, 0.3, (120 + 60 * g, 2)).astype(np.float32)
            p = tmp_path / f"g{g}_ir{k}.wav"
            write_wav(p, ir, 44100)
            paths.append(str(p))
        idx = tmp_path / f"g{g}.index"
        write_index(idx, paths)
        banks.append(str(idx))
    lines = ["conv.count 4"]
    for n, (fft, idx) in enumerate([(1024, banks[0]), (1024, banks[0]),
                                    (2048, banks[1]), (2048, banks[1])]):
        lines += [f"conv[{n}].fftSize {fft}",
                  f"conv[{n}].maxPredelay 128",
                  f"conv[{n}].index {idx}",
                  f"conv[{n}].value.select {n % 2}",
                  "conv[{}].value.dry 0.3".format(n),
                  "conv[{}].value.wet 0.7".format(n)]
    sfile = tmp_path / "hetero.txt"
    sfile.write_text("\n".join(lines) + "\n")

    groups = ReverbGroups.from_settings(str(sfile), block=64, verbose=False)
    assert len(groups.models) == 2
    assert [len(p) for p in groups.pair_ids] == [1, 1]
    assert groups.models[0].engine.num_voices == 1

    x = (rng.standard_normal((2, 64 * 12)) * 0.05).astype(np.float32)
    total, summaries = groups.process(x, warmup=0)
    assert len(summaries) == 2

    # reference wiring: both pairs hear the same input; outputs sum
    from tpu_audio.runtime.backends import WavSink, WavSource
    want = None
    for m in groups.models:
        src = WavSource(x, num_voices=1, block=64)
        snk = WavSink("/dev/null", keep_data=True)
        m2_state, _ = m.process(src, snk, warmup=0,
                                state=m.init_state())
        out = snk.data.sum(axis=0)
        want = out if want is None else want[..., :out.shape[-1]] + out
    # second run of the same models continues their internal state? No:
    # process() was given a fresh state; outputs must match exactly
    np.testing.assert_allclose(total, want, atol=1e-6)
    assert np.abs(total).max() > 1e-4


def test_reverb_groups_split_on_max_predelay(tmp_path):
    """Pairs sharing fftSize+index but with DIFFERENT maxPredelay must NOT
    merge into one engine group: a group shares one engine, and the
    predelay CC scales value*maxPredelay//128 — merging would silently
    apply pair 0's range to pair 1 (the reference builds each instance
    with its own configuration, src/main.cu:31-39)."""
    from tpu_audio.models.reverb import ReverbGroups

    rng = np.random.default_rng(11)
    paths = []
    for k in range(2):
        ir = rng.uniform(-0.3, 0.3, (100, 2)).astype(np.float32)
        p = tmp_path / f"ir{k}.wav"
        write_wav(p, ir, 44100)
        paths.append(str(p))
    idx = tmp_path / "b.index"
    write_index(idx, paths)
    lines = ["conv.count 4"]
    for n, maxpd in enumerate([512, 512, 128, 128]):
        lines += [f"conv[{n}].fftSize 1024",
                  f"conv[{n}].maxPredelay {maxpd}",
                  f"conv[{n}].index {idx}"]
    sfile = tmp_path / "pd.txt"
    sfile.write_text("\n".join(lines) + "\n")

    groups = ReverbGroups.from_settings(str(sfile), block=64, verbose=False)
    assert len(groups.models) == 2
    assert sorted(m.engine.max_predelay for m in groups.models) == [128, 512]


def _write_hetero_settings(tmp_path, rng):
    banks = []
    for g in range(2):
        paths = []
        for k in range(2):
            ir = rng.uniform(-0.3, 0.3, (120 + 60 * g, 2)).astype(np.float32)
            p = tmp_path / f"hg{g}_ir{k}.wav"
            write_wav(p, ir, 44100)
            paths.append(str(p))
        idx = tmp_path / f"hg{g}.index"
        write_index(idx, paths)
        banks.append(str(idx))
    lines = ["conv.count 4"]
    for n, (fft, idx) in enumerate([(1024, banks[0]), (1024, banks[0]),
                                    (2048, banks[1]), (2048, banks[1])]):
        lines += [f"conv[{n}].fftSize {fft}",
                  f"conv[{n}].maxPredelay 128",
                  f"conv[{n}].index {idx}",
                  f"conv[{n}].cc.select 21",
                  f"conv[{n}].cc.wet 24",
                  f"conv[{n}].value.select {n % 2}",
                  f"conv[{n}].value.dry 0.3",
                  f"conv[{n}].value.wet 0.7"]
    sfile = tmp_path / "hetero_cli.txt"
    sfile.write_text("\n".join(lines) + "\n")
    return sfile


def test_from_settings_refuses_heterogeneous_pairs(tmp_path):
    """A multi-geometry settings file must NOT silently collapse to pair
    0's fftSize/bank in a single batched model (the reference builds one
    instance per pair, src/main.cu:31-39) — loud redirect to ReverbGroups."""
    rng = np.random.default_rng(13)
    sfile = _write_hetero_settings(tmp_path, rng)
    with pytest.raises(ValueError, match="ReverbGroups"):
        ConvolutionReverb.from_settings(str(sfile), block=64, verbose=False)


def test_cli_routes_heterogeneous_settings_to_groups(tmp_path):
    """The app auto-detects heterogeneous conv pairs and serves them via
    the groups path: summed stereo output written, per-group stats
    printed; live-ring modes refuse with a clear message."""
    from tpu_audio.app.main import main

    rng = np.random.default_rng(13)
    sfile = _write_hetero_settings(tmp_path, rng)
    out = tmp_path / "hetero_out.wav"
    rc = main(["--settings", str(sfile), "--signal", "noise",
               "--blocks", "20", "--block-size", "64",
               "--output", str(out), "--quiet"])
    assert rc == 0
    w = read_wav(out, verbose=False)
    assert w.num_channels == 2 and w.num_frames == 20 * 64
    assert np.abs(w.frames).max() > 1e-4
    # live rings are one-process-per-geometry: loud refusal, not garbage
    rc = main(["--settings", str(sfile), "--input-ring", "hetero_in",
               "--quiet"])
    assert rc == 2


def test_cli_hetero_offline_automated_matches_streamed(tmp_path):
    """Heterogeneous conv pairs bounce offline WITH a MIDI schedule: each
    geometry group replays the same timeline, and the summed bounce
    matches the streamed groups session (16-bit WAV both sides)."""
    from tpu_audio.app.main import main

    rng = np.random.default_rng(13)
    sfile = _write_hetero_settings(tmp_path, rng)
    x = rng.uniform(-0.2, 0.2, (30 * 64, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    sched = tmp_path / "auto.txt"
    sched.write_text("5 B0 15 7F\n14 B0 18 30\n")
    base = ["--settings", str(sfile), "--input", str(tmp_path / "in.wav"),
            "--block-size", "64", "--midi", str(sched), "--quiet"]
    assert main(base + ["--output", str(tmp_path / "hs.wav")]) == 0
    assert main(base + ["--output", str(tmp_path / "hb.wav"),
                        "--offline", "3"]) == 0
    streamed = read_wav(tmp_path / "hs.wav", scale="full",
                        verbose=False).stereo()
    bounced = read_wav(tmp_path / "hb.wav", scale="full",
                       verbose=False).stereo()
    n = streamed.shape[0]
    assert np.abs(streamed).max() > 1e-3
    np.testing.assert_allclose(bounced[:n], streamed, atol=4 / 32768)
    # chunked + automated + heterogeneous groups compose through the CLI
    assert main(base + ["--output", str(tmp_path / "hc.wav"),
                        "--offline", "3",
                        "--offline-chunk-blocks", "9"]) == 0
    chunked = read_wav(tmp_path / "hc.wav", scale="full",
                       verbose=False).stereo()
    np.testing.assert_allclose(chunked[:n], streamed, atol=5 / 32768)


def test_quickstart_example_runs():
    """examples/quickstart.py is the user-facing API tour — it must keep
    running end-to-end (subprocess: it manages its own platform forcing
    and the scenes exercise process/MIDI/settings/checkpoint/mesh)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", TPU_AUDIO_LOG="warn",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=repo + ":" + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable,
                        os.path.join(repo, "examples", "quickstart.py")],
                       env=env, capture_output=True, text=True, timeout=570)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "quickstart complete" in p.stdout


def test_from_settings_resamples_bank_to_session_rate(tmp_path):
    """The reference's alternate operating point runs jackd at 48 kHz
    (run_x64_86.sh:4) while its IRs are 44.1 kHz recordings — served
    verbatim they play ~8.8% short/bright (the reference has no rate
    handling, src/wav.cu). from_settings resamples the bank to the
    session rate on load."""
    rng = np.random.default_rng(4)
    ir = rng.uniform(-0.3, 0.3, (4410, 2)).astype(np.float32)  # 0.1 s @44k1
    write_wav(tmp_path / "ir.wav", ir, 44100)
    write_index(tmp_path / "a.index", [str(tmp_path / "ir.wav")])
    sfile = tmp_path / "s.txt"
    sfile.write_text(f"conv.count 2\nconv[0].fftSize 2048\n"
                     f"conv[0].index {tmp_path / 'a.index'}\n")
    m48 = ConvolutionReverb.from_settings(str(sfile), block=64,
                                          sample_rate=48000, verbose=False)
    assert m48.bank.sample_rate == 48000
    assert abs(m48.bank.ir(0).shape[-1] - 4800) <= 2   # 0.1 s @ 48 kHz
    m44 = ConvolutionReverb.from_settings(str(sfile), block=64,
                                          verbose=False)
    assert m44.bank.ir(0).shape[-1] == 4410            # untouched at 44.1

    # direct construction with a mismatched bank warns loudly
    from tpu_audio.engine import IRBank
    from tpu_audio.utils.log import Log
    bank = IRBank(sample_rate=44100)
    bank.append(ir.T)
    warned = []
    orig = Log.warn
    Log.warn = classmethod(
        lambda cls, ident, fmt, *a: warned.append((ident, fmt % a)))
    try:
        ConvolutionReverb(bank, num_voices=1, block=64, sample_rate=48000)
    finally:
        Log.warn = orig
    assert any("sample rate" in msg for _, msg in warned)


def test_cli_adopts_input_wav_rate(tmp_path):
    """Without an explicit --sample-rate the session adopts the input
    WAV's rate (the reference adopts jackd's), resampling the IR bank to
    it; an explicit override warns about detuned program audio."""
    from tpu_audio.app.main import main

    rng = np.random.default_rng(6)
    ir = rng.uniform(-0.3, 0.3, (2205, 2)).astype(np.float32)
    write_wav(tmp_path / "ir.wav", ir, 44100)
    write_index(tmp_path / "a.index", [str(tmp_path / "ir.wav")])
    sfile = tmp_path / "s.txt"
    sfile.write_text(f"conv.count 2\nconv[0].fftSize 2048\n"
                     f"conv[0].index {tmp_path / 'a.index'}\n")
    x = (rng.standard_normal((64 * 8, 2)) * 0.1).astype(np.float32)
    write_wav(tmp_path / "in48.wav", x, 48000)
    out = tmp_path / "out.wav"
    rc = main(["--settings", str(sfile), "--input",
               str(tmp_path / "in48.wav"), "--block-size", "64",
               "--output", str(out)])
    assert rc == 0
    assert read_wav(out, verbose=False).sample_rate == 48000
    # the bank was resampled to 48 kHz (conftest silences info logs, so
    # assert the artifact, not the message): 0.05 s IR -> 2400 samples
    from tpu_audio.models.reverb import ConvolutionReverb as _CR
    m = _CR.from_settings(str(sfile), block=64, sample_rate=48000,
                          verbose=False)
    assert abs(m.bank.ir(0).shape[-1] - 2400) <= 2
