"""tpu-audio quickstart: the library API in six short scenes.

Runs anywhere JAX runs — on CPU for a laptop smoke test:

    JAX_PLATFORMS=cpu PYTHONPATH=. python examples/quickstart.py

Each scene is self-contained; crib the one you need. The CLI
(`python -m tpu_audio.app --help`) wraps all of this behind flags, and
docs/MIGRATION.md maps every cuda-audio concept onto these APIs.
"""

import os

import numpy as np

from tpu_audio.engine import IRBank
from tpu_audio.engine.params import CCMapping
from tpu_audio.models.reverb import ConvolutionReverb
from tpu_audio.runtime.backends import WavSink, WavSource
from tpu_audio.runtime.stream import MidiSchedule

SR, BLOCK, VOICES = 44100, 256, 4


def make_bank(num_irs=3, seconds=0.5, seed=0) -> IRBank:
    """A synthetic IR bank. Real deployments load WAVs:
    IRBank.from_index("ir/all.index", root=...) reads the reference's
    own index format, or bank.append(read_wav(path).stereo().T)."""
    rng = np.random.default_rng(seed)
    bank = IRBank(sample_rate=SR)
    for k in range(num_irs):
        n = int(SR * seconds)
        decay = np.exp(-np.linspace(0, 8 + 2 * k, n), dtype=np.float32)
        ir = rng.standard_normal((2, n)).astype(np.float32) * decay
        bank.append(ir * (0.25 / np.abs(ir).max()))
    return bank


def scene_1_offline_render():
    """Stream a buffer through the production engine, get audio back."""
    bank = make_bank()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              engine="fmajor", sample_rate=SR)
    model.control.wet[:] = 0.7
    model.control.dry[:] = 0.3
    x = np.zeros((VOICES, 2, BLOCK * 40), np.float32)
    x[:, :, 0] = 1.0                                  # an impulse per voice
    sink = WavSink("/tmp/quickstart_1.wav", SR, keep_data=True)
    state, summary = model.process(WavSource(x, VOICES, BLOCK), sink)
    print(f"scene 1: {summary['blocks_streamed']} blocks, "
          f"avg {summary['avg_ms']:.2f} ms/block, wrote /tmp/quickstart_1.wav")


def scene_2_midi_control():
    """Scripted MIDI: select a new IR mid-stream (crossfaded), sweep wet.
    Live deployments swap MidiSchedule for runtime/midi_transport
    (ALSA rawmidi ids, FIFOs) via StreamSession(live_midi=...)."""
    bank = make_bank()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              engine="fmajor", sample_rate=SR)
    model.control.wet[:] = 0.6
    model.control.dry[:] = 0.4
    model.control.set_mapping(0, 0, CCMapping(message=0xB0, select=21,
                                              wet=24, speed=25))
    midi = MidiSchedule.parse("""
        5  B0 19 40   # speed: mid-rate crossfades
        10 B0 15 60   # voice 0 ch 0: crossfade to IR 1
        25 B0 18 20   # wet down
    """)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((VOICES, 2, BLOCK * 40)) * 0.1).astype(np.float32)
    sink = WavSink("/tmp/quickstart_2.wav", SR)
    _, summary = model.process(WavSource(x, VOICES, BLOCK), sink, midi=midi)
    print(f"scene 2: {summary['blocks_streamed']} blocks with MIDI control")


def scene_2b_automated_bounce():
    """The same MIDI timeline, bounced OFFLINE far faster than real
    time: render_offline(schedule=...) maps the track's time axis onto
    virtual voices and replays the automation in-graph — output matches
    the live session of scene 2 to float precision (the reference can
    only bounce by performing through JACK at 1.0x)."""
    bank = make_bank()
    model = ConvolutionReverb(bank, num_voices=1, block=BLOCK,
                              engine="fmajor", sample_rate=SR)
    model.control.wet[:] = 0.6
    model.control.dry[:] = 0.4
    model.control.set_mapping(0, 0, CCMapping(message=0xB0, select=21,
                                              wet=24, speed=25))
    midi = MidiSchedule.parse("""
        5  B0 19 40
        10 B0 15 60   # crossfade to IR 1, mid-track
        25 B0 18 20   # wet down
    """)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, BLOCK * 40)) * 0.1).astype(np.float32)
    out = model.render_offline(x, segments=4, schedule=midi)  # [V, 2, T+tail]
    print(f"scene 2b: bounced {out.shape[-1] / SR:.2f} s (automation + "
          f"reverb tail) time-parallel over 4 segments")
    # hour-scale tracks: chunk to bound device memory (composes with the
    # schedule), and halve both wire directions — int16 upload is
    # BIT-EXACT for 16-bit sources ('auto'), pcm16 readback is the
    # DAC-facing depth anyway
    chunked = model.render_offline(x, segments=4, schedule=midi,
                                   track_chunk_blocks=16,
                                   wire="pcm16", input_wire="auto")
    # budget: chunk-grid reassociation (5e-5, the tested bound) + half an
    # LSB of pcm16 output quantization — independent, so they add
    assert np.abs(chunked - out).max() < 5e-5 + 0.51 / 32767
    print("scene 2b: chunked + pcm16-wire bounce matches within "
          "wire quantization")


def scene_3_settings_file():
    """Reference-format settings: the same file cuda-audio ships drives
    model construction (CC mappings, initial values, banks, geometry).
    Heterogeneous multi-pair files go through ReverbGroups instead —
    the CLI picks automatically."""
    bank_dir = "/tmp/quickstart_bank"
    os.makedirs(bank_dir, exist_ok=True)
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import write_wav

    bank = make_bank()
    paths = []
    for k in range(len(bank)):
        p = f"{bank_dir}/ir{k}.wav"
        write_wav(p, bank.ir(k).T, SR)
        paths.append(p)
    write_index(f"{bank_dir}/all.index", paths)
    with open(f"{bank_dir}/settings.txt", "w") as fh:
        fh.write(f"""conv.count 2
conv[0].fftSize 131072
conv[0].maxPredelay 8192
conv[0].index {bank_dir}/all.index
conv[0].cc.message 176
conv[0].cc.select 21
conv[0].value.select 1
conv[0].value.dry 0.4
conv[0].value.wet 0.6
""")
    model = ConvolutionReverb.from_settings(
        f"{bank_dir}/settings.txt", engine="fmajor", block=BLOCK,
        verbose=False)
    print(f"scene 3: built from settings — {model.engine.num_voices} "
          f"voice(s), {len(model.bank)} IRs")


def scene_4_checkpoint_resume():
    """Serving state is checkpointable mid-crossfade, bit-exact."""
    from tpu_audio.runtime.checkpoint import load_checkpoint, save_checkpoint

    bank = make_bank()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              engine="fmajor", sample_rate=SR)
    model.control.wet[:] = 0.7
    state = model.init_state()
    rng = np.random.default_rng(2)
    for _ in range(5):
        x = (rng.standard_normal((VOICES, 2, BLOCK)) * 0.1).astype(np.float32)
        state, _ = model.engine.step_coef_steady(
            state, model.spectra, model.control.snapshot_device(), x)
        model.control.end_block()
    save_checkpoint("/tmp/quickstart.ckpt", state, model.control,
                    meta={"block_index": 5})
    state2, meta = load_checkpoint("/tmp/quickstart.ckpt",
                                   model.engine.init_state(), model.control)
    print(f"scene 4: checkpoint at block {meta['block_index']} restored")


def scene_5_multichip():
    """The same session serves over a jax.sharding.Mesh — voices are
    data-parallel (communication-free hot loop). On one chip this is the
    degenerate 1-device mesh; on a pod slice it scales voice count.
    Run with XLA_FLAGS=--xla_force_host_platform_device_count=8 to try
    an 8-device virtual mesh on CPU."""
    import jax

    from tpu_audio.parallel.mesh import make_mesh

    n = min(len(jax.devices()), VOICES)
    mesh = make_mesh(n)
    bank = make_bank()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              engine="fmajor", sample_rate=SR)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((VOICES, 2, BLOCK * 10)) * 0.1).astype(np.float32)
    sink = WavSink("/dev/null", SR, keep_data=True)
    sess = model.session(WavSource(x, VOICES, BLOCK), sink, mesh=mesh,
                         warmup=0, donate=False)
    sess.run(model.init_state())
    print(f"scene 5: served {sink.data.shape[-1] // BLOCK} blocks over a "
          f"{n}-device mesh")


if __name__ == "__main__":
    scene_1_offline_render()
    scene_2_midi_control()
    scene_2b_automated_bounce()
    scene_3_settings_file()
    scene_4_checkpoint_resume()
    scene_5_multichip()
    print("quickstart complete")
