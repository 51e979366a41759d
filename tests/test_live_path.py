"""End-to-end live audio path across process boundaries.

The reference's live path is: JACK server RT thread -> process callback ->
engine -> JACK output buffers (reference src/jackclient.cu:24-44,
src/main.cu:86-95). The equivalent here: a PRODUCER PROCESS writes blocks
into a shared-memory SPSC ring, the CLI app (a second process) streams
ring -> jitted engine -> ring in real time with silence substitution on
underrun, and a consumer (this test process) takes blocks off the output
ring. Three processes, lock-free rings on the hot path.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from tpu_audio.runtime import native

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native toolchain unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRODUCER = """
import sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from tpu_audio.runtime.native import NativeRing

name, n_blocks, floats = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
ring = None
deadline = time.time() + 90
while ring is None:
    try:
        ring = NativeRing.open(name)
    except RuntimeError:
        if time.time() > deadline:
            raise
        time.sleep(0.05)
rng = np.random.default_rng(0)
for t in range(n_blocks):
    blk = (rng.standard_normal(floats) * 0.1).astype(np.float32)
    while not ring.write(blk):
        time.sleep(0.002)
    if t == n_blocks // 2:
        time.sleep(0.05)  # producer hiccup mid-stream
ring.close()
"""


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["TPU_AUDIO_LOG"] = "warn"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _write_assets(tmp_path):
    from tpu_audio.io.wav import write_wav
    rng = np.random.default_rng(1)
    ir = (rng.standard_normal((300, 2)) * 0.3).astype(np.float32)
    write_wav(tmp_path / "ir.wav", ir, 44100, bits=16)
    (tmp_path / "tiny.index").write_text("ir.wav\n")
    (tmp_path / "settings.txt").write_text(
        "conv.count 2\n"
        "conv[0].fftSize 2048\nconv[1].fftSize 2048\n"
        "conv[0].index tiny.index\nconv[1].index tiny.index\n"
        "conv[0].value.wet 0.9\nconv[1].value.wet 0.9\n"
        "conv[0].value.dry 0.2\nconv[1].value.dry 0.2\n")


def test_two_process_ring_stream(tmp_path):
    """producer process -> shm ring -> app process -> shm ring -> this
    process, in real time, with deadline accounting reported at exit."""
    _write_assets(tmp_path)
    uid = f"{os.getpid()}_{int(time.time() * 1e3) % 100000}"
    name_in, name_out = f"/rvb_in_{uid}", f"/rvb_out_{uid}"
    n_blocks, block, v = 30, 128, 1
    floats = v * 2 * block

    app = subprocess.Popen(
        [sys.executable, "-m", "tpu_audio.app",
         "--settings", str(tmp_path / "settings.txt"),
         "--root", str(tmp_path),
         "--input-ring", name_in, "--output-ring", name_out,
         "--blocks", str(n_blocks), "--block-size", str(block),
         "--realtime", "--clock", "native", "--quiet"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(tmp_path))
    producer = subprocess.Popen(
        [sys.executable, "-c", PRODUCER.format(repo=REPO),
         name_in, str(n_blocks), str(floats)],
        env=_env(), stderr=subprocess.PIPE, text=True)

    try:
        # consumer: attach to the output ring once the app created it
        ring_out = None
        deadline = time.time() + 120
        while ring_out is None:
            try:
                ring_out = native.NativeRing.open(name_out)
            except RuntimeError:
                if time.time() > deadline:
                    pytest.fail("output ring never appeared; app stderr: "
                                + app.stderr.read())
                time.sleep(0.05)

        got = []
        while len(got) < n_blocks and time.time() < deadline:
            data = ring_out.read(floats)
            if data is None:
                if app.poll() is not None and ring_out.readable < floats:
                    break  # app exited and drained
                time.sleep(0.002)
                continue
            got.append(data.reshape(v, 2, block))
        ring_out.close()
    finally:
        prod_rc = producer.wait(timeout=60)
        out, err = app.communicate(timeout=120)

    assert prod_rc == 0, producer.stderr.read()
    assert app.returncode == 0, (out, err)
    assert len(got) == n_blocks, f"consumed {len(got)}/{n_blocks}: {out} {err}"
    audio = np.concatenate(got, axis=-1)
    assert np.isfinite(audio).all()
    assert np.abs(audio).max() > 1e-4, "live pipeline produced silence"
    # the reference-style exit report must be present with miss accounting
    assert "streamed" in out and "missed" in out and "underruns" in out, out


def test_live_session_survives_producer_outage(tmp_path):
    """In-process soak of the unbounded live loop: RingSource + silence
    policy ride out a producer outage longer than the blocking timeout and
    the session keeps real time (summary p99/miss accounting intact)."""
    import threading

    from tpu_audio.engine import IRBank
    from tpu_audio.models.reverb import ConvolutionReverb
    from tpu_audio.runtime.native import NativeRing, RingSink, RingSource

    rng = np.random.default_rng(2)
    bank = IRBank()
    ir = rng.standard_normal((2, 200)).astype(np.float32)
    bank.append(ir * (0.4 / np.abs(ir).max()))
    model = ConvolutionReverb(bank, num_voices=1, block=64, max_predelay=128)
    model.control.wet[:] = 0.9

    n_blocks, floats = 40, 1 * 2 * 64
    ring_in = NativeRing(64 * floats)
    ring_out = NativeRing(200 * floats)
    # short blocking timeout so the outage below actually surfaces as
    # underruns (None reads) rather than blocking through it
    source = RingSource(ring_in, 1, 64, blocking=True, max_empty_reads=20)

    def produce():
        for t in range(n_blocks):
            blk = (rng.standard_normal(floats) * 0.1).astype(np.float32)
            while not ring_in.write(blk):
                time.sleep(0.001)
            if t == 10:
                time.sleep(0.15)  # outage >> max_empty_reads * 0.5 ms
            else:
                time.sleep(0.002)

    thread = threading.Thread(target=produce)
    thread.start()
    session = model.session(source, RingSink(ring_out), warmup=0,
                            underrun_policy="silence",
                            max_consecutive_underruns=300)
    session.run(model.init_state(), max_blocks=None)
    thread.join()

    s = session.summary()
    assert s["underruns"] >= 1, "outage never surfaced"
    # every real block made it through despite the outage
    assert s["blocks_streamed"] >= n_blocks
    assert "p99_ms" in s and "missed_deadlines" in s
    total = ring_out.readable
    audio = ring_out.read(total - total % floats)
    assert audio is not None and np.isfinite(audio).all()
    ring_in.close()
    ring_out.close()


def test_soak_long_session_with_churn(tmp_path):
    """Stability soak: a long session under constant control churn —
    random CC spam (selects incl. interrupts, every parameter), producer
    hiccups with silence substitution, a mid-run bank hot-swap, and
    periodic checkpoints — must stream to completion with sane accounting
    and finite audio, and the streaming sink must not grow host memory."""
    import numpy as np

    from tpu_audio.engine import IRBank
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.models.reverb import ConvolutionReverb
    from tpu_audio.runtime.backends import BlockSource, WavSink
    from tpu_audio.runtime.stream import MidiSchedule

    rng = np.random.default_rng(71)
    bank = IRBank()
    for _ in range(4):
        ir = rng.standard_normal((2, 200)).astype(np.float32)
        bank.append(ir * (0.4 / np.abs(ir).max()))
    model = ConvolutionReverb(bank, num_voices=2, block=64, max_predelay=128)
    for v in range(2):
        for ch in range(2):
            model.control.set_mapping(v, ch, CCMapping(
                message=0xB0, select=0x15, predelay=0x16, dry=0x17,
                wet=0x18, speed=0x19, pan_dry=0x1A, pan_wet=0x1B,
                level=0x1C))
    model.control.speed[:] = 12

    n_blocks = 600
    events = []
    for _ in range(120):
        b = int(rng.integers(0, n_blocks))
        cc = int(rng.integers(0x15, 0x1D))
        events.append((b, "", bytes([0xB0, cc, int(rng.integers(128))])))

    class FlakyNoise(BlockSource):
        def __init__(self):
            self.i = 0
            self.rng = np.random.default_rng(72)

        def read(self):
            self.i += 1
            if self.i > n_blocks:
                return None
            if self.i % 97 == 0:
                return None  # periodic producer hiccup
            return (self.rng.standard_normal((2, 2, 64)) * 0.05
                    ).astype(np.float32)

    sink = WavSink(tmp_path / "soak.wav", 44100)  # streaming, no buffering
    session = model.session(FlakyNoise(), sink, warmup=0,
                            underrun_policy="silence",
                            max_consecutive_underruns=8)
    state = session.run(model.init_state(),
                        midi=MidiSchedule(events),
                        checkpoint_path=tmp_path / "soak.ckpt",
                        checkpoint_every=128)

    # swap the bank live and keep going with the same state
    bank2 = IRBank()
    for _ in range(4):
        ir = rng.standard_normal((2, 200)).astype(np.float32)
        bank2.append(ir * (0.4 / np.abs(ir).max()))
    session.swap_bank(model.engine.prepare_bank(bank2.partitioned_spectra(64)))
    session.source = FlakyNoise()
    session.sink = WavSink(tmp_path / "soak2.wav", 44100)  # first one closed
    session.run(state)

    s = session.summary()
    assert s["blocks_streamed"] >= 2 * (n_blocks - n_blocks // 97) - 4
    assert s["underruns"] >= 2
    assert sink._blocks is None  # nothing accumulated host-side
    assert (tmp_path / "soak.ckpt").exists()
    from tpu_audio.io.wav import read_wav
    for name in ("soak.wav", "soak2.wav"):
        audio = read_wav(tmp_path / name, verbose=False).stereo()
        assert np.isfinite(audio).all(), name
        assert np.abs(audio).max() > 1e-4, name
