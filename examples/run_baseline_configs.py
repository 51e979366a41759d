"""Run the five BASELINE.json benchmark configs end-to-end.

    python examples/run_baseline_configs.py [--device cpu|gpu] [--quick]

Each config streams real audio through the production engine and validates
output (finite, non-silent, and — where cheap — against offline
convolution). Uses the reference IR bank at /root/reference when mounted,
synthetic IRs otherwise. Prints one summary line per config.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE = "/root/reference"


def _bank(paths_or_n, sample_rate=44100, max_seconds=None, ir_seconds=1.0):
    from tpu_audio.engine import IRBank
    from tpu_audio.io.wav import read_wav

    bank = IRBank(sample_rate=sample_rate)
    rng = np.random.default_rng(0)
    if isinstance(paths_or_n, int):
        n = int(ir_seconds * sample_rate)
        t = np.arange(n, dtype=np.float32)
        env = np.exp(-t / (0.3 * n))
        for _ in range(paths_or_n):
            bank.append(rng.standard_normal((2, n)).astype(np.float32) * env * 0.3)
    else:
        for p in paths_or_n:
            bank.append(read_wav(p, verbose=False), max_seconds=max_seconds)
    return bank


def _ref_irs(category: str, n: int) -> list[str] | int:
    import glob
    hits = sorted(glob.glob(f"{REFERENCE}/ir/2/**/*.wav", recursive=True))
    hits = [h for h in hits if category.lower() in h.lower()] or \
        sorted(glob.glob(f"{REFERENCE}/ir/1/*.wav"))
    return hits[:n] if hits else n


def _run(model, blocks, midi=None, signal="noise", seed=1):
    from tpu_audio.runtime.backends import NoiseSource, ImpulseSource, WavSink

    v, b = model.engine.num_voices, model.block
    source = (NoiseSource(v, b, blocks, seed=seed) if signal == "noise"
              else ImpulseSource(v, b, blocks))
    sink = WavSink("/dev/null", keep_data=True)
    _, summary = model.process(source, sink, midi=midi, warmup=5)
    data = sink.data
    assert np.isfinite(data).all(), "non-finite output"
    assert np.abs(data).max() > 1e-5, "silent output"
    return data, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    if args.device == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")

    from scipy.signal import fftconvolve

    from tpu_audio.models.reverb import ConvolutionReverb
    from tpu_audio.runtime.stream import MidiSchedule
    from tpu_audio.engine.params import CCMapping

    blocks = 40 if args.quick else 200
    results = []

    # 1. offline mono convolution: one stairwell IR, 256-frame OLS blocks
    bank = _bank(_ref_irs("stairwell", 1), max_seconds=1.0)
    model = ConvolutionReverb(bank, num_voices=1, block=256)
    model.control.dry[:] = 0.0
    model.control.wet[:] = 1.0
    rng = np.random.default_rng(2)
    t = 256 * 20
    x = np.zeros((1, 2, t), np.float32)
    x[:, 0] = rng.standard_normal(t).astype(np.float32) * 0.05  # mono in L
    from tpu_audio.runtime.backends import WavSource, WavSink
    sink = WavSink("/dev/null", keep_data=True)
    model.process(WavSource(x, 1, 256), sink, warmup=5)
    got = sink.data[0]
    ir = bank.ir(0)
    want = np.clip(np.stack([fftconvolve(x[0, 0], ir[o])[:t] for o in range(2)]),
                   -1, 1)
    err = float(np.abs(got - want).max())
    assert err < 1e-3, err
    results.append(("1 offline-mono-stairwell", f"max_err={err:.1e}"))

    # 2. stereo convolution, wet/dry mix + output gain, single venue IR
    bank = _bank(_ref_irs("venue", 1) or 1, max_seconds=1.0)
    model = ConvolutionReverb(bank, num_voices=1, block=256)
    model.control.dry[:] = 0.4
    model.control.wet[:] = 0.6
    model.control.level[:] = 0.8
    _, s = _run(model, blocks)
    results.append(("2 stereo-wet-dry-gain", f"blocks={s['blocks_streamed']}"))

    # 3. uniform partitioned convolution: >=4 s IR streamed in RT blocks
    bank = _bank(1, ir_seconds=4.0)
    model = ConvolutionReverb(bank, num_voices=1, block=256)
    _, s = _run(model, blocks)
    results.append(("3 partitioned-4s-IR",
                    f"partitions={model.engine.partitions}"))

    # 4. IR bank switching with crossfade across index sets, MIDI stream
    paths = []
    for cat in ("stairwell", "underground", "venue"):
        hit = _ref_irs(cat, 2)
        paths += hit if isinstance(hit, list) else []
    bank = _bank(paths or 6, max_seconds=0.75)
    model = ConvolutionReverb(bank, num_voices=1, block=256)
    for ch in range(2):
        model.control.set_mapping(0, ch, CCMapping(message=0xB0, select=21,
                                                   wet=24, speed=25))
    midi = MidiSchedule([
        (10, "", bytes([0xB0, 21, 40])),   # switch IR (crossfade)
        (20, "", bytes([0xB0, 24, 100])),  # wet change mid-fade
        (30, "", bytes([0xB0, 21, 90])),   # switch again
    ])
    _, s = _run(model, max(blocks, 60), midi=midi)
    results.append(("4 bank-switch-midi", f"irs={len(bank)}"))

    # 5. multi-voice server: 64 concurrent stereo voices, one chip
    bank = _bank(4, ir_seconds=1.0 if args.quick else 4.0)
    model = ConvolutionReverb(bank, num_voices=64, block=256)
    _, s = _run(model, blocks // 2)
    line = (f"voices=64 avg={s['avg_ms']:.2f}ms rtf="
            f"{s.get('rtf', 0):.2f}" if s["blocks"] else "voices=64")
    results.append(("5 server-64-voices", line))

    print()
    for name, info in results:
        print(f"PASS  {name:28s} {info}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
