"""On-device equivalence drive: offline bounce vs the LIVE streaming
session performing the same MIDI timeline, at production scale.

The CPU suite runs f32 contractions at any precision setting, so only a
drive on the device can see reduced-precision divergence (CLAUDE.md,
landmine 4; PERF.md has the GPU readings of the bench's equiv leg).

Stages (each printed):
  1. STATIC whole vs STATIC chunked        (no automation)
  2. AUTOMATED whole vs streamed session   (ground truth)
  3. AUTOMATED chunked vs streamed session
"""
import sys, time
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--voices", type=int, default=64)
    ap.add_argument("--num-irs", type=int, default=4)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--chunk-blocks", type=int, default=1023)
    ap.add_argument("--stages", default="1,2,3")
    ap.add_argument("--engine", default="cascade")
    args = ap.parse_args()
    stages = set(int(s) for s in args.stages.split(","))

    from bench import make_bank
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.models.reverb import ConvolutionReverb
    from tpu_audio.runtime.offline import render_offline
    from tpu_audio.runtime.stream import MidiSchedule

    bank = make_bank(args.num_irs, args.ir_seconds, 44100)

    def fresh():
        m = ConvolutionReverb(bank, num_voices=args.voices, block=256,
                              sample_rate=44100, engine=args.engine,
                              cache_dir=".bench_cache")
        m.control.wet[:] = 0.7
        m.control.dry[:] = 0.2
        for v in range(args.voices):
            m.control.set_mapping(v, 0, CCMapping(
                message=0xB0, select=21, wet=24, speed=25))
        return m

    blocks = int(args.seconds * 44100 / 256)
    events = []
    for j, t in enumerate(range(20, blocks, 860)):
        events.append((t, "", bytes([0xB0, 0x15, (j * 43) % 128])))
        events.append((t + 300, "", bytes([0xB0, 0x18, 40 + (j * 17) % 60])))
    rng = np.random.default_rng(11)
    n = int(args.seconds * 44100)
    x = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)

    def stream(schedule):
        from tpu_audio.runtime.backends import WavSink, WavSource
        from tpu_audio.runtime.stream import StreamSession
        import jax, jax.numpy as jnp
        m = fresh()
        total = blocks + m.engine.history_blocks
        xpad = np.zeros((2, total * 256), np.float32)
        xpad[:, :n] = x
        sink = WavSink("/dev/null", keep_data=True)
        sess = StreamSession(m.engine, m.spectra, m.control,
                             WavSource(xpad, m.engine.num_voices, 256),
                             sink, warmup=0, donate=False,
                             fetch_batch=64)
        params = jax.tree.map(jnp.asarray, m.control.snapshot())
        sess.run(m.engine.init_converged(m.spectra, params),
                 midi=schedule)
        return sink.data

    if 1 in stages:
        t0 = time.perf_counter()
        w = render_offline(fresh(), x)
        c = render_offline(fresh(), x,
                           track_chunk_blocks=args.chunk_blocks)
        print(f"STATIC whole vs chunked: maxdiff {np.abs(w - c).max():.3e} "
              f"(peak {np.abs(w).max():.3f}) [{time.perf_counter()-t0:.0f} s]",
              flush=True)
    if 2 in stages or 3 in stages:
        t0 = time.perf_counter()
        ref = stream(MidiSchedule(list(events)))
        print(f"stream done [{time.perf_counter()-t0:.0f} s] "
              f"shape {ref.shape}", flush=True)
    if 2 in stages:
        t0 = time.perf_counter()
        w = render_offline(fresh(), x, schedule=MidiSchedule(list(events)))
        nn = min(w.shape[-1], ref.shape[-1])
        print(f"AUTO whole vs stream: maxdiff "
              f"{np.abs(w[..., :nn] - ref[..., :nn]).max():.3e} "
              f"(peak {np.abs(ref).max():.3f}) "
              f"[{time.perf_counter()-t0:.0f} s]", flush=True)
    if 3 in stages:
        t0 = time.perf_counter()
        c = render_offline(fresh(), x, schedule=MidiSchedule(list(events)),
                           track_chunk_blocks=args.chunk_blocks)
        nn = min(c.shape[-1], ref.shape[-1])
        print(f"AUTO chunked vs stream: maxdiff "
              f"{np.abs(c[..., :nn] - ref[..., :nn]).max():.3e} "
              f"[{time.perf_counter()-t0:.0f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
