"""Application entry point: settings-driven streaming reverb.

Capability equivalent of the reference's main() (reference src/main.cu:18-116):
select the accelerator, read settings, build IR banks and convolution
voices, wire control mappings and initial values, stream audio, report the
average per-block runtime at exit. The JACK graph becomes file / synthetic /
shared-memory block backends; ALSA rawmidi becomes a scripted MIDI schedule
or a live byte FIFO.

    python -m tpu_audio.app --settings settings.txt \
        --input in.wav --output out.wav [--midi events.txt] \
        [--engine fmajor|cascade|partitioned|monolithic] [--voices N] [--blocks N] [--realtime]
"""

from __future__ import annotations

import argparse
import os

from tpu_audio.models.reverb import ConvolutionReverb
from tpu_audio.runtime.backends import (
    ImpulseSource, NoiseSource, NullSink, SilenceSource, WavSink, WavSource,
)
from tpu_audio.runtime.stream import MidiSchedule
from tpu_audio.utils.compile_cache import enable_compile_cache
from tpu_audio.utils.device import select_device
from tpu_audio.utils.log import Log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_audio", description="real-time convolution reverb server")
    p.add_argument("--settings", default="settings.txt",
                   help="reference-format settings file")
    p.add_argument("--root", default=None,
                   help="base dir for relative IR index paths")
    p.add_argument("--input", default=None,
                   help="input WAV (default: impulse test signal)")
    p.add_argument("--output", default=None,
                   help="output WAV (default: discard)")
    p.add_argument("--engine", default="fmajor",
                   choices=["fmajor", "cascade", "partitioned", "monolithic"])
    p.add_argument("--variant", default="coef",
                   choices=["coef", "materialized"])
    p.add_argument("--bank-capacity", type=int, default=None,
                   help="working-set IR residency: keep only N IR slots on "
                        "the device (fast all-K MAC) and page IRs from the "
                        "full bank in on demand — large banks at "
                        "small-bank speed when few IRs sound at once")
    p.add_argument("--fault-upload", default=None,
                   choices=["dual", "derived", "td"],
                   help="working-set fault payload (fmajor, ring and roll "
                        "modes): 'derived' uploads only the spectra slot "
                        "and rebuilds the MAC column on device — half the "
                        "per-fault bytes, measured 3.4x faster per fault; "
                        "'td' uploads the raw time-domain IR and runs the "
                        "partition FFT + pack in the slot-update jit "
                        "(default: td with --bank-prep device, derived for "
                        "fmajor, dual elsewhere)")
    p.add_argument("--bank-prep", default="host",
                   choices=["host", "device"],
                   help="where IR spectra + MAC packs are computed: "
                        "'device' uploads time-domain PCM and builds the "
                        "bank in-jit on the chip (the reference's "
                        "prepare() architecture, src/conv.cu:207-253 — "
                        "~10-20x less wire for big banks and no host FFT); "
                        "'host' keeps the numpy prep (CPU-test path and "
                        "engines device prep doesn't cover)")
    p.add_argument("--ws-exhausted", default="defer",
                   choices=["defer", "raise"],
                   help="working-set policy when every resident slot is "
                        "fade-protected: 'defer' parks the select and "
                        "applies it once a slot frees (serving never "
                        "crashes on hot MIDI); 'raise' keeps the strict "
                        "capacity-sizing contract")
    p.add_argument("--async-paging", action="store_true",
                   help="working-set residency only: page bank misses in "
                        "on a background thread — a fault never stalls the "
                        "block loop; the select (and its crossfade) applies "
                        "on the first block the IR is actually resident")
    p.add_argument("--predelay-side", default="write",
                   choices=["write", "read"],
                   help="cascade only: apply block-predelay at ring WRITE "
                        "(reference residual semantics) or at ring READ "
                        "(FIFO; halves head-ring traffic at high voice "
                        "counts; predelay edits skip/repeat buffered wet)")
    p.add_argument("--cascade-ratio", type=int, default=16,
                   help="cascade engine tail stagger ratio (tail partition "
                        "size = ratio*block; auto-shrunk to fit the voice "
                        "count and IR length)")
    p.add_argument("--mac-dtype", default="f32", choices=["f32", "bf16"],
                   help="bf16 halves wet-path HBM traffic (~-48 dB floor)")
    p.add_argument("--no-swap-snapshot", action="store_true",
                   help="span-only fades (fmajor 'allk'): drop the "
                        "materialized fade snapshot, the largest state "
                        "tensor (~11 MB/voice at 4 s IRs); bank hot-swaps "
                        "then wait for in-flight crossfades to decay")
    p.add_argument("--voices", type=int, default=None,
                   help="override voice count (default: conv.count/2)")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N blocks")
    p.add_argument("--until-enter", action="store_true",
                   help="run until Enter/EOF on stdin (the reference parks "
                        "its main thread the same way, src/main.cu:95)")
    p.add_argument("--block-size", type=int, default=256)
    p.add_argument("--sample-rate", type=int, default=None,
                   help="session rate (default: the input WAV's rate, "
                        "else 44100); IR banks resample to it on load")
    p.add_argument("--midi", default=None,
                   help="scripted MIDI schedule file (block hexbytes per line)")
    p.add_argument("--midi-fifo", action="append", default=None,
                   metavar="[DEVICE=]PATH",
                   help="FIFO/device path to read live MIDI bytes from; "
                        "repeatable, with an optional device id matched "
                        "against conv[i].cc.device mappings (the reference "
                        "runs one reader per ALSA device, src/main.cu:47-48)")
    p.add_argument("--input-ring", default=None, metavar="NAME",
                   help="read input blocks from this shared-memory ring "
                        "(created here; another process writes into it — "
                        "the live path, reference src/jackclient.cu:24-44)")
    p.add_argument("--output-ring", default=None, metavar="NAME",
                   help="write output blocks to this shared-memory ring "
                        "(created here; another process consumes it)")
    p.add_argument("--ring-blocks", type=int, default=64,
                   help="shm ring capacity in blocks")
    p.add_argument("--underrun", default=None, choices=["stop", "silence"],
                   help="source-dry policy (default: silence when "
                        "--input-ring is used, else stop)")
    p.add_argument("--max-dry-blocks", type=int, default=None,
                   help="end an unbounded live session after this many "
                        "consecutive silence-substituted blocks")
    p.add_argument("--clock", default="sleep", choices=["sleep", "native"],
                   help="realtime pacing source (native = drift-free C++ "
                        "absolute-deadline clock)")
    p.add_argument("--profile", default=None,
                   help="write a jax profiler trace to this directory")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="blocks in flight (raise on high-latency host links)")
    p.add_argument("--chunk-blocks", type=int, default=1,
                   help="blocks per dispatch (throughput mode; MIDI applies "
                        "at chunk granularity)")
    p.add_argument("--fetch-batch", type=int, default=1,
                   help="outputs per device->host transfer (keeps per-block "
                        "dispatch + control; amortises transfer round trips "
                        "on high-RTT links at N blocks of delivery latency)")
    p.add_argument("--wire", default="f32", choices=["f32", "pcm16"],
                   help="device->host output format in fetch-batch mode "
                        "(pcm16 halves transfer bytes; engine stays f32)")
    p.add_argument("--max-ir-seconds", type=float, default=None,
                   help="truncate bank IRs (memory control)")
    p.add_argument("--normalize-bank", default=None,
                   choices=["energy", "peak"],
                   help="equalise IR loudness across the bank before use")
    p.add_argument("--cache-dir", default=None,
                   help="IR spectra disk cache directory")
    p.add_argument("--realtime", action="store_true",
                   help="pace blocks at the audio rate")
    p.add_argument("--out-voice", default=None,
                   help="which voice to write: index or 'all' (default 0)")
    p.add_argument("--signal", default="impulse",
                   choices=["impulse", "noise", "silence"],
                   help="test signal when --input is absent")
    p.add_argument("--offline", nargs="?", const="auto", default=None,
                   metavar="SEGMENTS",
                   help="time-parallel offline bounce: render the input "
                        "far faster than real time, write --output, exit "
                        "(runtime/offline.py). Optional segment count, "
                        "default auto. A scripted --midi schedule bounces "
                        "too (the automation replays in-graph, matching "
                        "the live session to float precision); only LIVE "
                        "rings/FIFOs need the streaming session")
    p.add_argument("--offline-chunk-blocks", type=int, default=None,
                   metavar="N",
                   help="bound device memory on hour-scale --offline "
                        "bounces: render N blocks at a time, each chunk "
                        "re-primed from its trailing input history "
                        "(exact; composes with a --midi schedule on "
                        "fmajor engines)")
    p.add_argument("--offline-wire", default="pcm16",
                   choices=["f32", "pcm16"],
                   help="--offline readback format (default pcm16: the "
                        "CLI writes 16-bit WAVs anyway, so the half-"
                        "bandwidth wire loses nothing; f32 keeps full "
                        "precision for the voice-sum mix of many-group "
                        "sessions)")
    p.add_argument("--offline-input-wire", default="auto",
                   choices=["auto", "f32", "pcm16"],
                   help="--offline upload format for the program "
                        "material: 'auto' (default) uploads as int16 "
                        "BIT-EXACTLY when the input sits on a 16-bit "
                        "grid (every 16-bit WAV does) and falls back to "
                        "f32; 'pcm16' quantizes any input to half an "
                        "LSB. Halves the bounce's dominant upload")
    p.add_argument("--offline-bucket", nargs="?", const="auto",
                   default=None, metavar="BLOCKS",
                   help="round --offline track lengths up to a bucket "
                        "grid (default 'auto' ~= 3%% padding) so nearby "
                        "lengths reuse one compiled executable set "
                        "across bounces in this process")
    p.add_argument("--quiet", action="store_true")
    return p


def _offline_input(args):
    """Program material for an offline bounce: the input WAV, or the
    synthetic --signal (same semantics as the streaming sources)."""
    import numpy as np

    b = args.block_size
    if args.input:
        from tpu_audio.io.wav import read_wav
        wav = read_wav(args.input, verbose=not args.quiet)
        return wav.stereo().T.astype(np.float32), wav.sample_rate
    n = args.blocks or 400
    if args.signal == "noise":
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((2, n * b)) * 0.1).astype(np.float32)
    else:
        x = np.zeros((2, n * b), np.float32)
        if args.signal == "impulse":
            x[:, 0] = 1.0
    return x, args.sample_rate


def _offline(args, models, mix: bool) -> int:
    """Render every model offline over the same input and report
    throughput. mix=True sums all voices and models (the heterogeneous
    groups path, the reference's JACK playback mix); otherwise --out-voice
    picks the written voice like the streaming WavSink."""
    import time

    import numpy as np

    if args.input_ring or args.output_ring or args.midi_fifo or args.realtime:
        Log.error("app", "--offline bounces cannot take LIVE input "
                  "(rings/FIFOs/realtime need the streaming session; a "
                  "scripted --midi schedule bounces fine)")
        return 2
    x, sample_rate = _offline_input(args)
    segments = None if args.offline == "auto" else int(args.offline)
    schedule = None
    if args.midi:
        from tpu_audio.runtime.stream import MidiSchedule
        with open(args.midi) as fh:
            schedule = MidiSchedule.parse(fh.read())

    t0 = time.monotonic()
    outs = []
    try:
        for model in models:
            # (the schedule's stateful cursor is rewound by each replay)
            bucket = args.offline_bucket
            if bucket not in (None, "auto"):
                bucket = int(bucket)
            out = model.render_offline(
                x, segments=segments, schedule=schedule,
                track_chunk_blocks=args.offline_chunk_blocks,
                wire=args.offline_wire, bucket_blocks=bucket,
                input_wire=args.offline_input_wire)  # [V, 2, T']
            outs.append(out)
    except ValueError as exc:  # e.g. working-set models
        Log.error("app", "--offline: %s", exc)
        return 2
    wall = time.monotonic() - t0
    n = min(o.shape[-1] for o in outs)
    audio_s = n / sample_rate
    print(f"offline bounce: {audio_s:.1f} s of audio in {wall:.1f} s wall "
          f"({audio_s / wall:.1f}x real time incl. compile)")

    if args.output:
        from tpu_audio.io.wav import write_wav
        if mix:
            total = sum(o[..., :n].sum(axis=0) for o in outs)
            write_wav(args.output, total.T, sample_rate)
        else:
            out, voice = outs[0], args.out_voice
            if voice == "all":
                import os
                root, ext = os.path.splitext(args.output)
                for v in range(out.shape[0]):
                    write_wav(f"{root}_v{v:03d}{ext or '.wav'}",
                              out[v].T, sample_rate)
            else:
                write_wav(args.output, out[int(voice or 0)].T, sample_rate)
        Log.info("app", "wrote %s", args.output)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.quiet:
        Log.level = 2

    try:
        select_device(verbose=not args.quiet)
    except RuntimeError as exc:
        Log.error("app", "%s", exc)
        return 2
    enable_compile_cache()

    if not os.path.exists(args.settings):
        Log.error("app", "settings file not found: %s", args.settings)
        return 2

    # the session rate drives IR-bank resampling AND the real-time
    # deadline: an input WAV's rate is authoritative unless overridden
    # (the reference takes its rate from jackd; files are our jackd)
    if args.sample_rate is None:
        if args.input:
            from tpu_audio.io.wav import wav_sample_rate
            args.sample_rate = wav_sample_rate(args.input)
            Log.info("app", "session rate %d Hz (from %s)",
                     args.sample_rate, args.input)
        else:
            args.sample_rate = 44100

    # heterogeneous settings (pairs with different fftSize/maxPredelay/
    # banks, reference src/main.cu:31-39 builds independent instances):
    # route to the engine-groups path — one batched engine per distinct
    # geometry, outputs summed like the reference's JACK playback wiring
    from tpu_audio.io.settings import Settings
    from tpu_audio.models.reverb import pair_geometry_keys
    parsed = Settings().open(args.settings, verbose=False)
    if len(set(pair_geometry_keys(parsed, args.root))) > 1:
        return _run_groups(args)

    model = ConvolutionReverb.from_settings(
        args.settings, engine=args.engine, root=args.root,
        num_voices=args.voices, max_ir_seconds=args.max_ir_seconds,
        normalize_bank=args.normalize_bank,
        variant=args.variant, block=args.block_size,
        sample_rate=args.sample_rate, cache_dir=args.cache_dir,
        mac_dtype=args.mac_dtype, verbose=not args.quiet,
        swap_snapshot=not args.no_swap_snapshot,
        cascade_ratio=args.cascade_ratio, bank_capacity=args.bank_capacity,
        async_paging=args.async_paging, predelay_side=args.predelay_side,
        fault_upload=args.fault_upload, ws_exhausted=args.ws_exhausted,
        bank_prep=args.bank_prep)

    if args.offline is not None:
        return _offline(args, [model], mix=False)

    v, b = model.engine.num_voices, model.block
    rings = []
    if args.input_ring or args.output_ring:
        from tpu_audio.runtime.native import native_available
        if not native_available():
            Log.error("app", "shm rings need the native runtime (g++)")
            return 2

    try:
        return _stream(args, model, rings, v, b)
    finally:
        # unlink shm rings even if setup or streaming fails partway — a
        # crashed server must not strand /dev/shm segments
        for ring in rings:
            ring.close(unlink=True)


def _run_groups(args) -> int:
    """Heterogeneous-settings path: count/2 conv pairs grouped by engine
    geometry (reference src/main.cu:31-39), every pair fed the same
    stereo input, outputs summed (the JACK playback mix, main.cu:86-89).
    Offline processing only — live rings/FIFOs serve one engine group per
    process (run one `python -m tpu_audio.app` per group, same topology
    as the reference's independent Convolution instances)."""
    import numpy as np

    from tpu_audio.models.reverb import ReverbGroups

    if args.input_ring or args.output_ring or args.midi_fifo:
        Log.error("app", "heterogeneous conv pairs run the offline groups "
                  "path; for live rings start one app process per "
                  "geometry (split the settings file)")
        return 2
    groups = ReverbGroups.from_settings(
        args.settings, engine=args.engine, root=args.root,
        max_ir_seconds=args.max_ir_seconds, verbose=not args.quiet,
        variant=args.variant, block=args.block_size,
        sample_rate=args.sample_rate, cache_dir=args.cache_dir,
        mac_dtype=args.mac_dtype, bank_prep=args.bank_prep)

    if args.offline is not None:
        # every group bounced over the same input, summed like the JACK
        # playback mix (matching groups.process semantics)
        return _offline(args, groups.models, mix=True)

    b = args.block_size
    if args.input:
        from tpu_audio.io.wav import read_wav
        wav = read_wav(args.input, verbose=not args.quiet)
        x = wav.stereo().T.astype(np.float32)        # [2, T]
        sample_rate = wav.sample_rate
    else:
        n = args.blocks or 400
        rng = np.random.default_rng(0)
        x = {"impulse": np.zeros((2, n * b), np.float32),
             "noise": (rng.standard_normal((2, n * b)) * 0.1
                       ).astype(np.float32),
             "silence": np.zeros((2, n * b), np.float32)}[args.signal]
        if args.signal == "impulse":
            x[:, 0] = 1.0
        sample_rate = args.sample_rate

    midi = None
    if args.midi:
        with open(args.midi) as fh:
            midi = MidiSchedule.parse(fh.read())

    total, summaries = groups.process(x, midi=midi, max_blocks=args.blocks)
    for pairs, s in zip(groups.pair_ids, summaries):
        print(f"group pairs {pairs}: {s['blocks_streamed']} blocks | "
              f"avg {s.get('avg_ms', 0):.3f} ms | "
              f"p99 {s.get('p99_ms', 0):.3f} | rtf {s.get('rtf', 0):.2f}")
    if args.output:
        from tpu_audio.io.wav import write_wav
        write_wav(args.output, total.T, sample_rate)
        Log.info("app", "wrote %s", args.output)
    return 0


def _stream(args, model, rings, v, b) -> int:
    from tpu_audio.runtime.native import NativeRing, RingSink, RingSource

    if args.input_ring:
        ring_in = NativeRing(args.ring_blocks * v * 2 * b,
                             shm_name=args.input_ring)
        rings.append(ring_in)
        source = RingSource(ring_in, v, b, blocking=True)
        sample_rate = args.sample_rate
        Log.info("app", "input ring /dev/shm/%s (%d blocks)",
                 args.input_ring, args.ring_blocks)
    elif args.input:
        source = WavSource(args.input, v, b, max_blocks=args.blocks)
        sample_rate = source.sample_rate or args.sample_rate
        if source.sample_rate and source.sample_rate != args.sample_rate:
            # explicit --sample-rate overriding a mismatched input: the
            # program audio streams sample-for-sample (detuned); only the
            # IR bank was resampled. Usually a mistake — say so.
            Log.warn("app", "input is %d Hz but the session runs %d Hz: "
                     "program audio will play detuned (drop --sample-rate "
                     "to adopt the input's rate)",
                     source.sample_rate, args.sample_rate)
    else:
        n = args.blocks or 400
        source = {"impulse": ImpulseSource(v, b, n),
                  "noise": NoiseSource(v, b, n),
                  "silence": SilenceSource(v, b, n)}[args.signal]
        sample_rate = args.sample_rate

    if args.output_ring:
        ring_out = NativeRing(args.ring_blocks * v * 2 * b,
                              shm_name=args.output_ring)
        rings.append(ring_out)
        sink = RingSink(ring_out)
        Log.info("app", "output ring /dev/shm/%s (%d blocks)",
                 args.output_ring, args.ring_blocks)
    elif args.output:
        voice = args.out_voice
        if voice is not None and voice != "all":
            voice = int(voice)
        sink = WavSink(args.output, sample_rate, voice=voice)
    else:
        sink = NullSink()

    underrun = args.underrun or ("silence" if args.input_ring else "stop")

    midi = None
    if args.midi:
        with open(args.midi) as fh:
            midi = MidiSchedule.parse(fh.read())
    live_midi = None
    try:
        if args.midi_fifo:
            from tpu_audio.runtime.midi_transport import (
                MidiByteStream, MultiMidiStream)
            streams = []
            for spec in args.midi_fifo:
                device, _, path = spec.rpartition("=")
                streams.append(MidiByteStream(path, device=device))
            live_midi = (streams[0] if len(streams) == 1
                         else MultiMidiStream(streams))

        session = model.session(source, sink, realtime=args.realtime,
                                pipeline_depth=args.pipeline_depth,
                                chunk_blocks=args.chunk_blocks,
                                fetch_batch=args.fetch_batch, wire=args.wire,
                                underrun_policy=underrun,
                                max_consecutive_underruns=args.max_dry_blocks,
                                clock=args.clock)
        if args.until_enter:
            import sys as _sys
            import threading

            def _watch_stdin():
                try:
                    _sys.stdin.readline()
                except Exception:
                    pass
                Log.info("app", "stdin: stopping session")
                session.stop()

            threading.Thread(target=_watch_stdin, daemon=True).start()
        state = model.init_state()
        if args.profile:
            import jax
            with jax.profiler.trace(args.profile):
                session.run(state, max_blocks=args.blocks, midi=midi,
                            live_midi=live_midi)
            Log.info("app", "profiler trace written to %s", args.profile)
        else:
            session.run(state, max_blocks=args.blocks, midi=midi,
                        live_midi=live_midi)
    finally:
        if live_midi is not None:
            live_midi.close()

    # reference exit report (src/main.cu:106) + the latency stats it lacked;
    # printed unconditionally (the reference always reports at exit)
    s = session.summary()
    if s.get("blocks", 0) == 0:
        print(f"streamed {s['blocks_streamed']} blocks "
              f"(all within the warmup discard window; no timing recorded) "
              f"| underruns {s['underruns']}")
    else:
        print(f"streamed {s['blocks_streamed']} blocks | avg {s['avg_ms']:.3f} ms "
              f"| p50 {s['p50_ms']:.3f} | p99 {s['p99_ms']:.3f} "
              f"| rtf {s.get('rtf', 0):.2f} | missed {s['missed_deadlines']} "
              f"| underruns {s['underruns']}"
              + (f" | dropped {sink.dropped}" if hasattr(sink, "dropped") else ""))
        # deadline-margin hint: on high-RTT host links the default f32
        # wire can sit at the edge while the chip itself is far under
        # budget — the 16-bit wire + batched fetches halve/amortize the
        # transfer (BENCH r2: f32 p99 5.58 ms vs pcm16 1.24 at identical
        # engine cost)
        if (args.wire == "f32"
                and s["p99_ms"] > 0.9 * session.block_period * 1e3):
            Log.warn("app", "f32 wire p99 (%.2f ms) is within 10%% of the "
                     "%.2f ms deadline; if the chip link is high-latency "
                     "try --wire pcm16 --fetch-batch 16",
                     s["p99_ms"], session.block_period * 1e3)
    if args.output:
        Log.info("app", "wrote %s", args.output)
    return 0 if s["blocks_streamed"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
