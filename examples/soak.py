"""Long-horizon SERVING soak: a wall-clock-paced StreamSession under hot
MIDI churn through real working-set faults and deferred exhaustion.

576-block bench reps prove throughput; this proves *serving* (VERDICT r03
#8): the reference's operating model is a JACK client that runs
continuously (reference src/main.cu:95 — the process lives until a MIDI
stop byte). Here the production configuration — 64 voices, the
reference's own 152-IR bank behind a 16-slot WorkingSetBank, pcm16 wire,
batched fetches — streams in real time (``realtime=True`` pacing) for
``--minutes`` of wall clock while scripted MIDI re-selects hammer the
residency layer (faults, LRU evictions, deferred exhaustion), and the
session's own BlockTimer accumulates the per-block latency distribution.

Output: one JSON line (and a git-tracked record under bench_records/)
with blocks served, fault/starvation counts, p50/p99, deadline misses
(with their basis), a per-segment ms/block + p99 trend, and a periodic
output-finiteness check. Partial records are emitted on SIGTERM/crash —
a soak that dies at minute 25 still leaves 25 minutes of evidence.

Usage (on the chip):
    python examples/soak.py --minutes 30
Smoke (CPU, via conftest in tests/test_soak_smoke.py): tiny shapes,
seconds-long.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_T0 = time.perf_counter()


def log(msg):
    print(f"[t+{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


class CheckedNullSink:
    """Counts blocks, verifies finiteness on a sample of them, tracks
    peak — the soak's honesty check without host-side WAV cost."""

    def __init__(self, every: int = 64):
        self.blocks = 0
        self.peak = 0.0
        self.every = every
        self.nonfinite = 0

    def write(self, block):
        self.blocks += 1
        a = np.asarray(block)
        self.peak = max(self.peak, float(np.abs(a).max()))
        if self.blocks % self.every == 0 and not np.isfinite(a).all():
            self.nonfinite += 1

    def close(self):
        pass


def churn_events(rng, blocks: int, channels: int, every: int):
    """Random CC re-selects + occasional wet/speed edits on mapped
    channels, one event every ~``every`` blocks. Returns the raw
    (block, port, bytes) list so the caller can split it across a
    traced head + untraced remainder."""
    events: list = []
    b = max(int(rng.integers(1, every)), 1)
    while b < blocks:
        ch = int(rng.integers(0, channels))
        r = rng.random()
        if r < 0.8:                      # re-select (the fault driver)
            events.append((b, "", bytes([0xB0 | ch, 21,
                                         int(rng.integers(0, 128))])))
        elif r < 0.9:                    # wet edit mid-stream
            events.append((b, "", bytes([0xB0 | ch, 24,
                                         int(rng.integers(40, 110))])))
        else:                            # fade speed edit
            events.append((b, "", bytes([0xB0 | ch, 25,
                                         int(rng.integers(5, 40))])))
        b += max(int(rng.integers(every // 2, every * 3 // 2)), 1)
    return events


def segment_device_stats(tdir, n_blocks):
    """Per-block DEVICE latency stats for one traced soak window.

    The session mixes step variants (steady / indexed, switching with
    fade activity), so no single event matches the block count — union
    every 'step_coef' executable's device executions (exactly one per
    block, whichever variant ran) and take percentiles over the union.
    Falls back to the generic once-per-step finder when the union does
    not cover the window (e.g. a renamed step)."""
    from tpu_audio.utils import xplane

    durs = xplane.device_step_durations_ms(tdir, "step_coef")
    ms = [m for v in durs.values() for m in v]
    if len(ms) >= max(n_blocks - max(2, n_blocks // 20), 1):
        return dict(xplane.duration_stats_ms(ms), events=sorted(durs))
    return xplane.per_block_stats(tdir, n_blocks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--voices", type=int, default=64)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--sample-rate", type=int, default=44100)
    ap.add_argument("--num-irs", type=int, default=152)
    ap.add_argument("--bank-capacity", type=int, default=16)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--segment-blocks", type=int, default=4096)
    ap.add_argument("--churn-every", type=int, default=32,
                    help="~blocks between MIDI events (hot churn)")
    ap.add_argument("--trace-blocks", type=int, default=128,
                    help="per-segment ON-DEVICE evidence: the first N "
                         "blocks of every segment run inside a "
                         "jax.profiler.trace and the device-plane "
                         "per-block p50/p99 joins the trend — proving "
                         "the ENGINE held real time regardless of host "
                         "pacing (0 disables)")
    ap.add_argument("--fetch-batch", type=int, default=64)
    ap.add_argument("--wire", default="pcm16", choices=["f32", "pcm16"])
    ap.add_argument("--no-realtime", dest="realtime", action="store_false",
                    help="free-run instead of real-time pacing (CPU smoke)")
    ap.add_argument("--pack-cache", default=None)
    ap.add_argument("--record-dir", default="auto",
                    help="'auto' = bench_records/ two levels up; '' off")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.pack_cache is None:
        args.pack_cache = os.path.join(repo, ".bench_cache")
    record_dir = (os.path.join(repo, "bench_records")
                  if args.record_dir == "auto" else args.record_dir or None)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.pack_cache:
        os.makedirs(args.pack_cache, exist_ok=True)

    # keep the repo root on sys.path: running `python examples/soak.py`
    # puts examples/ (not the repo) at sys.path[0], and the tpu_audio
    # imports below need it just as much as bench does
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from tpu_audio.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from bench import make_bank
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.utils.log import Log

    # stdout carries exactly one JSON line; library chatter joins the
    # progress log on stderr (same contract as bench.py)
    prev_info = Log.info_to_stderr
    Log.info_to_stderr = True
    from tpu_audio.models.reverb import ConvolutionReverb
    from tpu_audio.runtime.backends import WavSource

    metric = (f"soak_ws{args.num_irs}_{args.voices}v"
              + ("" if args.realtime else "_freerun"))
    rec = {"metric": metric, "unit": "serving_soak", "partial": True}

    def persist(final=False):
        """Crash-safe persistence. In-flight snapshots go to a SEPARATE
        partial_<metric>.json path: a 1-minute aborted soak must never
        clobber the completed 30-minute last_good evidence (the exact
        newest-wins failure bench._merge_store exists to prevent). Only
        a FINAL record replaces last_good_<metric>.json — and the
        partial twin is removed so a torn run cannot masquerade on."""
        rec["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime())
        if final:
            rec.pop("partial", None)
        if record_dir:
            os.makedirs(record_dir, exist_ok=True)
            name = ("last_good_" if final else "partial_") + metric
            path = os.path.join(record_dir, f"{name}.json")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(rec, fh)
            os.replace(tmp, path)
            if final:
                try:
                    os.remove(os.path.join(record_dir,
                                           f"partial_{metric}.json"))
                except OSError:
                    pass

    import signal

    def on_term(signum, frame):
        rec["error"] = f"SIGTERM at t+{time.perf_counter() - _T0:.0f}s"
        persist()
        print(json.dumps(rec), flush=True)
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):
        pass

    bank = make_bank(args.num_irs, args.ir_seconds, args.sample_rate)
    model = ConvolutionReverb(
        bank, num_voices=args.voices, block=args.block,
        sample_rate=args.sample_rate, engine="fmajor",
        bank_capacity=min(args.bank_capacity, args.num_irs),
        cache_dir=args.pack_cache, fault_upload="derived")
    control = model.control
    control.wet[:] = 0.7
    control.dry[:] = 0.2
    control.predelay[:] = 1024
    control.speed[:] = 10
    channels = min(args.voices, 16)      # MIDI has 16 channels
    for v in range(channels):
        control.set_mapping(v, 0, CCMapping(message=0xB0 | v, select=21,
                                            wet=24, speed=25))
    log(f"soak: {args.voices} voices, {args.num_irs} IRs behind "
        f"{args.bank_capacity} slots, {channels} churned channels, "
        f"{args.minutes:g} min wall")

    rng = np.random.default_rng(20260820)
    src_noise = (rng.standard_normal((2, args.sample_rate * 4))
                 * 0.1).astype(np.float32)
    source = WavSource(src_noise, args.voices, args.block, loop=True)
    sink = CheckedNullSink()
    session = model.session(
        source, sink, realtime=args.realtime, warmup=10,
        fetch_batch=args.fetch_batch, wire=args.wire,
        pipeline_depth=4)

    deadline_ms = args.block / args.sample_rate * 1e3
    ws = model.working_set
    state = model.init_state()
    trend = []
    end_t = _T0 + args.minutes * 60.0
    seg = 0
    bytes_per_block = (args.voices * 2 * args.block
                       * (2 if args.wire == "pcm16" else 4))
    rec.update(voices=args.voices, num_irs=args.num_irs,
               capacity=args.bank_capacity, wire=args.wire,
               realtime=bool(args.realtime), deadline_ms=round(deadline_ms, 3),
               churn_every_blocks=args.churn_every,
               # every byte of output is fetched and spot-verified — context
               # for the missed counter alongside the separately-measured
               # engine-true device cost
               fetch_mb_per_batch=round(bytes_per_block * args.fetch_batch
                                        / 1e6, 2),
               trend=trend)
    from tpu_audio.runtime.stream import MidiSchedule

    tb = max(min(args.trace_blocks, args.segment_blocks // 2), 0)
    try:
        while time.perf_counter() < end_t:
            events = churn_events(rng, args.segment_blocks, channels,
                                  args.churn_every)
            n_events = len(events)
            t0 = time.perf_counter()
            dev = None
            if tb:
                # traced head: the first tb blocks of the segment run
                # inside a profiler window (churn included — events are
                # split and re-based so the timeline is unchanged); the
                # device-plane per-block distribution is the segment's
                # engine-held-real-time proof, independent of host
                # pacing. Profiler overhead rides the WALL numbers of
                # this window only (labeled in the record).
                import shutil
                import tempfile

                head = [e for e in events if e[0] < tb]
                tail = [(b - tb, p, d) for (b, p, d) in events if b >= tb]
                tdir = tempfile.mkdtemp(prefix="tpu_audio_soaktrace_")
                try:
                    with jax.profiler.trace(tdir):
                        state = session.run(state, max_blocks=tb,
                                            midi=MidiSchedule(head))
                    dev = segment_device_stats(tdir, tb)
                except Exception as exc:  # noqa: BLE001 - evidence only
                    dev = {"skipped": f"{type(exc).__name__}: {exc}"[:120]}
                finally:
                    shutil.rmtree(tdir, ignore_errors=True)
                state = session.run(
                    state, max_blocks=args.segment_blocks - tb,
                    midi=MidiSchedule(tail))
            else:
                state = session.run(state, max_blocks=args.segment_blocks,
                                    midi=MidiSchedule(events))
            wall = time.perf_counter() - t0
            seg += 1
            s = session.timer.summary(args.block / args.sample_rate)
            entry = {"t_s": round(time.perf_counter() - _T0, 1),
                     "seg_ms_per_block":
                         round(wall / args.segment_blocks * 1e3, 3),
                     "p99_ms_cum": round(s["p99_ms"], 3),
                     "missed_cum": session.timer.missed,
                     "faults": ws.misses if ws else None,
                     "starved": getattr(ws, "starved", 0) if ws else None,
                     "events": n_events}
            if dev is not None:
                if "p99_ms" in dev:
                    entry["dev_p50_ms"] = dev["p50_ms"]
                    entry["dev_p99_ms"] = dev["p99_ms"]
                    entry["dev_blocks"] = dev["blocks"]
                else:
                    entry["dev_skipped"] = dev.get("skipped")
            trend.append(entry)
            dev_p99s = [e["dev_p99_ms"] for e in trend
                        if "dev_p99_ms" in e]
            if dev_p99s:
                rec.update(
                    device_p99_ms_max=max(dev_p99s),
                    device_p99_segments=len(dev_p99s),
                    device_p99_basis=(
                        f"on-device XLA trace per segment: first {tb} "
                        f"blocks of each segment traced, per-block step-"
                        f"executable durations (steady+indexed union); "
                        f"engine-held-real-time proof independent of "
                        f"host wall pacing"))
            rec.update(blocks=sink.blocks, peak=round(sink.peak, 4),
                       nonfinite_checks=sink.nonfinite,
                       avg_ms=round(s["avg_ms"], 3),
                       p50_ms=round(s["p50_ms"], 3),
                       p99_ms=round(s["p99_ms"], 3),
                       missed=session.timer.missed,
                       missed_basis=("per-block wall incl. batched fetch "
                                     "spikes (fetch_batch="
                                     f"{args.fetch_batch})"),
                       faults=ws.misses if ws else None,
                       starved=getattr(ws, "starved", 0) if ws else None,
                       wall_s=round(time.perf_counter() - _T0, 1),
                       segments=seg)
            persist()
            devtxt = (f" | dev p99 {entry['dev_p99_ms']}"
                      if "dev_p99_ms" in entry else "")
            log(f"seg {seg}: {entry['seg_ms_per_block']} ms/block avg | "
                f"p99cum {entry['p99_ms_cum']} | missed {entry['missed_cum']}"
                f" | faults {entry['faults']} starved {entry['starved']} | "
                f"{sink.blocks} blocks{devtxt}")
    except KeyboardInterrupt:
        rec["error"] = "interrupted"
    except Exception as exc:  # noqa: BLE001 - partial evidence beats none
        rec["error"] = f"{type(exc).__name__}: {exc}"[:300]
        log(f"soak CRASHED: {exc!r}")
    if sink.nonfinite:
        rec["error"] = rec.get("error", "") + "; non-finite output detected"
    ok = "error" not in rec and sink.blocks > 0 and sink.peak > 1e-4
    if ok:
        persist(final=True)
    else:
        persist()
    print(json.dumps(rec), flush=True)
    Log.info_to_stderr = prev_info    # library-safe (in-process tests)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
