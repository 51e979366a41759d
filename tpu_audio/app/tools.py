"""Operational tools CLI.

Capability equivalent of the reference's ops scripts (reference
scripts/makeindex.sh, and the operational gaps SURVEY.md §5 lists):

    python -m tpu_audio.app.tools makeindex <dir> [-o out.index]
    python -m tpu_audio.app.tools prebuild-cache <index> --block 256 --cache-dir .cache
    python -m tpu_audio.app.tools inspect-checkpoint <ckpt.npz>
    python -m tpu_audio.app.tools bank-info <index>
    python -m tpu_audio.app.tools profile <trace-dir-or-xplane.pb>

(The reference's clock-governor scripts floorit/jfloorit have no
equivalent here — device clocks are managed by the platform.)
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tpu_audio.engine.bank import IRBank
from tpu_audio.io.index import make_index, write_index
from tpu_audio.utils.log import Log


def cmd_makeindex(args) -> int:
    entries = make_index(args.directory)
    if not entries:
        Log.warn("tools", "no .wav files under %s", args.directory)
        return 1
    if args.output:
        write_index(args.output, entries)
        Log.info("tools", "wrote %d entries to %s", len(entries), args.output)
    else:
        for e in entries:
            print(e)
    return 0


def cmd_prebuild_cache(args) -> int:
    bank = IRBank.from_index(args.index, verbose=not args.quiet,
                             max_seconds=args.max_ir_seconds)
    spectra = bank.cached_partitioned_spectra(args.block, args.cache_dir)
    Log.info("tools", "cached spectra %s (%.1f MB) for %d IRs",
             tuple(spectra.shape), spectra.nbytes / 1e6, len(bank))
    return 0


def cmd_inspect_checkpoint(args) -> int:
    with np.load(args.checkpoint) as data:
        header = json.loads(bytes(data["header"]).decode())
        print(json.dumps(header, indent=2))
        for name in data.files:
            if name != "header":
                arr = data[name]
                print(f"{name}: shape={arr.shape} dtype={arr.dtype}")
    return 0


def cmd_bank_info(args) -> int:
    bank = IRBank.from_index(args.index, verbose=False)
    print(f"{len(bank)} IRs, longest {bank.max_length} frames "
          f"({bank.max_length / bank.sample_rate:.2f} s), "
          f"{bank.max_partitions(args.block)} partitions at block {args.block}")
    for i, path in enumerate(bank.paths):
        ir = bank.ir(i)
        print(f"  [{i:3d}] {ir.shape[1]:7d} frames  peak {np.abs(ir).max():.3f}  {path}")
    return 0


def cmd_profile(args) -> int:
    """Summarise a jax.profiler trace (capture one around any session or
    bounce with ``with jax.profiler.trace(dir): ...``): per plane, the
    top events by total device time with count and p50/p99 per-execution
    durations. Uses the schema-free xplane reader (utils/xplane.py) — no
    tensorflow/tensorboard needed on this image."""
    import os

    from tpu_audio.utils import xplane

    path = args.trace
    if os.path.isdir(path):
        path = xplane.newest_trace(path)
    if path is None or not os.path.exists(path):
        Log.error("tools", "no .xplane.pb at/under %s", args.trace)
        return 2
    print(f"trace: {path}")
    for plane, events in xplane.plane_events(path).items():
        rows = []
        for name, durs in events.items():
            if not durs:
                continue
            ms = np.asarray(durs, np.float64) / 1e9
            rows.append((float(ms.sum()), len(ms),
                         float(np.percentile(ms, 50)),
                         float(np.percentile(ms, 99)), name))
        if not rows:
            continue
        rows.sort(reverse=True)
        print(f"\nplane {plane!r}: {len(rows)} event kinds")
        print(f"  {'total_ms':>10}  {'count':>7}  {'p50_ms':>8}  "
              f"{'p99_ms':>8}  event")
        for tot, cnt, p50, p99, name in rows[:args.top]:
            print(f"  {tot:10.3f}  {cnt:7d}  {p50:8.4f}  {p99:8.4f}  "
                  f"{name[:80]}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_audio.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    mi = sub.add_parser("makeindex", help="index all .wav files under a dir")
    mi.add_argument("directory")
    mi.add_argument("-o", "--output", default=None)
    mi.set_defaults(fn=cmd_makeindex)

    pc = sub.add_parser("prebuild-cache", help="precompute IR spectra cache")
    pc.add_argument("index")
    pc.add_argument("--block", type=int, default=256)
    pc.add_argument("--cache-dir", default=".tpu_audio_cache")
    pc.add_argument("--max-ir-seconds", type=float, default=None)
    pc.add_argument("--quiet", action="store_true")
    pc.set_defaults(fn=cmd_prebuild_cache)

    ic = sub.add_parser("inspect-checkpoint", help="print checkpoint contents")
    ic.add_argument("checkpoint")
    ic.set_defaults(fn=cmd_inspect_checkpoint)

    bi = sub.add_parser("bank-info", help="summarise an IR bank index")
    bi.add_argument("index")
    bi.add_argument("--block", type=int, default=256)
    bi.set_defaults(fn=cmd_bank_info)

    pr = sub.add_parser("profile",
                        help="summarise a jax.profiler trace "
                             "(top device events, counts, p50/p99)")
    pr.add_argument("trace", help="trace dir or .xplane.pb file")
    pr.add_argument("--top", type=int, default=12,
                    help="events shown per plane")
    pr.set_defaults(fn=cmd_profile)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
