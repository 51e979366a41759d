"""fmajor stage-breakdown probe: attribute the production engine's
per-block cost to input transform / all-K MAC / finish (phase-ramp
predelay + irfft + wet ring + mix) using the diagnostic ``stages=``
filter (engine/fmajor.py step_coef).

All variants run sequentially in ONE process so they share one card
state (compare versions only within one run; see CLAUDE.md). The
delay-line update always runs, so subtracting
a stage subset from 'full' attributes the remaining cost.

Usage (on the GPU):
    python examples/probe_fmajor_stages.py [--voices 64] [--dtype f32]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voices", type=int, default=64)
    ap.add_argument("--num-irs", type=int, default=4)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (post-import config)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import bench
    from tpu_audio.engine import ControlPlane
    from tpu_audio.engine.fmajor import FMajorPartitionedConvolution

    t_start = time.time()
    bank = bench.make_bank(args.num_irs, args.ir_seconds, 44100)
    partitions = bank.max_partitions(args.block)
    engine = FMajorPartitionedConvolution(
        args.voices, args.block, partitions, max_predelay=8192,
        mac_strategy="allk", num_irs=args.num_irs, mac_dtype=args.dtype)
    if args.cache_dir:
        host_spec = bank.cached_partitioned_spectra(
            args.block, args.cache_dir, max_partitions=partitions)
    else:
        host_spec = bank.partitioned_spectra(args.block,
                                             max_partitions=partitions)
    spectra = engine.prepare_bank(host_spec, cache_dir=args.cache_dir)
    control = ControlPlane(args.voices, args.num_irs)
    control.wet[:] = 0.7
    control.dry[:] = 0.2
    control.predelay[:] = 1024
    params = jax.tree.map(jnp.asarray, control.snapshot())
    print(f"[probe] bank built t={time.time()-t_start:.1f}s "
          f"({partitions} partitions)", file=sys.stderr)

    rng = np.random.default_rng(2)
    shape = (args.voices, 2, args.block)
    pool = [jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05)
            for _ in range(4)]
    make_block = lambda t: pool[t % len(pool)]

    variants = {
        "full": ("input", "mac", "finish"),
        "input": ("input",),
        "mac": ("mac",),
        "finish": ("finish",),
        "input_mac": ("input", "mac"),
    }
    timings = {}
    for name, st_set in variants.items():
        fn = jax.jit(functools.partial(
            engine.step_coef, with_base=False, stages=st_set),
            donate_argnums=(0,))
        s = engine.init_converged(spectra, params)
        s, o = fn(s, spectra, params, pool[0])
        np.asarray(o[0, 0, :4])          # force completion (see CLAUDE.md)
        print(f"[probe] {name} compiled+first t={time.time()-t_start:.1f}s",
              file=sys.stderr)
        for _rep in range(args.reps + 1):
            t0 = time.perf_counter()
            for tb in range(args.blocks):
                s, o = fn(s, spectra, params, make_block(tb))
            np.asarray(o[0, 0, :4])
            dt_ms = (time.perf_counter() - t0) / args.blocks * 1e3
            timings.setdefault(name, []).append(round(dt_ms, 3))
        del s, o
    best = {k: min(v) for k, v in timings.items()}
    deadline_ms = args.block / 44100 * 1e3
    print(f"[probe] stage breakdown best-of-{args.reps + 1}: {best} "
          f"(all: {timings})", file=sys.stderr)
    print(json.dumps({
        "voices": args.voices, "dtype": args.dtype,
        "num_irs": args.num_irs, "stage_ms": best,
        "full_rtf": round(deadline_ms / best["full"], 3),
        "stage_reps": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
