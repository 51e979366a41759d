"""High-voice LARGE-BANK serving probe: cascade engine + working-set
residency. The claim under test: a 152-IR bank serves at 1024 voices in
real time on one chip, because the engine only ever runs the fast all-K
MAC over `capacity` resident slots while selects page IRs in on demand
(runtime/working_set.py; the per-block cost is set by capacity, not by
the bank size).

Measures (one process, chained dispatch):
  - steady engine-true ms/block at V voices over `capacity` slots, and
  - real fault latency through the control plane's select path (host
    two-resolution rfft + ~2 MB upload + slot write; first fault
    reported separately — sessions pre-compile it via warmup()).

Usage (on the GPU):
    python examples/probe_ws_cascade.py [--voices 1024] [--num-irs 152]
        [--capacity 16] [--dtype f32] [--faults 4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voices", type=int, default=1024)
    ap.add_argument("--num-irs", type=int, default=152)
    ap.add_argument("--capacity", type=int, default=16)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--ratio", type=int, default=16)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--faults", type=int, default=4)
    ap.add_argument("--async", dest="async_paging", action="store_true",
                    help="measure DEFERRED faults: the select-path stall "
                         "(should be ~0: the pack+upload runs on a worker "
                         "thread) and the drain time to publication")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import bench
    from tpu_audio.models.reverb import ConvolutionReverb

    t_start = time.time()
    bank = bench.make_bank(args.num_irs, args.ir_seconds, 44100)
    print(f"[probe] {args.num_irs}-IR bank built t={time.time()-t_start:.1f}s",
          file=sys.stderr)
    model = ConvolutionReverb(
        bank, num_voices=args.voices, block=args.block, engine="cascade",
        max_predelay=8192, bank_capacity=args.capacity,
        cascade_ratio=args.ratio, mac_dtype=args.dtype,
        cache_dir=args.cache_dir, async_paging=args.async_paging)
    control, engine, ws = model.control, model.engine, model.working_set
    control.wet[:] = 0.7
    control.dry[:] = 0.2
    control.predelay[:] = 1024
    params = jax.tree.map(jnp.asarray, control.snapshot())
    spectra = model.spectra
    print(f"[probe] model built t={time.time()-t_start:.1f}s "
          f"(ratio {engine.ratio}, capacity {args.capacity})",
          file=sys.stderr)

    rng = np.random.default_rng(2)
    shape = (args.voices, 2, args.block)
    pool = [jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05)
            for _ in range(4)]
    make_block = lambda t: pool[t % len(pool)]

    steady = jax.jit(engine.step_coef_steady, donate_argnums=(0,))
    state = engine.init_converged(spectra, params)
    print(f"[probe] compiled t={time.time()-t_start:.1f}s", file=sys.stderr)

    ms, state = bench.engine_true_ms(
        steady, state, spectra, params, make_block, args.blocks,
        reps=args.reps)
    deadline_ms = args.block / 44100 * 1e3
    result = {"voices": args.voices, "num_irs": args.num_irs,
              "capacity": args.capacity, "dtype": args.dtype,
              "ratio": engine.ratio, "steady_ms": round(ms, 3),
              "rtf": round(deadline_ms / ms, 3)}
    print(f"[probe] steady {ms:.3f} ms/block over {args.capacity} resident "
          f"slots (RTF {result['rtf']})", file=sys.stderr)

    # real faults through the select path (remap + evict + pack + upload)
    if args.async_paging:
        # deferred: the select call must return immediately (the pack +
        # upload runs on the pager thread); drain() waits for publication
        ws.warmup()  # compile the slot update off the measured path
        stall_ms, drain_ms = [], []
        for i in range(args.faults):
            full_idx = args.capacity + i
            if full_idx >= args.num_irs:
                break
            t0 = time.perf_counter()
            control.set_select(0, 0, full_idx)
            stall_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ws.drain()
            drain_ms.append((time.perf_counter() - t0) * 1e3)
            control.vsteps[:] = 0
        result.update(
            async_stall_ms=(round(float(np.median(stall_ms)), 3)
                            if stall_ms else None),
            async_drain_ms=(round(float(np.median(drain_ms)), 1)
                            if drain_ms else None),
            faults=ws.misses, deferred=ws.deferred)
        print(f"[probe] deferred fault: select-path stall median "
              f"{result['async_stall_ms']} ms, drain-to-published median "
              f"{result['async_drain_ms']} ms", file=sys.stderr)
    else:
        # a one-element readback forces completion
        fault_ms = []
        for i in range(args.faults):
            full_idx = args.capacity + i
            if full_idx >= args.num_irs:
                break
            t0 = time.perf_counter()
            control.set_select(0, 0, full_idx)
            slot = int(control.select[0, 0])
            np.asarray(ws.bank.head_rhs2[0, 0, 0, slot * 4])
            fault_ms.append((time.perf_counter() - t0) * 1e3)
            control.vsteps[:] = 0
        warm = fault_ms[1:] or fault_ms
        result.update(
            fault_ms=round(float(np.median(warm)), 1) if warm else None,
            fault_compile_ms=round(fault_ms[0], 1) if fault_ms else None,
            faults=ws.misses)
        print(f"[probe] fault latency median {result['fault_ms']} ms "
              f"(first incl. compile {result['fault_compile_ms']} ms)",
              file=sys.stderr)
    if args.async_paging:
        ws.close()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
