"""High-voice cascade probe: steady cost + compiled-memory breakdown.

Measures the steady engine-true ms/block at a given voice count / dtype /
predelay-side, prints `memory_analysis()`, and writes the optimized HLO
to a file so large temp buffers can be attributed to ops offline.

Usage (repo root):
  python examples/probe_cascade_hv.py --voices 2048 --dtype bf16 \
      --predelay-side read --hlo /tmp/casc2048.hlo
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voices", type=int, default=2048)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--predelay-side", default="read",
                    choices=["write", "read"])
    ap.add_argument("--num-irs", type=int, default=4)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--ratio", type=int, default=16)
    ap.add_argument("--hlo", default=None,
                    help="write optimized HLO text here for temp triage")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--skip-timing", action="store_true",
                    help="compile + memory analysis only")
    ap.add_argument("--stage-breakdown", action="store_true",
                    help="time full/head/tail variants interleaved in one "
                         "session (weather-immune comparison)")
    ap.add_argument("--stages", default=None,
                    help="comma list (head,tail): time a stage subset in "
                         "isolation (diagnostic; see CascadeConvolution._step)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import bench
    from tpu_audio.engine import ControlPlane
    from tpu_audio.engine.cascade import CascadeConvolution
    from tpu_audio.models.reverb import _fit_cascade_ratio

    t_start = time.time()
    bank = bench.make_bank(args.num_irs, args.ir_seconds, 44100)
    partitions = bank.max_partitions(args.block)
    ratio = _fit_cascade_ratio(args.ratio, args.voices, partitions)
    engine = CascadeConvolution(
        args.voices, args.block, partitions, ratio=ratio,
        max_predelay=8192, num_irs=args.num_irs, mac_dtype=args.dtype,
        predelay_side=args.predelay_side)
    spectra = engine.prepare_bank(bank, cache_dir=args.cache_dir)
    control = ControlPlane(args.voices, args.num_irs)
    control.wet[:] = 0.7
    control.dry[:] = 0.2
    control.predelay[:] = 1024
    params = jax.tree.map(jnp.asarray, control.snapshot())
    print(f"[probe] bank built t={time.time()-t_start:.1f}s "
          f"(ratio {ratio}, partitions {partitions})", file=sys.stderr)

    rng = np.random.default_rng(2)
    shape = (args.voices, 2, args.block)
    pool = [jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05)
            for _ in range(4)]
    make_block = lambda t: pool[t % len(pool)]

    if args.stages:
        stage_set = tuple(args.stages.split(","))
        step_fn = lambda st, bk, pr, xb: engine._step(  # noqa: E731
            st, bk, pr, xb, with_base=False, stages=stage_set)
    else:
        step_fn = engine.step_coef_steady

    state_shape = jax.eval_shape(lambda: engine.init_state())
    steady = jax.jit(step_fn, donate_argnums=(0,))
    compiled = steady.lower(state_shape, spectra, params, pool[0]).compile()
    state = engine.init_converged(spectra, params)
    print(f"[probe] compiled t={time.time()-t_start:.1f}s", file=sys.stderr)

    try:
        ma = compiled.memory_analysis()
        mem = {k: getattr(ma, k, None) for k in
               ("temp_size_in_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "alias_size_in_bytes",
                "generated_code_size_in_bytes")}
        print("[probe] memory:", {k: (f"{v/1e6:.1f}MB" if v else v)
                                  for k, v in mem.items()}, file=sys.stderr)
    except Exception as exc:  # noqa: BLE001
        mem = {"error": str(exc)}
        print("[probe] memory_analysis failed:", exc, file=sys.stderr)

    if args.hlo:
        try:
            txt = compiled.as_text()
            with open(args.hlo, "w") as fh:
                fh.write(txt)
            # quick triage: largest tensor shapes appearing as fusion roots
            sizes = {}
            for m in re.finditer(r"(f32|bf16|s32|pred)\[([0-9,]+)\]", txt):
                dt, dims = m.group(1), m.group(2)
                n = 1
                for d in dims.split(","):
                    n *= int(d)
                bytes_ = n * (2 if dt == "bf16" else 1 if dt == "pred" else 4)
                key = f"{dt}[{dims}]"
                sizes[key] = bytes_
            top = sorted(sizes.items(), key=lambda kv: -kv[1])[:12]
            print("[probe] largest shapes in HLO:", file=sys.stderr)
            for k, v in top:
                print(f"    {v/1e6:9.1f} MB  {k}", file=sys.stderr)
        except Exception as exc:  # noqa: BLE001
            print("[probe] HLO dump failed:", exc, file=sys.stderr)

    result = {"voices": args.voices, "dtype": args.dtype,
              "predelay_side": args.predelay_side, "ratio": ratio,
              "num_irs": args.num_irs, "memory": mem}
    if args.stage_breakdown:
        # time full / head-only / tail-only in ONE process so the
        # comparison shares one card and one warm state
        del state                            # free the main-path copy
        import functools
        timings = {}
        variants = {"full": ("head", "tail"), "head": ("head",),
                    "tail": ("tail",)}
        # sequential per variant (one state copy live at a time),
        # back-to-back in one process
        for name, st_set in variants.items():
            fn = jax.jit(functools.partial(
                engine._step, with_base=False, stages=st_set),
                donate_argnums=(0,))
            s = engine.init_converged(spectra, params)
            s, o = fn(s, spectra, params, pool[0])
            bk = spectra
            np.asarray(o[0, 0, :4])          # force completion
            print(f"[probe] {name} compiled+first", file=sys.stderr)
            for _rep in range(args.reps + 1):
                t0 = time.perf_counter()
                for tb in range(args.blocks):
                    s, o = fn(s, bk, params, make_block(tb))
                np.asarray(o[0, 0, :4])
                dt_ms = (time.perf_counter() - t0) / args.blocks * 1e3
                timings.setdefault(name, []).append(round(dt_ms, 3))
            del s, o
        best = {k: min(v) for k, v in timings.items()}
        print(f"[probe] stage breakdown (best of {args.reps + 1}): {best} "
              f"(all reps: {timings})", file=sys.stderr)
        result.update(stage_ms=best, stage_reps=timings)
        print(json.dumps(result))
        return 0
    if not args.skip_timing:
        ms, _ = bench.engine_true_ms(
            steady, state, spectra, params, make_block, args.blocks,
            reps=args.reps)
        deadline_ms = args.block / 44100 * 1e3
        result.update(steady_ms=round(ms, 3),
                      rtf=round(deadline_ms / ms, 3))
        print(f"[probe] steady {ms:.3f} ms/block "
              f"(RTF {result['rtf']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
