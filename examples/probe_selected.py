"""Staged probe for the cascade 'selected' strategy on the GPU.

Isolates the stages (bank upload, zero state init, sel gathers, first
steady dispatch, steady timing) with explicit readbacks and flushes so a
stall point is visible. Each stage prints BEFORE it starts.

Usage:
  python examples/probe_selected.py --voices 64 --num-irs 152 \
      --cache-dir .bench_cache
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voices", type=int, default=64)
    ap.add_argument("--num-irs", type=int, default=152)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=50)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache-dir", default=".bench_cache")
    ap.add_argument("--skip-fade", action="store_true")
    ap.add_argument("--stage-breakdown", action="store_true",
                    help="additionally time head-only / tail-only steady "
                         "variants in THIS process")
    args = ap.parse_args()

    t0 = time.time()

    def stage(name):
        print(f"[probe t+{time.time()-t0:6.1f}s] {name}", file=sys.stderr,
              flush=True)

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from tpu_audio.engine import ControlPlane
    from tpu_audio.engine.cascade import CascadeConvolution
    from tpu_audio.models.reverb import _fit_cascade_ratio

    stage("bank build + pack")
    bank = bench.make_bank(args.num_irs, args.ir_seconds, 44100)
    partitions = bank.max_partitions(args.block)
    ratio = _fit_cascade_ratio(16, args.voices, partitions)
    engine = CascadeConvolution(
        args.voices, args.block, partitions, ratio=ratio, max_predelay=8192,
        num_irs=args.num_irs, mac_dtype="f32", mac_strategy="selected")
    spectra = engine.prepare_bank(bank, cache_dir=args.cache_dir)
    control = ControlPlane(args.voices, args.num_irs)
    control.wet[:] = 0.7
    control.dry[:] = 0.2
    control.predelay[:] = 1024
    control.select[:] = (np.arange(args.voices * 2).reshape(-1, 2)
                         % args.num_irs)
    params = jax.tree.map(jnp.asarray, control.snapshot())

    stage("bank upload readback")
    np.asarray(spectra.head_rhs2[0, 0, 0, :2])  # force the transfer done
    np.asarray(spectra.tail_rhs2[0, 0, 0, :2])

    rng = np.random.default_rng(5)
    pool = [jnp.asarray(rng.standard_normal(
        (args.voices, 2, args.block)).astype(np.float32) * 0.05)
        for _ in range(4)]

    stage("zero state init (init_state)")
    state = engine.init_state()
    np.asarray(state.coef_a[:1, 0])

    stage("sel_head gather compile+run")
    gh = jax.jit(engine._gather_head)(spectra, params.select)
    np.asarray(gh[0, 0, 0, 0, :2])
    stage("sel_tail gather compile+run")
    gt = jax.jit(engine._gather_tail)(spectra, params.select)
    np.asarray(gt[0, 0, 0, 0, :2, 0])

    from dataclasses import replace
    state = replace(state, coef_c=jnp.asarray(
        np.asarray(control.wet, np.float32)), sel_head=gh, sel_tail=gt)

    steady = jax.jit(engine.step_coef_steady, donate_argnums=(0,))
    fade = jax.jit(engine.step_coef, donate_argnums=(0,))
    collapse = jax.jit(engine.collapse)

    stage("first steady dispatch")
    state, out = steady(state, spectra, params, pool[0])
    np.asarray(out[0, 0, :2])

    stage("steady timing")
    ms, state = bench.engine_true_ms(
        steady, state, spectra, params, lambda t: pool[t % 4], args.blocks,
        reps=args.reps)
    dl = args.block / 44100 * 1e3
    result = {"voices": args.voices, "num_irs": args.num_irs,
              "strategy": "selected", "steady_ms": round(ms, 3),
              "rtf": round(dl / ms, 3)}
    stage(f"steady {ms:.3f} ms/block (RTF {result['rtf']})")

    if not args.skip_fade:
        stage("collapse compile+run")
        control.vsteps[:] = 1 << 20
        new_sel = (control.select + 1) % args.num_irs
        control.select[:] = new_sel
        params_f = jax.tree.map(jnp.asarray, control.snapshot())
        changed = jnp.asarray(np.ones((args.voices, 2), bool))
        state = collapse(state, spectra, params.select, changed,
                         jnp.asarray(new_sel), params_f)
        np.asarray(state.coef_a[:1, 0])
        stage("first fade dispatch")
        state, out = fade(state, spectra, params_f, pool[0])
        np.asarray(out[0, 0, :2])
        stage("fade timing")
        ms_f, _ = bench.engine_true_ms(
            fade, state, spectra, params_f, lambda t: pool[t % 4],
            args.blocks, reps=args.reps)
        result["fade_general_ms"] = round(ms_f, 3)
        stage(f"fade-general {ms_f:.3f} ms/block")

    if args.stage_breakdown:
        import functools
        for name, st_set in (("head", ("head",)), ("tail", ("tail",))):
            stage(f"{name}-only compile+run")
            fn = jax.jit(functools.partial(engine._step, with_base=False,
                                           stages=st_set),
                         donate_argnums=(0,))
            s = engine.init_state()
            # gh/gt were donated away with the main timing loop's state —
            # re-gather fresh selected rhs leaves for each variant
            s = replace(s, coef_c=jnp.asarray(
                np.asarray(control.wet, np.float32)),
                sel_head=jax.jit(engine._gather_head)(spectra,
                                                      params.select),
                sel_tail=jax.jit(engine._gather_tail)(spectra,
                                                      params.select))
            s, o = fn(s, spectra, params, pool[0])
            np.asarray(o[0, 0, :2])
            best = []
            for _rep in range(args.reps + 1):
                t1 = time.time()
                for tb in range(args.blocks):
                    s, o = fn(s, spectra, params, pool[tb % 4])
                np.asarray(o[0, 0, :2])
                best.append((time.time() - t1) / args.blocks * 1e3)
            del s, o
            result[f"{name}_ms"] = round(min(best), 3)
            stage(f"{name}-only {result[f'{name}_ms']:.3f} ms/block")

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
