"""Same-process FULL-ENGINE A/B of the cascade tail-MAC lowering.

probe_tail_mac.py times the isolated contraction; this probe answers the
production question — which `tail_mac` is faster for the WHOLE step at a
given (voices, dtype) — by building both engines over one shared bank
and interleaving timing rounds, so both variants see the same card state.
engine/cascade.py's `tail_mac="auto"` threshold rests on this comparison
(PERF.md has the numbers).

Usage (on the GPU):
    python examples/probe_tailmac_ab.py [--voices 1024] [--dtype f32]
        [--rounds 4] [--blocks 32] [--cache-dir .bench_cache]
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
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--num-irs", type=int, default=4)
    ap.add_argument("--ir-seconds", type=float, default=4.0)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--ratio", type=int, default=16)
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import bench
    from tpu_audio.engine import ControlPlane
    from tpu_audio.engine.cascade import CascadeConvolution
    from tpu_audio.models.reverb import _fit_cascade_ratio

    t0 = time.time()
    bank = bench.make_bank(args.num_irs, args.ir_seconds, 44100)
    partitions = bank.max_partitions(args.block)
    ratio = _fit_cascade_ratio(args.ratio, args.voices, partitions)

    rng = np.random.default_rng(2)
    shape = (args.voices, 2, args.block)
    pool = [jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05)
            for _ in range(4)]

    runs = {}
    for variant in ("reduce", "dot"):
        engine = CascadeConvolution(
            args.voices, args.block, partitions, ratio=ratio,
            max_predelay=8192, num_irs=args.num_irs, mac_dtype=args.dtype,
            predelay_side="read", tail_mac=variant)
        spectra = engine.prepare_bank(bank, cache_dir=args.cache_dir)
        control = ControlPlane(args.voices, args.num_irs)
        control.wet[:] = 0.7
        control.dry[:] = 0.2
        control.predelay[:] = 1024
        params = jax.tree.map(jnp.asarray, control.snapshot())
        fn = jax.jit(engine.step_coef_steady, donate_argnums=(0,))
        state = engine.init_converged(spectra, params)
        state, out = fn(state, spectra, params, pool[0])
        np.asarray(out[0, 0, :4])            # force completion
        runs[variant] = dict(fn=fn, state=state, spectra=spectra,
                             params=params, times=[])
        print(f"[ab] {variant} compiled+first t={time.time()-t0:.1f}s",
              file=sys.stderr)

    # interleaved rounds: both variants see the same card state
    for rnd in range(args.rounds):
        for variant, r in runs.items():
            t1 = time.perf_counter()
            st = r["state"]
            for tb in range(args.blocks):
                st, out = r["fn"](st, r["spectra"], r["params"],
                                  pool[tb % len(pool)])
            np.asarray(out[0, 0, :4])
            r["state"] = st
            dt_ms = (time.perf_counter() - t1) / args.blocks * 1e3
            r["times"].append(round(dt_ms, 3))
            print(f"[ab] round {rnd} {variant:4s} {dt_ms:8.3f} ms",
                  file=sys.stderr)

    best = {v: min(r["times"]) for v, r in runs.items()}
    print(f"[ab] best-of-{args.rounds}: {best}", file=sys.stderr)
    print(json.dumps({
        "voices": args.voices, "dtype": args.dtype, "ratio": ratio,
        "best_ms": best,
        "reps": {v: r["times"] for v, r in runs.items()},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
