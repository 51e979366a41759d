"""Isolated tail-MAC lowering A/B probe (cascade 2048v shapes).

The 2048v HLO shows the tail group slice materialized as a pure 201 MB
copy (dynamic-slice -> bitcast kLoop fusion) before the MAC reduce.
This probe times the candidate lowerings in ONE process, so they share
one card state (compare versions only within one run):

  p1  current engine form: slice the group from the [M, ...] delay
      line (pre-update) + fresh-column correction MAC
  p2  leaf-direct: the group is its own array (no M axis, no slice) —
      the restructure target's roofline (lax.switch over per-group
      leaves would hit this minus switch overhead)
  p3  post-update slice: update the column in place, slice, MAC
      (no correction path)
  p4  p2 with f32 operands (elementwise rate check: bf16 vs f32
      mul+reduce)
  p5  dot_general: batch F2, contract (d,q) -> [F2,Vg,I,K4]
      (output stays frequency-MAJOR — measures the raw matmul rate)
  p6  p5 + transpose back to the engine's [Vg,I,K4,F2] layout
      (what a drop-in engine swap would actually cost)

Usage: python examples/probe_tail_mac.py [--voices 2048] [--reps 3]
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
    ap.add_argument("--voices", type=int, default=2048)
    ap.add_argument("--ratio", type=int, default=16)
    ap.add_argument("--pp2", type=int, default=48)
    ap.add_argument("--f2", type=int, default=4097)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--blocks", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="comma list of probe names to run (p1,p2,p3,p4)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    m = args.ratio
    vg = args.voices // m
    i, d = 2, 2
    q, f2 = args.pp2, args.f2
    k4 = args.k * 4
    dt = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32

    # data is generated ON DEVICE: a [M,Vg,...] f32 host array is 6.4 GB,
    # which host-side generation and upload would spend minutes on
    keyring = iter(jax.random.split(jax.random.PRNGKey(0), 16))

    def arr(*shape, dtype=dt):
        return jax.jit(
            lambda k: jax.random.normal(k, shape, jnp.float32
                                        ).astype(dtype) * 0.1)(next(keyring))

    # factories: donation consumes the state array, so each probe gets a
    # fresh one
    fdl_full = lambda: arr(m, vg, i, d, q, f2)   # [M,Vg,I,d,q,F2]
    fdl_leaf = lambda: arr(vg, i, d, q, f2)
    rhs2 = arr(d, 2 * q, k4, f2)             # doubled window source
    col = arr(1, vg, i, d, 1, f2)

    def mac(old_g, rhs):
        return jnp.sum(old_g[:, :, :, :, None, :] * rhs[None, None],
                       axis=(2, 3), dtype=jnp.float32)  # [Vg,I,K4,F2]

    # each step consumes the previous output so dispatches chain: fold a
    # scalar of m2 back into the window offset (data dependence, no
    # host sync until the end)
    @functools.partial(jax.jit, donate_argnums=(0,))
    def p1(fdl, rhs2, col, g, w):
        rhs = jax.lax.dynamic_slice_in_dim(rhs2, q - w, q, axis=1)
        old_g = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, 0, 0), (1, vg, i, d, q, f2)
        ).reshape(vg, i, d, q, f2)
        m2 = mac(old_g, rhs)
        old_col = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, w, 0), (1, vg, i, d, 1, f2)
        ).reshape(vg, i, d, 1, f2)
        rhs_col = rhs2[:, q: q + 1]
        delta = col.reshape(vg, i, d, 1, f2) - old_col
        m2 = m2 + jnp.sum(delta[:, :, :, :, None, :] * rhs_col[None, None],
                          axis=(2, 3), dtype=jnp.float32)
        fdl = jax.lax.dynamic_update_slice(fdl, col, (g, 0, 0, 0, w, 0))
        return fdl, m2

    @functools.partial(jax.jit, donate_argnums=(0,))
    def p2(leaf, rhs2, col, g, w):
        rhs = jax.lax.dynamic_slice_in_dim(rhs2, q - w, q, axis=1)
        leaf = jax.lax.dynamic_update_slice(
            leaf, col.reshape(vg, i, d, 1, f2), (0, 0, 0, w, 0))
        m2 = mac(leaf, rhs)
        return leaf, m2

    @functools.partial(jax.jit, donate_argnums=(0,))
    def p3(fdl, rhs2, col, g, w):
        rhs = jax.lax.dynamic_slice_in_dim(rhs2, q - w, q, axis=1)
        fdl = jax.lax.dynamic_update_slice(fdl, col, (g, 0, 0, 0, w, 0))
        old_g = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, 0, 0), (1, vg, i, d, q, f2)
        ).reshape(vg, i, d, q, f2)
        m2 = mac(old_g, rhs)
        return fdl, m2

    # dot forms: contract (d, q) as a matmul with F2 as the batch axis.
    # lhs [Vg,I,d,q,F2] x rhs [d,q,K4,F2] -> [F2, Vg*I, K4] batched
    # matmul: M = Vg*I rows (256 at 2048v), K = d*q = 96, N = K4 = 16.
    dn = (((2, 3), (0, 1)), ((4,), (3,)))

    def mac_dot(old_g, rhs):
        return jax.lax.dot_general(
            old_g, rhs, dn, preferred_element_type=jnp.float32)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def p5(fdl, rhs2, col, g, w):
        rhs = jax.lax.dynamic_slice_in_dim(rhs2, q - w, q, axis=1)
        old_g = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, 0, 0), (1, vg, i, d, q, f2)
        ).reshape(vg, i, d, q, f2)
        m2 = mac_dot(old_g, rhs)                      # [F2, Vg, I, K4]
        old_col = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, w, 0), (1, vg, i, d, 1, f2)
        ).reshape(vg, i, d, 1, f2)
        delta = col.reshape(vg, i, d, 1, f2) - old_col
        m2 = m2 + mac_dot(delta, rhs2[:, q: q + 1])
        fdl = jax.lax.dynamic_update_slice(fdl, col, (g, 0, 0, 0, w, 0))
        return fdl, m2

    @functools.partial(jax.jit, donate_argnums=(0,))
    def p6(fdl, rhs2, col, g, w):
        rhs = jax.lax.dynamic_slice_in_dim(rhs2, q - w, q, axis=1)
        old_g = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, 0, 0), (1, vg, i, d, q, f2)
        ).reshape(vg, i, d, q, f2)
        m2 = mac_dot(old_g, rhs)
        old_col = jax.lax.dynamic_slice(
            fdl, (g, 0, 0, 0, w, 0), (1, vg, i, d, 1, f2)
        ).reshape(vg, i, d, 1, f2)
        delta = col.reshape(vg, i, d, 1, f2) - old_col
        m2 = m2 + mac_dot(delta, rhs2[:, q: q + 1])
        m2 = jnp.transpose(m2, (1, 2, 3, 0))          # [Vg, I, K4, F2]
        fdl = jax.lax.dynamic_update_slice(fdl, col, (g, 0, 0, 0, w, 0))
        return fdl, m2

    probes = {"p1": (p1, "slice+correction (current)", fdl_full),
              "p2": (p2, "leaf-direct (target)", fdl_leaf),
              "p3": (p3, "post-update slice", fdl_full),
              "p5": (p5, "dot, F-major out", fdl_full),
              "p6": (p6, "dot + transpose to F-minor", fdl_full)}
    if args.dtype == "bf16":
        fdl_leaf32 = lambda: arr(vg, i, d, q, f2, dtype=jnp.float32)
        rhs2_32 = arr(d, 2 * q, k4, f2, dtype=jnp.float32)
        col32 = arr(1, vg, i, d, 1, f2, dtype=jnp.float32)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def p4(leaf, rhs2, col, g, w):
            rhs = jax.lax.dynamic_slice_in_dim(rhs2, q - w, q, axis=1)
            leaf = jax.lax.dynamic_update_slice(
                leaf, col.reshape(vg, i, d, 1, f2), (0, 0, 0, w, 0))
            m2 = mac(leaf, rhs)
            return leaf, m2

        probes["p4"] = (p4, "leaf-direct f32",
                        lambda: (fdl_leaf32(), rhs2_32, col32))

    names = (args.only.split(",") if args.only else list(probes))
    results = {}
    for name in names:
        fn, desc, init = probes[name]
        if name == "p4":
            st, r2v, cv = init()
        else:
            st, r2v, cv = init(), rhs2, col
        t0 = time.time()
        g = jnp.int32(0)
        w = jnp.int32(0)
        st2, out = fn(st, r2v, cv, g, w)
        _ = np.asarray(out[0, 0, 0, :4])
        print(f"[{name}] compiled+first t={time.time()-t0:.1f}s",
              file=sys.stderr, flush=True)
        best = float("inf")
        for _rep in range(args.reps):
            t0 = time.perf_counter()
            for t in range(args.blocks):
                g = jnp.int32(t % m)
                w = jnp.int32(t % q)
                st2, out = fn(st2, r2v, cv, g, w)
            _ = np.asarray(out[0, 0, 0, :4])
            best = min(best, (time.perf_counter() - t0) / args.blocks)
        results[name] = round(best * 1e3, 3)
        print(f"[{name}] {desc}: {results[name]} ms", file=sys.stderr,
              flush=True)
    print(json.dumps({"voices": args.voices, "dtype": args.dtype,
                      "k": args.k, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
