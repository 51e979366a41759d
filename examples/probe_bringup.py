"""Bring-up measurements on the GPU: the numbers each kernel decision in
PERF.md rests on. One section per run, so one failure costs one section:

    python examples/probe_bringup.py fft       # backend x size, isolated:
                                               # time + error vs float64
    python examples/probe_bringup.py gates     # golden + bounce-vs-stream
                                               # error per precision choice
    python examples/probe_bringup.py cost      # steady step per precision
    python examples/probe_bringup.py fftab     # steady step per FFT backend
    python examples/probe_bringup.py tailmac   # cascade tail_mac reduce/dot
    python examples/probe_bringup.py scaling   # fmajor steady ms vs voices
    python examples/probe_bringup.py trace     # device-plane breakdown of
                                               # the fmajor and cascade steps

Run gates and cost first: the later sections use the cheapest precision
choice that passed every gate (``chosen()``, read back from their JSON).
Each section prints JSON lines and writes chiprun_out/bringup/<section>.json
with the device kind and nvidia-smi's name and power limit. Step timings
are chained-dispatch device time per block (benchlib.measure.
engine_true_ms); A/B variants are built first and then timed in
interleaved rounds inside one process, so they share one card state.
``--tiny`` rehearses the control flow on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "bringup")

# --tiny: voice counts / TINY, short IRs
TINY = 1
IR_S = 4.0
FFT_ALL = {512: "fft", 8192: "fft", 131072: "fft"}


def card() -> dict:
    import jax

    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "not available"
    return {"platform": d.platform, "kind": d.device_kind, "smi": smi}


def prec(name: str):
    """A precision by name: a lax.Precision member or a DotAlgorithmPreset."""
    import jax

    if hasattr(jax.lax.Precision, name):
        return getattr(jax.lax.Precision, name)
    return getattr(jax.lax.DotAlgorithmPreset, name)


def set_precision(mac=None, mix=None, dry=None, ref=None, fft_mm=None):
    """Patch the module-level precision constants by name (read at trace
    time and at engine construction)."""
    from tpu_audio.engine import cascade, fmajor, monolithic, partitioned
    from tpu_audio.ops import fft, mix as mixmod

    if mac is not None:
        fmajor.MAC_PRECISION = cascade.MAC_PRECISION = prec(mac)
    if mix is not None:
        fmajor.MIX_PRECISION = cascade.MIX_PRECISION = prec(mix)
    if dry is not None:
        mixmod.DRY_PRECISION = prec(dry)
    if ref is not None:
        monolithic.MAC_PRECISION = partitioned.MAC_PRECISION = prec(ref)
    if fft_mm is not None:
        fft.MATMUL_PRECISION = prec(fft_mm)


def with_backends(table):
    from tpu_audio.ops import fft
    fft.AUTO_BACKENDS = dict(table)


def read_section(name):
    path = os.path.join(OUT, f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


# precision choices the gates and the cost section compare, cheapest first
CHOICES = {
    "mac=HIGH mix=HIGHEST": dict(mac="HIGH", mix="HIGHEST", dry="HIGHEST"),
    "mac=BF16_X3 mix=HIGHEST": dict(mac="BF16_BF16_F32_X3", mix="HIGHEST",
                                    dry="HIGHEST"),
    "mac=HIGHEST mix=HIGHEST": dict(mac="HIGHEST", mix="HIGHEST",
                                    dry="HIGHEST"),
}
# diagnostics only: which of the small contractions the gates need exact
DIAGNOSTIC = {
    "mac=HIGHEST mix=HIGH dry=HIGH": dict(mac="HIGHEST", mix="HIGH",
                                          dry="HIGH"),
    "mac=HIGHEST mix=HIGHEST dry=HIGH": dict(mac="HIGHEST", mix="HIGHEST",
                                             dry="HIGH"),
}


def chosen() -> tuple[str, dict]:
    """The cheapest CHOICES entry that passed every gate (cost section's
    fmajor64 + cascade1024 sum), else all-HIGHEST."""
    gates = read_section("gates") or {"rows": []}
    passed = {r["choice"] for r in gates["rows"]
              if r.get("kind") == "engines" and r.get("pass")}
    cost = read_section("cost") or {"rows": []}
    total = {}
    for r in cost["rows"]:
        if "choice" in r and "steady_ms" in r:
            total[r["choice"]] = total.get(r["choice"], 0.0) + r["steady_ms"]
    ok = [c for c in CHOICES if c in passed]
    if not ok:
        return "mac=HIGHEST mix=HIGHEST", CHOICES["mac=HIGHEST mix=HIGHEST"]
    best = min(ok, key=lambda c: total.get(c, float("inf")))
    return best, CHOICES[best]


# -- builders -------------------------------------------------------------------


def _inputs(voices, seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((voices, 2, 256))
                        .astype(np.float32) * 0.05) for _ in range(4)]


def _params(voices):
    import jax
    import jax.numpy as jnp

    from tpu_audio.engine import ControlPlane

    control = ControlPlane(voices, 4)
    control.wet[:] = 0.7
    control.predelay[:] = 1024
    return jax.tree.map(jnp.asarray, control.snapshot())


def build_fmajor(voices, table=FFT_ALL):
    import jax

    from benchlib import measure
    from tpu_audio.engine import device_prep
    from tpu_audio.engine.fmajor import FMajorPartitionedConvolution

    with_backends(table)
    voices = max(voices // TINY, 2)
    bank = measure.make_bank(4, IR_S, 44100)
    eng = FMajorPartitionedConvolution(
        voices, 256, bank.max_partitions(256), max_predelay=8192, num_irs=4)
    spectra = device_prep.prepare_fmajor_bank_device(eng, bank)
    params = _params(voices)
    return dict(eng=eng, bank=spectra, params=params,
                state=eng.init_converged(spectra, params),
                pool=_inputs(voices, 1),
                step=jax.jit(eng.step_coef_steady, donate_argnums=(0,)))


def build_cascade(voices, table=FFT_ALL, tail_mac="auto"):
    import jax

    from benchlib import measure
    from tpu_audio.engine import device_prep
    from tpu_audio.engine.cascade import CascadeConvolution

    with_backends(table)
    voices = max(voices // TINY, 16)
    bank = measure.make_bank(4, IR_S, 44100)
    eng = CascadeConvolution(voices, 256, bank.max_partitions(256),
                             ratio=16, max_predelay=8192, num_irs=4,
                             tail_mac=tail_mac)
    spectra = device_prep.prepare_cascade_bank_device(eng, bank)
    params = _params(voices)
    return dict(eng=eng, bank=spectra, params=params,
                state=eng.init_converged(spectra, params),
                pool=_inputs(voices, 2),
                step=jax.jit(eng.step_coef_steady, donate_argnums=(0,)))


def build_mono(table=FFT_ALL):
    import jax

    from benchlib import measure
    from tpu_audio.engine.monolithic import MonolithicConvolution
    from tpu_audio.utils.transfer import device_put_maybe_complex

    with_backends(table)
    n = 131072 // TINY
    bank = measure.make_bank(2, n / 44100, 44100)
    eng = MonolithicConvolution(1, n, 256, max_predelay=8192 // TINY)
    spectra = device_put_maybe_complex(bank.monolithic_spectra(n,
                                                               reserve=1024))
    params = _params(1)
    return dict(eng=eng, bank=spectra, params=params,
                state=eng.init_converged(spectra, params),
                pool=_inputs(1, 3),
                step=jax.jit(getattr(eng, "step_coef_steady", eng.step),
                             donate_argnums=(0,)))


def warm(v, blocks=100, reps=3):
    """Compile + first timing of a built variant (under the precision and
    backend table in force now); keeps the returned state."""
    from benchlib import measure

    ms, v["state"] = measure.engine_true_ms(
        v["step"], v["state"], v["bank"], v["params"],
        lambda t: v["pool"][t % 4], blocks, reps=reps, warmup_steps=16)
    return ms


def interleave(variants: dict, rounds=3, blocks=100) -> dict:
    """{label: variant} -> {label: [ms per round]}, rounds interleaved."""
    from benchlib import measure

    out = {k: [] for k in variants}
    for _ in range(rounds):
        for k, v in variants.items():
            ms, v["state"] = measure.engine_true_ms(
                v["step"], v["state"], v["bank"], v["params"],
                lambda t, v=v: v["pool"][t % 4], blocks, reps=2,
                warmup_steps=1)
            out[k].append(round(ms, 4))
    return out


def timed_chain(fn, x, iters=20, reps=3):
    """ms per iteration of x <- fn(x) inside one jit (fori_loop)."""
    import jax

    loop = jax.jit(lambda x: jax.lax.fori_loop(
        0, iters, lambda i, v: fn(v), x))
    jax.block_until_ready(loop(x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def emit(rows, row):
    print(json.dumps(row), flush=True)
    rows.append(row)


# -- sections -----------------------------------------------------------------


def section_fft(args):
    import jax
    import jax.numpy as jnp

    from tpu_audio.ops.fft import SpectralTransform

    cases = [(512, 128), (512, 2048), (8192, 128), (131072, 4)]
    if TINY > 1:
        cases = [(512, 8), (8192, 4), (131072, 1)]
    rows = []
    rng = np.random.default_rng(0)
    for n, batch in cases:
        x = rng.standard_normal((batch, n)).astype(np.float32)
        want = np.fft.rfft(x.astype(np.float64), axis=-1)
        for backend in ("fft", "matmul", "split"):
            if backend == "matmul" and n > 8192:
                continue   # [n, n/2+1] twiddles: 34 GB at 131072
            for p in ("HIGH", "BF16_BF16_F32_X3", "HIGHEST"):
                if backend == "fft" and p != "HIGH":
                    continue
                set_precision(fft_mm=p)
                xf = SpectralTransform(n, backend=backend)
                xd = jnp.asarray(x)
                spec = jax.jit(xf.rfft)(xd)
                back = jax.jit(xf.irfft)(spec)
                scale = np.abs(want).max()
                fwd_err = float(np.abs(np.asarray(spec) - want).max() / scale)
                inv_err = float(np.abs(np.asarray(back) - x).max()
                                / np.abs(x).max())
                fwd_ms = timed_chain(
                    lambda v: v + jnp.real(xf.rfft(v))[..., :1] * 0.0, xd)
                rt_ms = timed_chain(lambda v: xf.irfft(xf.rfft(v)), xd)
                emit(rows, {"n": n, "batch": batch, "backend": backend,
                            "precision": p if backend != "fft" else "-",
                            "fwd_rel_err": fwd_err,
                            "roundtrip_rel_err": inv_err,
                            "fwd_ms": round(fwd_ms, 4),
                            "roundtrip_ms": round(rt_ms, 4)})
    return {"rows": rows}


def _golden_engine(engine, voices, kw, irs, blocks=160, event=40):
    import chip_smoke as cs

    x = (np.random.default_rng(1).standard_normal(
        (2, blocks * 256)) * 0.05).astype(np.float32)
    model = cs.build_model(irs, voices, engine, **kw)
    sample = sorted({0, 1, 5, voices // 2, voices - 1} & set(range(voices)))
    before = {v: cs.voice_params(model.control, v) for v in sample}
    outs, _s, _w = cs.stream(model, x, blocks, event, sample)
    after = {v: cs.voice_params(model.control, v) for v in sample}
    golden = cs.Golden(x, irs, blocks * 256)
    pre = (event - 1) * 256
    e_pre = max(cs.golden_error(outs[v], golden.voice(**before[v]), 0, pre)
                for v in sample)
    row = {"golden_prefix": e_pre}
    if engine in ("fmajor", "cascade"):
        settled = event + cs.crossfade_settle_blocks(8) + (
            34 if engine == "cascade" else 0)
        row["golden_settled"] = max(cs.golden_error(
            outs[v], golden.voice(**after[v]), settled * 256, blocks * 256)
            for v in sample)
    return row


def section_gates(args):
    """Per precision choice: the golden error of fmajor (64 voices) and
    the cascade (1024) streamed through StreamSession against float64, and
    the bench's bounce-vs-stream equivalence leg with its golden
    sub-check. Then the reference engines' golden error per precision."""
    import chip_smoke as cs
    from benchlib import legs

    with_backends(FFT_ALL)
    rows = []
    irs = cs.synth_irs(0, seconds=IR_S)
    for name, choice in {**CHOICES, **DIAGNOSTIC}.items():
        set_precision(**choice)
        row = {"kind": "engines", "choice": name}
        try:
            for engine, voices, kw in (("fmajor", 64, {}),
                                       ("cascade", 1024,
                                        {"cascade_ratio": 16})):
                voices = max(voices // TINY, 16)
                g = _golden_engine(engine, voices, kw, irs)
                row[engine] = g
            ns = argparse.Namespace(num_irs=4, ir_seconds=IR_S,
                                    sample_rate=44100, block=256,
                                    equiv_seconds=5.0 / TINY,
                                    equiv_engines="fmajor,cascade",
                                    watchdog=0)
            eq = legs.run_equiv_leg(ns, 256 / 44100 * 1e3)
            row["equiv"] = eq["engines"]
            goldens = [v for e in ("fmajor", "cascade")
                       for v in row[e].values()]
            row["pass"] = bool(eq["pass"]) and max(goldens) < cs.GOLDEN_TOL
        except Exception as exc:  # noqa: BLE001 - report and go on
            row["error"] = repr(exc)[:300]
            row["pass"] = False
        emit(rows, row)
    # reference engines: monolithic (n = 131072, IR <= 2.95 s) and the
    # complex partitioned engine, prefix golden per precision
    irs_mono = cs.synth_irs(0, seconds=min(IR_S, 2.5))
    for p in ("HIGH", "HIGHEST"):
        set_precision(mac="HIGHEST", mix="HIGHEST", dry="HIGHEST", ref=p)
        for engine, ir_set in (("monolithic", irs_mono),
                               ("partitioned", irs)):
            row = {"kind": "reference", "engine": engine, "ref": p}
            try:
                row.update(_golden_engine(engine, 2, {"bank_prep": "host"},
                                          ir_set, blocks=80, event=60))
            except Exception as exc:  # noqa: BLE001
                row["error"] = repr(exc)[:300]
            emit(rows, row)
    return {"rows": rows}


def section_cost(args):
    """Steady-step cost of each precision choice, interleaved."""
    rows = []
    for label, build, kw in (("fmajor64", build_fmajor, {"voices": 64}),
                             ("cascade1024", build_cascade,
                              {"voices": 1024})):
        variants = {}
        for name, choice in CHOICES.items():
            set_precision(**choice)
            v = build(**kw)
            warm(v, blocks=20, reps=1)
            variants[name] = v
        times = interleave(variants, blocks=100 if label == "fmajor64"
                           else 48)
        for name, ms in times.items():
            emit(rows, {"case": label, "choice": name, "rounds_ms": ms,
                        "steady_ms": min(ms)})
        del variants
    variants = {}
    for p in ("HIGH", "HIGHEST"):
        set_precision(ref=p)
        v = build_mono()
        warm(v, blocks=20, reps=1)
        variants[p] = v
    for p, ms in interleave(variants, blocks=50).items():
        emit(rows, {"case": "mono_ref", "ref": p, "rounds_ms": ms,
                    "steady_ms": min(ms)})
    return {"rows": rows}


def section_fftab(args):
    """The FFT backend per size inside the jitted steady step: 512 in
    fmajor64, 8192 (tail) in cascade1024, 131072 in the monolithic
    reference engine."""
    name, choice = chosen()
    set_precision(**choice)
    rows = [{"choice": name}]
    cases = {
        "fmajor64 n=512": (build_fmajor, {"voices": 64}, 512,
                           ("fft", "matmul", "split"), 100),
        "cascade1024 n=8192": (build_cascade, {"voices": 1024}, 8192,
                               ("fft", "split"), 48),
        "mono_ref n=131072": (build_mono, {}, 131072, ("fft", "split"), 50),
    }
    for label, (build, kw, n, backends, blocks) in cases.items():
        variants = {}
        for b in backends:
            for mm in (("HIGH", "HIGHEST") if b != "fft" else ("-",)):
                if mm != "-":
                    set_precision(fft_mm=mm)
                table = dict(FFT_ALL)
                table[n] = b
                v = build(table=table, **kw)
                warm(v, blocks=20, reps=1)
                variants[f"{b}@{mm}"] = v
        for k, ms in interleave(variants, blocks=blocks).items():
            emit(rows, {"case": label, "backend": k, "rounds_ms": ms,
                        "steady_ms": min(ms)})
        del variants
    return {"rows": rows}


def section_tailmac(args):
    name, choice = chosen()
    set_precision(**choice)
    rows = [{"choice": name}]
    for voices in (256, 512, 1024, 2048):
        variants = {}
        for tm in ("reduce", "dot"):
            v = build_cascade(voices, tail_mac=tm)
            warm(v, blocks=16, reps=1)
            variants[tm] = v
        vg_rows = (max(voices // TINY, 16) // 16) * 2
        for tm, ms in interleave(variants, blocks=48).items():
            emit(rows, {"voices": voices, "vg_rows": vg_rows,
                        "tail_mac": tm, "rounds_ms": ms,
                        "steady_ms": min(ms)})
        del variants
    return {"rows": rows}


def section_scaling(args):
    name, choice = chosen()
    set_precision(**choice)
    rows = [{"choice": name}]
    for v in (64, 256, 1024):
        ms = warm(build_fmajor(v), blocks=60, reps=3)
        emit(rows, {"voices": v, "steady_ms": round(ms, 4)})
    return {"rows": rows}


def _trace_steps(v, n, logdir):
    import jax

    step, state = v["step"], v["state"]
    for t in range(4):
        state, out = step(state, v["bank"], v["params"], v["pool"][t % 4])
    jax.block_until_ready(out)
    with jax.profiler.trace(logdir):
        for t in range(n):
            state, out = step(state, v["bank"], v["params"],
                              v["pool"][t % 4])
        jax.block_until_ready(out)
    v["state"] = state


def _breakdown(logdir, n):
    from tpu_audio.utils import xplane

    path = xplane.newest_trace(logdir)
    out = {"planes": {}}
    for plane, events in xplane.plane_events(path).items():
        if not plane.startswith("/device"):
            continue
        tot = sum(sum(d) for d in events.values()) / 1e9
        top = sorted(((sum(d) / 1e9, len(d), nm)
                      for nm, d in events.items()), reverse=True)[:30]
        low = {nm.lower(): sum(d) / 1e9 for nm, d in events.items()}
        out["planes"][plane] = {
            "total_ms": round(tot, 4),
            "top": [{"name": nm[:160], "count": c, "ms": round(ms, 4)}
                    for ms, c, nm in top],
            "copy_transpose_ms": round(sum(
                ms for nm, ms in low.items()
                if "copy" in nm or "transpose" in nm), 4)}
    out["per_block_stats"] = xplane.per_block_stats(logdir, n)
    return out


def section_trace(args):
    import jax

    name, choice = chosen()
    set_precision(**choice)
    res = {"choice": name}
    n = 20
    for label, build, kw in (("fmajor64", build_fmajor, {"voices": 64}),
                             ("cascade1024", build_cascade,
                              {"voices": 1024})):
        v = build(**kw)
        ms = warm(v, blocks=20, reps=2)
        comp = v["step"].lower(v["state"], v["bank"], v["params"],
                               v["pool"][0]).compile()
        with open(os.path.join(OUT, f"{label}_steady.hlo.txt"), "w") as fh:
            fh.write(comp.as_text())
        logdir = os.path.join(OUT, f"trace_{label}")
        _trace_steps(v, n, logdir)
        res[label] = {"steady_ms": round(ms, 4), "blocks_traced": n,
                      "breakdown": _breakdown(logdir, n),
                      "state_leaf_bytes": {
                          k: int(a.size * a.dtype.itemsize)
                          for k, a in vars(v["state"]).items()
                          if hasattr(a, "dtype")},
                      "memory_analysis": str(comp.memory_analysis())[:600]}
        print(json.dumps({label: res[label]["steady_ms"]}), flush=True)
        del v
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("section", choices=["fft", "gates", "cost", "fftab",
                                        "tailmac", "scaling", "trace"])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal: small voice counts and IRs")
    args = ap.parse_args()
    if args.tiny:
        global TINY, IR_S
        TINY, IR_S = 32, 0.25
    from tpu_audio.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    res = globals()[f"section_{args.section}"](args)
    res.update(section=args.section, device=card(),
               wall_s=round(time.perf_counter() - t0, 1))
    with open(os.path.join(OUT, f"{args.section}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"section": args.section, "wall_s": res["wall_s"],
                      "device": res["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
