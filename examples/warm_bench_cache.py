"""Pre-warm bench.py's .bench_cache on CPU (no device needed).

The bench's host-side prep — IR spectra FFTs and the engine bank packs —
is content-addressed into `.bench_cache` (utils/diskcache.py). When that
directory is lost (fresh box), the first bench run re-pays minutes of
1-core numpy inside its watchdog budget. This script replays every leg's
prep with the exact same parameters so the cache keys match, entirely on
the CPU backend (no device is touched).

Run:  PYTHONPATH=. python examples/warm_bench_cache.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402,F401

import bench as bench_mod  # noqa: E402


def log(msg: str) -> None:
    print(f"[warm +{time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


T0 = time.perf_counter()


def main() -> int:
    cache = os.path.join(os.path.dirname(os.path.abspath(bench_mod.__file__)),
                         ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    sr, block, ir_seconds = 44100, 256, 4.0

    from tpu_audio.engine.cascade import CascadeConvolution
    from tpu_audio.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio.models.reverb import ConvolutionReverb, _fit_cascade_ratio

    # ---- main fmajor leg: 64v x 4 IRs ----------------------------------
    bank4 = bench_mod.make_bank(4, ir_seconds, sr)
    partitions = bank4.max_partitions(block)
    spectra4 = bank4.cached_partitioned_spectra(block, cache)
    eng = FMajorPartitionedConvolution(
        64, block, partitions, max_predelay=8192, backend="auto",
        mac_dtype="f32", mac_strategy="allk", num_irs=4, pv_mac="dot")
    eng.prepare_bank(spectra4, cache_dir=cache)
    log("fmajor 64v/4IR pack warmed")

    # ---- cascade_hv + cascade_2048 legs: 4-IR cascade packs ------------
    # (the cascade pack key depends on pp1/pp2/spec shapes, not voices or
    # dtype, so one pack per distinct ratio covers every voice count)
    ratios = sorted({_fit_cascade_ratio(16, v, partitions)
                     for v in (1024, 1536, 2048, 2560)})
    for ratio in ratios:
        ceng = CascadeConvolution(
            ratio * 64, block, partitions, ratio=ratio, max_predelay=8192,
            num_irs=4, mac_dtype="f32")
        ceng.prepare_bank(bank4, cache_dir=cache)
        log(f"cascade 4-IR pack warmed (ratio {ratio})")

    # ---- ws leg: 152-IR working set, capacity 16 ------------------------
    bank152 = bench_mod.make_bank(152, ir_seconds, sr)
    log("152-IR bank loaded")
    ConvolutionReverb(
        bank152, num_voices=64, block=block, engine="fmajor",
        max_predelay=8192, bank_capacity=16, cache_dir=cache,
        fault_upload="dual")
    log("ws 152-IR/cap16 spectra + resident pack warmed")

    # ---- sel152 leg: cascade 'selected', fully-resident 152-IR bank ----
    ratio = _fit_cascade_ratio(16, 64, partitions)
    seng = CascadeConvolution(
        64, block, partitions, ratio=ratio, max_predelay=8192,
        num_irs=152, mac_dtype="f32", mac_strategy="selected")
    seng.prepare_bank(bank152, cache_dir=cache)
    log("sel152 cascade pack warmed")

    total = sum(os.path.getsize(os.path.join(cache, f))
                for f in os.listdir(cache)
                if os.path.isfile(os.path.join(cache, f)))
    log(f"done — cache {total / 1e9:.2f} GB in {cache}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
