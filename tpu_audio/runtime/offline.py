"""Time-parallel offline rendering (bounce) — far-faster-than-real-time.

The streaming runtime (runtime/stream.py) serves blocks sequentially: one
256-frame block per dispatch, real-time factor bounded by per-step latency
(~0.8 ms at 64 voices -> RTF ~7). Offline, the whole input is known up
front, and partitioned overlap-save has FINITE memory: one output block
depends only on the trailing `engine.history_blocks` input blocks (the
frequency delay line + predelay ring span) once crossfades are converged.
That makes the time axis segmentable: split the track into S segments,
map each segment onto a VIRTUAL VOICE of the same engine, prime every
voice's state by streaming the `history_blocks` blocks that precede its
segment (warm-up output discarded), then stream all segments concurrently
— the engine's voice axis, which the framework already scales to ~1000
voices real-time on one chip, becomes the time axis. Total step count
drops from T to warmup + ceil(T/S); the per-step cost grows only at the
measured voice-scaling slope (~4 us/voice), so throughput multiplies by
nearly S.

This is the moral opposite of the reference's design point: its CUDA
engine is a real-time JACK callback and nothing else (src/conv.cu:287 —
offline use means playing the file through JACK at 1x). Here the same
tested engine step serves both: `render_offline(model, x)` is exact
(within MAC reassociation noise, ~1e-6) against block-streaming the same
model, fades excluded by construction — parameters are taken from the
model's control plane as already-converged values, the standard bounce
case.

Automation (``schedule=``): a scripted MIDI timeline bounces offline too,
NOT just static parameters. The host replays the schedule against a
replica of the control plane in float32 — the same arithmetic, in the
same order, as the device's crossfade recursions — producing (a)
regime-compressed per-block parameter timelines the device step gathers
by block index, (b) per-block re-select event tables applied in-graph via
``collapse_pure`` (the production span collapse), and (c) exact
coefficient/span snapshots at every segment's warm-up start. Each virtual
voice therefore enters its segment with bit-faithful fade state and
replays events at the same block boundaries the streaming session would,
so a bounce with automation matches live serving to float precision —
crossfades mid-segment, fades across segment boundaries, and events
landing inside another segment's warm-up window included. The reference
cannot do this at any speed: its engine exists only inside the JACK
callback, so "bounce with automation" means performing the MIDI live at
1x (src/conv.cu:287).

Limits (all checked loudly): automation requires a coef-fade engine —
fmajor with either MAC strategy ('selected' snapshots are still affine
spans of the bank, so the host g tracking covers the materialized base
too) or the 'allk' cascade (whose in-flight tail rescale is itself
approximate under re-interruption; streamed and bounced outputs carry
the same documented semantics) — and a converged starting control plane
(vsteps == 0, the standard bounce entry). All
paths require full-resident banks (no working-set paging: residency
faults are sequential-control-flow by nature) and a single device.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import replace
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from tpu_audio.utils.log import Log
from tpu_audio.utils.wire import encode_pcm16

# voice-scaling model of the f32 fmajor steady step at 4 s IRs, fitted to
# 256 and 1024 voices (0.489 and 1.752 ms) on an NVIDIA H100 80GB HBM3 at
# a 400 W power limit (PERF.md); only used to CHOOSE the auto segment
# count, never for correctness
_STEP_FIXED_MS = 0.068
_STEP_PER_VOICE_MS = 0.00164


def _auto_segments(total_blocks: int, warmup: int, base_voices: int,
                   max_virtual_voices: int) -> int:
    """Segment count minimizing (warmup + T/S) * (c0 + c1*V*S): the
    warm-up overhead (W extra steps) trades against per-step voice cost.
    d/dS = 0 at S* = sqrt(c0*T / (W*c1*V))."""
    s = math.sqrt(_STEP_FIXED_MS * total_blocks
                  / (max(warmup, 1) * _STEP_PER_VOICE_MS
                     * max(base_voices, 1)))
    s = int(round(s))
    return max(1, min(s, max(1, max_virtual_voices // max(base_voices, 1)),
                      total_blocks))


def _check_stereo(samples, num_voices: int) -> tuple[np.ndarray, bool]:
    """Validate bounce input: shared [2, T] stereo (or [T] mono,
    duplicated), or per-voice [V, 2, T] program material — the same
    convention WavSource streams. Returns (x, per_voice)."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = np.stack([x, x])
    if x.ndim == 3:
        if x.shape[:2] != (num_voices, 2):
            raise ValueError(
                f"per-voice samples must be [{num_voices}, 2, T] "
                f"(model voices, stereo), got {x.shape}")
        return x, True
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"samples must be [2, T] stereo, [T] mono, or "
                         f"per-voice [V, 2, T], got {x.shape}")
    return x, False


def _check_full_resident(model) -> None:
    if getattr(model, "working_set", None) is not None:
        raise ValueError(
            "render_offline needs a fully-resident bank: working-set "
            "residency pages IRs on sequential select order, which "
            "time-parallel segments do not have (build the model without "
            "bank_capacity for offline bounces)")


def _detect_input_grid(x: np.ndarray):
    """('pcm16', scale) when every sample of `x` sits exactly on a 16-bit
    integer grid — k/65536 (the reference WAV loader's headroom scaling,
    wav.cu:13), k/32768, or k/32767 (this framework's own pcm16 wire) —
    else ('f32', None). Power-of-two grids round-trip BIT-EXACTLY; the
    32767 grid reproduces the f32 division value exactly (the decoder
    divides rather than multiplying by an inexact reciprocal)."""
    for scale in (65536.0, 32768.0, 32767.0):
        xs = x * np.float32(scale)
        if (xs.min() >= -32768.0 and xs.max() <= 32767.0
                and not np.any(xs != np.round(xs))):
            return "pcm16", scale
    return "f32", None


def _quantize_input(x: np.ndarray, input_wire: str, scale: float):
    if input_wire != "pcm16":
        return x
    return np.clip(np.round(x * np.float32(scale)), -32768, 32767).astype(
        np.int16)


def _input_decoder(input_wire: str, scale):
    """In-graph decode of the uploaded input tensor (identity for f32).
    Divides by the scale (correctly-rounded) rather than multiplying by
    its float reciprocal: exact for power-of-two grids AND equal to the
    host-side f32 `k/scale` for any scale (1/32767 is not representable,
    so a multiply would perturb those samples by ~1 ulp)."""
    if input_wire != "pcm16":
        return lambda a: a
    s = np.float32(scale)
    return lambda a: a.astype(jnp.float32) / s


def render_offline(model, samples, *, segments: int | None = None,
                   include_tail: bool = True,
                   warmup_blocks: int | None = None,
                   max_virtual_voices: int = 512,
                   schedule=None,
                   track_chunk_blocks: int | None = None,
                   mesh=None, wire: str = "f32",
                   bucket_blocks=None, input_wire: str = "f32",
                   input_scale: float | None = None) -> np.ndarray:
    """Render `samples` through `model` (ConvolutionReverb) at the
    control plane's current converged parameters: stereo [2, T] shared
    program material (or mono [T], duplicated like the CLI source), or
    per-voice [V, 2, T] — the same convention WavSource streams.
    Returns per-voice output [V, 2, T_out]
    — the same convention as the streaming sinks; sum over voices for the
    JACK-playback mix. T_out = T plus the reverb tail when `include_tail`
    (the bounce flushes `history_blocks` of ring-out; the streaming CLI
    needs explicit trailing silence for the same effect).

    `segments=None` picks the segment count from the measured
    voice-scaling model; `max_virtual_voices` caps segments*V (HBM: the
    f32 fmajor state is ~3 MB/voice at 4 s IRs — raise it for bf16 or
    short IRs). `warmup_blocks` overrides the priming depth (testing
    hook; the default `engine.history_blocks` is the exactness
    contract). `schedule` (a runtime.stream.MidiSchedule) bounces a
    scripted automation timeline instead of static parameters — see the
    module docstring; fmajor (either strategy) or 'allk' cascade.
    `track_chunk_blocks` bounds device memory for very long tracks
    (hours): the track renders in chunks of that many blocks, each
    re-primed from the trailing input history inside its slice — exact
    by the same history contract as the segments, and composable with
    `schedule=` (the host replay runs once over the global timeline;
    chunks gather it by absolute block index — on the cascade, the
    chunk grid and history prefix are rounded up to the stagger ratio
    so every chunk's absolute phase matches the stream's). `mesh` (a
    jax.sharding.Mesh with a 'voice' axis, parallel.make_mesh) shards
    the virtual voices over devices — the bounce's time axis is
    embarrassingly parallel, so a pod slice multiplies throughput
    (fmajor and cascade engines; raise `max_virtual_voices` to feed all
    chips).
    `wire='pcm16'` fetches the rendered blocks as 16-bit PCM (encoded
    in-graph, decoded on the host — utils.wire, the same format the
    streaming session's pcm16 wire and the reference's proven DAC
    interfaces use): half the device->host bytes, which on a slow host
    link is a solid slice of the bounce wall time; output is
    still f32 [V, 2, T], quantized to 1/32767. `bucket_blocks` rounds
    the padded track length up to a multiple (or picks ~3% granularity
    with 'auto') so nearby track lengths reuse ONE compiled executable
    set — the zero-padded tail costs its fraction in compute but a
    different-length bounce skips the jit trace/load entirely (the
    chunked path is shape-identical by construction and ignores this).
    `input_wire='pcm16'` uploads the program material as int16 (decoded
    in-graph at `input_scale`, default 32767): half the host->device
    bytes on the bounce's dominant critical-path transfer. 'auto'
    detects 16-bit integer grids (including the reference WAV loader's
    k/65536 headroom scaling) and uploads BIT-EXACTLY when one matches,
    falling back to f32 — the CLI default; explicit 'pcm16' quantizes
    arbitrary input to half an LSB."""
    _check_full_resident(model)
    if wire not in ("f32", "pcm16"):
        raise ValueError(f"wire must be 'f32' or 'pcm16', got {wire!r}")
    if input_wire not in ("f32", "pcm16", "auto"):
        raise ValueError(f"input_wire must be 'f32', 'pcm16', or 'auto', "
                         f"got {input_wire!r}")
    _bucket_total(1, bucket_blocks)  # validate even where chunking ignores it
    if input_wire == "auto":
        input_wire, input_scale = _detect_input_grid(
            np.asarray(samples, np.float32))
        if input_wire == "pcm16":
            Log.info("offline", "input sits on a 16-bit grid (1/%g): "
                     "uploading as int16, bit-exact", input_scale)
    elif input_wire == "pcm16" and input_scale is None:
        input_scale = 32767.0
    if mesh is not None and not (
            hasattr(model.engine, "prime_fdl")
            or hasattr(model.engine, "ratio")):
        raise ValueError(
            "mesh-sharded bounce supports fmajor and cascade engines "
            "(voice-DP GSPMD shardings over the virtual-voice axis)")
    if track_chunk_blocks is not None:
        return _render_chunked(
            model, samples, track_chunk_blocks, segments=segments,
            include_tail=include_tail, warmup_blocks=warmup_blocks,
            max_virtual_voices=max_virtual_voices, schedule=schedule,
            mesh=mesh, wire=wire, input_wire=input_wire,
            input_scale=input_scale)
    if schedule is not None:
        return _render_automated(
            model, samples, schedule, segments=segments,
            include_tail=include_tail, warmup_blocks=warmup_blocks,
            max_virtual_voices=max_virtual_voices, mesh=mesh, wire=wire,
            bucket_blocks=bucket_blocks, input_wire=input_wire,
            input_scale=input_scale)
    eng = model.engine
    v, b = eng.num_voices, eng.block

    x, per_voice = _check_stereo(samples, v)
    x = _quantize_input(x, input_wire, input_scale)
    dec = _input_decoder(input_wire, input_scale)
    wkey = (wire, input_wire, input_scale)
    t_samples = x.shape[-1]
    t_blocks = -(-t_samples // b)

    # fast prime: the fdl is parameter-independent, so engines exposing
    # prime_fdl rebuild it from ONE batched rfft + gather instead of
    # streaming pp warm-up blocks per segment — warm-up drops to the wet
    # ring's depth (~36 blocks vs ~730 at 4 s IRs) and the optimal
    # segment count rises accordingly
    fast = hasattr(eng, "prime_fdl")
    warmup = int(warmup_blocks if warmup_blocks is not None
                 else (eng.prime_blocks if fast else eng.history_blocks))
    tail_blocks = eng.history_blocks if include_tail else 0
    total_blocks = _bucket_total(t_blocks + tail_blocks, bucket_blocks)

    # (the cascade's stagger-divisibility invariant holds automatically:
    # num_voices % ratio == 0 is a constructor requirement, so any
    # v * nseg stays divisible)
    if segments is None:
        nseg = min(_auto_segments(total_blocks, warmup, v,
                                  max_virtual_voices), total_blocks)
    else:
        nseg = int(segments)
        if nseg < 1:
            raise ValueError(f"segments must be >= 1, got {segments}")
    nseg = _mesh_round_segments(nseg, v, mesh, int(getattr(eng, "ratio", 1)))
    seg_len = -(-total_blocks // nseg)

    seng = _virtual_engine(eng, v * nseg)
    bank = model.spectra
    shardings = _mesh_shardings(seng, mesh)

    # block tensor [T', 2, B] (shared) or [T', V, 2, B] (per-voice),
    # zero-padded head-to-block and tail-to-segment-grid (the zero tail
    # past T flushes the ring-out). Upload starts HERE — device_put is
    # async, so the tens-of-MB input transfer rides the link while the
    # host below replicates params and dispatches the engine init
    xb = _block_tensor(x, per_voice, nseg * seg_len, b, t_samples)
    xb_dev = jax.device_put(
        xb, shardings[4] if shardings is not None else None)

    # control-plane snapshot, replicated voice-major: virtual voice
    # v*nseg + s carries voice v's parameters over segment s
    host = model.control.snapshot()
    vparams = jax.tree.map(
        lambda a: jnp.asarray(np.repeat(np.asarray(a), nseg, axis=0)), host)

    nt = xb.shape[0]
    # voice-major virtual packing: virtual voice v*nseg + s
    voice_of = np.repeat(np.arange(v, dtype=np.int32), nseg)

    # the step index rides the donated carry as a DEVICE scalar: a per-step
    # host `jnp.int32(i)` upload serializes dispatches on high-RTT
    # transports (one round trip per step; device-chained dispatch
    # pipelines them).
    # The input tensor, bank, and params are EXPLICIT arguments: a device
    # array captured by closure is inlined into the lowered HLO as a
    # constant (a 440 MB bank lowered to an 880 MB program text — and
    # even the 69 MB flagship bank made every compile ~300 MB of HLO)
    def build_step():
        starts = jnp.asarray(np.arange(nseg, dtype=np.int32) * seg_len)
        # converged static params ride the steady hot path on coef
        # engines; materialized/monolithic engines go through their
        # general step (its fade arithmetic is a converged no-op)
        steady = (seng.step_coef_steady
                  if getattr(seng, "variant", None) == "coef" else seng.step)

        def step(carry, xb_a, bank_a, vp_a):
            st, i, ok = carry
            idx = starts + i - warmup                   # [nseg]
            xi = dec(jnp.take(xb_a, jnp.clip(idx, 0, nt - 1), axis=0))
            if per_voice:                               # [nseg, V, 2, B]
                xi = jnp.where((idx >= 0)[:, None, None, None], xi, 0.0)
                xi = jnp.moveaxis(xi, 0, 1).reshape(v * nseg, 2, b)
            else:
                xi = jnp.where((idx >= 0)[:, None, None], xi, 0.0)
                xi = jnp.tile(xi, (v, 1, 1))            # [V*nseg, 2, B]
            st, y = steady(st, bank_a, vp_a, xi)
            # in-graph honesty accumulator on the RAW output (the pcm16
            # encoder clips NaN/Inf into ordinary int16 values, so a
            # wire-side check could never fail): rides the donated carry
            # at scalar cost and makes every wire self-verifying
            ok = ok & jnp.all(jnp.isfinite(y))
            if wire == "pcm16":
                y = encode_pcm16(y)
            return (st, i + 1, ok), y

        if shardings is None:
            return jax.jit(step, donate_argnums=0)
        state_sh, bank_sh, params_sh, x_sh, repl = shardings
        return jax.jit(step, donate_argnums=0,
                       in_shardings=((state_sh, repl, repl), repl, bank_sh,
                                     params_sh),
                       out_shardings=((state_sh, repl, repl), x_sh))

    step = _cached_fn(seng, ("static", per_voice, nseg, seg_len, warmup,
                             nt, mesh, wkey), build_step)
    # cold-start overlap (opt-in): compile step + spec + prime from
    # worker threads while init_converged compiles and runs below (the
    # endpoint takes concurrent compiles at ~4x, probe_compile_parallel)
    if os.environ.get("TPU_AUDIO_OFFLINE_PRECOMPILE") == "1":
        xb_aval, bank_aval, vp_aval = _sds(xb_dev), _sds(bank), _sds(vparams)
        jobs = [("step", step,
                 lambda st: (_carry_aval(st), xb_aval, bank_aval, vp_aval))]
        if fast:
            jobs += _prime_jobs(seng, nt, per_voice, shardings, dec,
                                wkey[1:], xb_aval, v * nseg)
        _precompile_async(seng, bank, vparams, jobs)

    state = seng.init_converged(bank, vparams)
    if shardings is not None:
        state_sh, bank_sh, params_sh, x_sh, repl = shardings
        state = jax.device_put(state, state_sh)
        bank = jax.device_put(bank, bank_sh)
        vparams = jax.device_put(vparams, params_sh)

    if fast:
        t0 = jnp.asarray(np.tile(
            np.arange(nseg, dtype=np.int32) * seg_len - warmup, v))
        state = _prime_fast(seng, state, xb_dev, t0, nt,
                            jnp.asarray(voice_of) if per_voice else None,
                            shardings, dec=dec, dec_key=wkey[1:])

    Log.info("offline", "bounce: %d blocks as %d segment(s) x %d + %d "
             "warm-up steps (%d virtual voices)",
             total_blocks, nseg, seg_len, warmup, v * nseg)

    out = _collect(step, state, warmup, seg_len, (xb_dev, bank, vparams))
    # [seg_len, V*nseg, 2, B] -> [V, 2, nseg*seg_len*B]
    out = (out.reshape(seg_len, v, nseg, 2, b)
              .transpose(1, 3, 2, 0, 4)
              .reshape(v, 2, nseg * seg_len * b))
    out_samples = t_samples + tail_blocks * b if include_tail else t_samples
    return _decode_wire(out[..., :out_samples], wire)


def _bucket_total(total_blocks: int, bucket_blocks) -> int:
    """Round the padded track length up to the bucket grid (see
    render_offline's `bucket_blocks`). 'auto' pads at most ~3%: the grid
    is 2^(bitlen-5), i.e. 1/32 of the track's magnitude."""
    if bucket_blocks is None:
        return total_blocks
    if bucket_blocks == "auto":
        g = max(64, 1 << max(int(total_blocks).bit_length() - 5, 0))
    else:
        g = int(bucket_blocks)
        if g < 1:
            raise ValueError(f"bucket_blocks must be >= 1 or 'auto', "
                             f"got {bucket_blocks}")
    return -(-total_blocks // g) * g


def _decode_wire(out: np.ndarray, wire: str) -> np.ndarray:
    if wire == "pcm16":
        from tpu_audio.utils.wire import decode_pcm16

        return decode_pcm16(out)
    return out


def _render_chunked(model, samples, chunk_blocks: int, *, segments,
                    include_tail, warmup_blocks, max_virtual_voices,
                    schedule, mesh=None, wire: str = "f32",
                    input_wire: str = "f32",
                    input_scale=None) -> np.ndarray:
    """Bounded-memory bounce: render the track in `chunk_blocks`-block
    chunks, each an independent time-parallel render over its slice plus
    `history_blocks` of trailing input prefix (discarded output) — the
    same contract that makes segments exact makes chunks exact. Keeps
    the device footprint at O(chunk) for hour-scale tracks (the whole-
    track path holds input + spectra + output on device, ~5 GB/hour).

    With ``schedule=``, the automation timeline chunks too (every
    automatable engine; cascade chunk grids phase-align to the stagger
    ratio): the host replay runs ONCE over the global timeline and
    each chunk's step gathers parameters/events at absolute block
    indices — see _render_chunked_automated."""
    chunk_blocks = int(chunk_blocks)
    if chunk_blocks < 1:
        raise ValueError(f"track_chunk_blocks must be >= 1, "
                         f"got {chunk_blocks}")
    if schedule is not None:
        return _render_chunked_automated(
            model, samples, chunk_blocks, schedule, segments=segments,
            include_tail=include_tail, warmup_blocks=warmup_blocks,
            max_virtual_voices=max_virtual_voices, mesh=mesh, wire=wire,
            input_wire=input_wire, input_scale=input_scale)
    eng = model.engine
    b = eng.block
    x, _ = _check_stereo(samples, eng.num_voices)
    t_samples = x.shape[-1]
    t_blocks = -(-t_samples // b)
    hist = eng.history_blocks
    # every chunk is SHAPE-IDENTICAL — a constant `hist`-block history
    # prefix (zeros before the track start: the stream-from-silence
    # state) + exactly `chunk_blocks` of payload (zeros past the track
    # end: the tail flush) — so ONE compiled executable set serves any
    # track length; only the host-side slicing varies
    out_blocks = t_blocks + (hist if include_tail else 0)
    span = (hist + chunk_blocks) * b
    outs = []
    for lo in range(0, out_blocks, chunk_blocks):
        xs = np.zeros(x.shape[:-1] + (span,), np.float32)
        src_lo = (lo - hist) * b
        src_hi = min((lo + chunk_blocks) * b, t_samples)
        if src_hi > max(src_lo, 0):
            dst = max(src_lo, 0) - src_lo
            xs[..., dst:dst + (src_hi - max(src_lo, 0))] = \
                x[..., max(src_lo, 0):src_hi]
        out = render_offline(model, xs, segments=segments,
                             include_tail=False,
                             warmup_blocks=warmup_blocks,
                             max_virtual_voices=max_virtual_voices,
                             mesh=mesh, wire=wire, input_wire=input_wire,
                             input_scale=input_scale)
        outs.append(out[..., hist * b:])
    out = np.concatenate(outs, axis=-1)
    return out[..., :t_samples + (hist * b if include_tail else 0)]


def _render_chunked_automated(model, samples, chunk_blocks: int, schedule,
                              *, segments, include_tail, warmup_blocks,
                              max_virtual_voices, mesh=None,
                              wire: str = "f32", input_wire: str = "f32",
                              input_scale=None) -> np.ndarray:
    """Bounded-memory bounce of an automation timeline.

    The control-state replay is global by nature, so the host replays the
    schedule ONCE over the whole (chunk-grid-padded) timeline, taking
    exact fade snapshots at every chunk's segment warm-up starts in
    ABSOLUTE blocks. Each chunk then renders its local span (history
    prefix + payload, the static chunk contract) while gathering
    parameters and re-select events at ``local_block + (chunk_start -
    hist)`` — the offset rides the step as a device scalar, so every
    chunk reuses ONE compiled executable set. Output is equal to the
    whole-track automated bounce within MAC reassociation noise (the
    segment grid differs), which itself matches live streaming to float
    precision.

    The cascade tail's stagger schedule follows the engine's LOCAL block
    counter (group ``t % ratio`` computes its chunk at block ``t``), and
    in-flight fade projections are phase-sensitive — a chunk reproduces
    the stream's absolute phase only when its start offset
    ``lo - hist`` is a multiple of the ratio (the warm-up/seg_len
    alignment INSIDE each chunk comes from ``_plan_automated``, exactly
    like the whole-track bounce whose abs offset is 0). Rounding the
    chunk grid and the history prefix up to the ratio makes every
    offset aligned; a longer prefix is exact by the history contract,
    and the grid rounding only moves chunk boundaries."""
    eng = model.engine
    _check_automatable(eng)
    b = eng.block
    ratio = int(getattr(eng, "ratio", 1))
    if chunk_blocks % ratio:
        chunk_blocks = -(-chunk_blocks // ratio) * ratio
        Log.info("offline", "chunk grid rounded up to %d blocks (cascade "
                 "stagger ratio %d alignment)", chunk_blocks, ratio)
    x, _per_voice = _check_stereo(samples, eng.num_voices)
    t_samples = x.shape[-1]
    t_blocks = -(-t_samples // b)
    tail = eng.history_blocks if include_tail else 0
    hist = -(-eng.history_blocks // ratio) * ratio
    out_blocks = t_blocks + tail
    span_blocks = hist + chunk_blocks
    span = span_blocks * b
    _fast, warmup, nseg, seg_len = _plan_automated(
        eng, span_blocks, segments=segments, warmup_blocks=warmup_blocks,
        max_virtual_voices=max_virtual_voices, mesh=mesh)
    los = list(range(0, out_blocks, chunk_blocks))
    tpad_local = nseg * seg_len
    tpadg = max(los[-1] - hist + tpad_local, tpad_local)
    snap_points = sorted({max(s * seg_len - warmup + lo - hist, 0)
                          for lo in los for s in range(nseg)})
    sim = _ControlSim(model.control, schedule, tpadg, snap_points)
    outs = []
    for lo in los:
        xs = np.zeros(x.shape[:-1] + (span,), np.float32)
        src_lo = (lo - hist) * b
        src_hi = min((lo + chunk_blocks) * b, t_samples)
        if src_hi > max(src_lo, 0):
            dst = max(src_lo, 0) - src_lo
            xs[..., dst:dst + (src_hi - max(src_lo, 0))] = \
                x[..., max(src_lo, 0):src_hi]
        out = _render_automated(
            model, xs, schedule, segments=nseg, include_tail=False,
            warmup_blocks=warmup, max_virtual_voices=max_virtual_voices,
            mesh=mesh, wire=wire, input_wire=input_wire,
            input_scale=input_scale, _chunk_ctx=(sim, lo - hist, tpadg))
        outs.append(out[..., hist * b:])
    out = np.concatenate(outs, axis=-1)
    return out[..., :t_samples + tail * b]


class _ControlSim:
    """Host replay of a MIDI schedule against a control-plane replica.

    Produces, for ``total_blocks`` blocks (padded track + tail):

      - regime-compressed parameter timelines: ``regimes`` (list of field
        dicts, row 0 = the PRE-schedule initial plane, one more row per
        event block), ``regime_starts`` (the block each regime began —
        vsteps decays linearly from there), ``regime_of_block`` [T] i32;
      - re-select event tables: ``ev_changed``/``ev_old`` (row 0 = the
        no-event sentinel) and ``event_of_block`` [T] i32, applied
        in-graph via the engine's ``collapse_pure``;
      - ``snaps[block] = (coef_a, coef_c, base_g, select)`` — the exact
        f32 fade state (and clipped selection) ENTERING ``block``
        (pre-event), at every requested segment warm-up start.

    The coefficient recursion is the device's, op for op in float32
    (a *= 1-r; c = c*(1-r) + wet*r with r = 1/(vsteps+5), vsteps
    decremented per block — engine/fmajor.py step_coef), and the span
    collapse is collapse_pure's (g := a*g + c*onehot(old); a=1; c=0) —
    so a segment primed from a snapshot continues the recursion with the
    identical values the streaming session's state would hold. (XLA may
    fuse the c update into an FMA, a sub-ulp reassociation within the
    renderer's float-precision contract, not bit-exactness.)
    """

    FIELDS = ("select", "predelay", "vsteps", "dry", "wet",
              "pan_dry", "pan_wet", "level")

    def __init__(self, control, schedule, total_blocks: int,
                 snap_blocks) -> None:
        from tpu_audio.engine.params import ControlPlane

        v = control.num_voices
        k = max(control.bank_size, 1)
        clone = ControlPlane(v, control.bank_size, control.max_predelay)
        for name in ("select_base", "select_span", "select", "predelay",
                     "vsteps", "speed", "dry", "wet", "pan_dry", "pan_wet",
                     "level"):
            getattr(clone, name)[:] = getattr(control, name)
        clone.mappings = dict(control.mappings)
        if clone.vsteps.any():
            raise ValueError(
                "automated bounce requires a converged starting control "
                "plane (vsteps == 0 everywhere): finish in-flight fades in "
                "the streaming session, or start the schedule from rest")
        pending: dict = {}
        clone.on_select_change = (
            lambda vo, ch, old, new: pending.setdefault((vo, ch), old))

        a = np.zeros((v, 2), np.float32)
        c = clone.wet.astype(np.float32).copy()
        g = np.zeros((v, 2, k), np.float32)
        one = np.float32(1.0)
        five = np.float32(5.0)

        want = set(int(s) for s in snap_blocks)
        self.snaps: dict[int, tuple] = {}

        def regime_row():
            return {
                "select": np.clip(clone.select, 0, k - 1).astype(np.int32),
                "predelay": clone.predelay.astype(np.int32).copy(),
                "vsteps": clone.vsteps.astype(np.int32).copy(),
                "dry": clone.dry.copy(), "wet": clone.wet.copy(),
                "pan_dry": clone.pan_dry.copy(),
                "pan_wet": clone.pan_wet.copy(),
                "level": clone.level.copy(),
            }

        self.regimes = [regime_row()]
        self.regime_starts = [0]
        self.regime_of_block = np.zeros(total_blocks, np.int32)
        self.ev_changed = [np.zeros((v, 2), bool)]
        self.ev_old = [np.zeros((v, 2), np.int32)]
        self.event_of_block = np.zeros(total_blocks, np.int32)

        schedule.rewind_to(0)
        for t in range(total_blocks):
            if t in want:
                self.snaps[t] = (a.copy(), c.copy(), g.copy(),
                                 np.clip(clone.select, 0, k - 1
                                         ).astype(np.int32))
            due = schedule.pop_due(t)
            if due:
                for device, message in due:
                    clone.apply_midi_message(message, device)
                if pending:
                    changed = np.zeros((v, 2), bool)
                    old_sel = np.zeros((v, 2), np.int32)
                    for (vo, ch), old in pending.items():
                        changed[vo, ch] = True
                        old_sel[vo, ch] = old
                    pending.clear()
                    # collapse_pure's span re-base (one_hot of an
                    # out-of-range old yields the zero row)
                    oh = np.zeros((v, 2, k), np.float32)
                    inr = (old_sel >= 0) & (old_sel < k)
                    np.put_along_axis(oh, np.clip(old_sel, 0, k - 1)[..., None],
                                      1.0, axis=2)
                    oh *= inr[..., None]
                    gnew = a[..., None] * g + c[..., None] * oh
                    g = np.where(changed[..., None], gnew, g)
                    a = np.where(changed, one, a).astype(np.float32)
                    c = np.where(changed, np.float32(0.0), c).astype(np.float32)
                    self.ev_changed.append(changed)
                    self.ev_old.append(old_sel)
                    self.event_of_block[t] = len(self.ev_changed) - 1
                self.regimes.append(regime_row())
                self.regime_starts.append(t)
            self.regime_of_block[t] = len(self.regimes) - 1
            r = one / (clone.vsteps.astype(np.float32) + five)
            a = (a * (one - r)).astype(np.float32)
            c = (c * (one - r) + clone.wet * r).astype(np.float32)
            np.maximum(clone.vsteps - 1, 0, out=clone.vsteps)
        late = schedule.pop_due(1 << 62)
        if late:
            Log.warn("offline", "%d scheduled MIDI event(s) fall past the "
                     "bounce's %d blocks (ignored)", len(late), total_blocks)


def _check_automatable(eng) -> bool:
    """Validate the engine supports in-graph automation replay; returns
    the 'selected'-strategy flag."""
    strategy = getattr(eng, "mac_strategy", None)
    selected = (strategy == "selected" and hasattr(eng, "_span_expand")
                and hasattr(eng, "_gather_selection"))
    if not (selected or (strategy == "allk"
                         and hasattr(eng, "collapse_pure")
                         and hasattr(eng, "step_coef_indexed"))):
        raise ValueError(
            "automated bounce requires a coef-fade engine: fmajor (either "
            "MAC strategy) or the 'allk' cascade — re-selects and "
            "crossfades replay in-graph via collapse(_pure) (the cascade's "
            "'selected' strategy has no span-expansion for the snapshot "
            "init; bounce large banks with the fmajor engine)")
    return selected


def _plan_automated(eng, total_blocks: int, *, segments, warmup_blocks,
                    max_virtual_voices, mesh):
    """Segment plan for an automated bounce: (fast, warmup, nseg, seg_len).

    The cascade's tail schedule is staggered (group g computes at blocks
    t % ratio == g): a virtual voice's LOCAL block counter starts at 0,
    so its stagger phase matches the stream's absolute phase only when
    every segment's warm-up start falls on a ratio boundary — hence the
    ratio-rounding of warmup and seg_len. Converged params are
    phase-invariant (the static path needs no alignment), but an event's
    fade scattering is not."""
    fast = hasattr(eng, "prime_fdl")
    warmup = int(warmup_blocks if warmup_blocks is not None
                 else (eng.prime_blocks if fast else eng.history_blocks))
    ratio = int(getattr(eng, "ratio", 1))
    warmup = -(-warmup // ratio) * ratio
    v = eng.num_voices
    if segments is None:
        nseg = min(_auto_segments(total_blocks, warmup, v,
                                  max_virtual_voices), total_blocks)
    else:
        nseg = int(segments)
        if nseg < 1:
            raise ValueError(f"segments must be >= 1, got {segments}")
    nseg = _mesh_round_segments(nseg, v, mesh, ratio)
    seg_len = -(-(-(-total_blocks // nseg)) // ratio) * ratio
    return fast, warmup, nseg, seg_len


def _render_automated(model, samples, schedule, *, segments,
                      include_tail, warmup_blocks, max_virtual_voices,
                      mesh=None, wire: str = "f32",
                      bucket_blocks=None, input_wire: str = "f32",
                      input_scale=None, _chunk_ctx=None) -> np.ndarray:
    """Time-parallel bounce of a scripted MIDI timeline — render_offline
    with ``schedule=`` (see the module docstring for the replay design).

    ``_chunk_ctx = (sim, abs_base, tpad_global)`` is the chunked driver's
    private seam (_render_chunked_automated): the host replay was built
    ONCE over the global timeline, this call renders the chunk's local
    span, and every parameter/event gather happens at the ABSOLUTE block
    index ``local + abs_base`` (a device scalar argument, so all chunks
    share one executable)."""
    from tpu_audio.engine.params import VoiceParams

    eng = model.engine
    selected = _check_automatable(eng)
    v, b = eng.num_voices, eng.block
    x, per_voice = _check_stereo(samples, v)
    x = _quantize_input(x, input_wire, input_scale)
    dec = _input_decoder(input_wire, input_scale)
    wkey = (wire, input_wire, input_scale)
    t_samples = x.shape[-1]
    t_blocks = -(-t_samples // b)
    if _chunk_ctx is None:
        tail_blocks = eng.history_blocks if include_tail else 0
        total_blocks = _bucket_total(t_blocks + tail_blocks, bucket_blocks)
    else:
        sim, abs_base, tpadg = _chunk_ctx
        tail_blocks = 0
        total_blocks = t_blocks
    fast, warmup, nseg, seg_len = _plan_automated(
        eng, total_blocks, segments=segments, warmup_blocks=warmup_blocks,
        max_virtual_voices=max_virtual_voices, mesh=mesh)
    tpad = nseg * seg_len

    seng = _virtual_engine(eng, v * nseg)
    bank = model.spectra
    shardings = _mesh_shardings(seng, mesh)

    # upload starts before the host's schedule replay below (device_put
    # is async): the input transfer and the O(T) float32 control-plane
    # replay ride the link and the CPU concurrently
    xb = _block_tensor(x, per_voice, tpad, b, t_samples)
    xb_dev = jax.device_put(
        xb, shardings[4] if shardings is not None else None)

    if _chunk_ctx is None:
        abs_base, tpadg = 0, tpad
        sim = _ControlSim(model.control, schedule, tpad,
                          [max(s * seg_len - warmup, 0) for s in range(nseg)])

    def vm(arr: np.ndarray) -> np.ndarray:
        """[nseg, V, 2, ...] -> SEGMENT-major [nseg*V, 2, ...]: virtual
        voice s*V + v carries voice v over segment s. Segment-major (not
        the static path's voice-major) keeps each virtual voice's cascade
        stagger group, j % ratio == v % ratio (V is ratio-divisible by
        constructor invariant) — with the ratio-aligned warm-up starts,
        every virtual voice then computes its tail at the same absolute
        block phases as the stream, which the in-flight fade projections
        and rescale are sensitive to (converged params are not)."""
        return np.ascontiguousarray(arr).reshape(
            (nseg * v,) + arr.shape[2:])

    host0 = model.control.snapshot()
    p0 = jax.tree.map(
        lambda t: jnp.asarray(np.tile(
            np.asarray(t), (nseg,) + (1,) * (np.asarray(t).ndim - 1))),
        host0)

    # schedule tables BEFORE the engine init: pure host work whose shapes
    # the (opt-in) background step precompile needs — see the static path
    reg_tbl = {f: jnp.asarray(np.stack([r[f] for r in sim.regimes]))
               for f in _ControlSim.FIELDS}
    reg_start = jnp.asarray(np.asarray(sim.regime_starts, np.int32))
    reg_of_block = jnp.asarray(sim.regime_of_block)
    ev_changed = jnp.asarray(np.stack(sim.ev_changed))
    ev_old = jnp.asarray(np.stack(sim.ev_old))
    ev_of_block = jnp.asarray(sim.event_of_block)

    starts = jnp.asarray(np.arange(nseg, dtype=np.int32) * seg_len)
    takes_params = getattr(seng, "collapse_pure_takes_params", False)

    # input, bank, AND the schedule tables ride as explicit jit arguments
    # (a closure-captured device array inlines into the lowered HLO as a
    # constant — the 152-IR selected bank produced an 880 MB program
    # text); passing the
    # tables as args also makes the cached executable schedule-agnostic
    # (same table shapes -> zero recompiles across bounces)
    def build_step():
        def step(carry, xb_a, bank_a, tbl_a, off_a):
            rtbl, rstart, rof, evc, evo, evof = tbl_a
            st, i, ok = carry
            idx = starts + i - warmup                      # [nseg], local
            idxc = jnp.clip(idx, 0, tpad - 1)
            live_in = idx >= 0                  # input exists in THIS tensor
            aidx = idx + off_a                  # absolute timeline block
            aidxc = jnp.clip(aidx, 0, tpadg - 1)
            live = aidx >= 0                    # params/events pre-roll gate
            xi = dec(jnp.take(xb_a, idxc, axis=0))
            if per_voice:                                  # [nseg, V, 2, B]
                xi = jnp.where(live_in[:, None, None, None], xi, 0.0)
                xi = xi.reshape(nseg * v, 2, b)            # segment-major
            else:
                xi = jnp.where(live_in[:, None, None], xi, 0.0)
                xi = jnp.repeat(xi, v, axis=0)             # [Vv, 2, B]

            # pre-roll steps (absolute index < 0: a segment start earlier
            # than one warm-up window before the track) read regime row 0
            # — the initial plane, whose converged coefficients make the
            # recursion a no-op before block 0
            reg = jnp.where(live, jnp.take(rof, aidxc), 0)

            def vmj(tbl, sel):
                gath = jnp.take(tbl, sel, axis=0)          # [nseg, V, 2, ..]
                return gath.reshape((nseg * v,) + gath.shape[2:])

            offs = jnp.where(live, aidx - jnp.take(rstart, reg), 0)
            offs_vv = jnp.repeat(offs, v)[:, None]         # [Vv, 1]
            params = VoiceParams(
                select=vmj(rtbl["select"], reg),
                predelay=vmj(rtbl["predelay"], reg),
                vsteps=jnp.maximum(vmj(rtbl["vsteps"], reg) - offs_vv, 0),
                dry=vmj(rtbl["dry"], reg), wet=vmj(rtbl["wet"], reg),
                pan_dry=vmj(rtbl["pan_dry"], reg),
                pan_wet=vmj(rtbl["pan_wet"], reg),
                level=vmj(rtbl["level"], reg))

            ev = jnp.where(live, jnp.take(evof, aidxc), 0)
            live_vv = jnp.repeat(live, v)[:, None]
            chg = vmj(evc, ev) & live_vv
            old = vmj(evo, ev)
            if selected:
                # the materializing collapse gathers bank spectra — gate
                # it on "this block re-selects" exactly like the stream
                # does (the all-False where() form would still pay the
                # full gather)
                st = jax.lax.cond(
                    jnp.any(chg),
                    lambda s, bk: seng.collapse(s, bk, old, chg,
                                                new_select=params.select),
                    lambda s, bk: s, st, bank_a)
                st, y = seng.step_coef(st, bank_a, params, xi)
            else:
                extra = (params,) if takes_params else ()
                st = seng.collapse_pure(st, old, chg, *extra)
                st, y = seng.step_coef_indexed(st, bank_a, params, xi)
            # in-graph honesty accumulator on the RAW output (see the
            # static path's note: pcm16 clips NaN into valid samples)
            ok = ok & jnp.all(jnp.isfinite(y))
            if wire == "pcm16":
                y = encode_pcm16(y)
            return (st, i + 1, ok), y

        if shardings is None:
            return jax.jit(step, donate_argnums=0)
        state_sh, bank_sh, _p, x_sh, repl = shardings
        tbl_sh = jax.tree.map(lambda _: repl, tables)
        return jax.jit(step, donate_argnums=0,
                       in_shardings=((state_sh, repl, repl), repl, bank_sh,
                                     tbl_sh, repl),
                       out_shardings=((state_sh, repl, repl), x_sh))

    tables = (reg_tbl, reg_start, reg_of_block,
              ev_changed, ev_old, ev_of_block)
    step = _cached_fn(seng, ("auto", selected, takes_params, per_voice,
                             nseg, seg_len, warmup, tpad, tpadg, mesh,
                             wkey), build_step)
    off_dev = jnp.asarray(abs_base, jnp.int32)
    # cold-start overlap (opt-in): compile step + spec + prime from
    # worker threads while init_converged / selected-init / prime run
    if os.environ.get("TPU_AUDIO_OFFLINE_PRECOMPILE") == "1":
        xb_aval = _sds(xb_dev)
        jobs = [("step", step,
                 lambda st: (_carry_aval(st), xb_aval, _sds(bank),
                             _sds(tables), _sds(off_dev)))]
        if fast:
            jobs += _prime_jobs(seng, tpad, per_voice, shardings, dec,
                                wkey[1:], xb_aval, v * nseg)
        _precompile_async(seng, bank, p0, jobs)

    state = seng.init_converged(bank, p0)
    snaps = [sim.snaps[max(s * seg_len - warmup + abs_base, 0)]
             for s in range(nseg)]
    g0 = vm(np.stack([s[2] for s in snaps]))
    state = replace(
        state,
        coef_a=jnp.asarray(vm(np.stack([s[0] for s in snaps]))),
        coef_c=jnp.asarray(vm(np.stack([s[1] for s in snaps]))))
    if selected:
        # the 'selected' strategy reads MATERIALIZED per-voice tensors:
        # the snapshot is still an affine span of the bank (the stream's
        # collapse is base := a*base + c*bank[old], the same recursion the
        # host g tracks), so expand g once at init and gather the
        # pre-event selection
        sel0 = jnp.asarray(vm(np.stack([s[3] for s in snaps])))
        selinit = _cached_fn(seng, ("selinit", state.base.dtype),
                             lambda: jax.jit(lambda bk, gg, ss: (
                                 seng._span_expand(bk, gg)
                                 .astype(state.base.dtype),
                                 seng._gather_selection(bk, ss))))
        base0, selsp = selinit(bank, jnp.asarray(g0), sel0)
        state = replace(state, base=base0, sel_spectra=selsp,
                        base_pure=jnp.zeros((v * nseg, 2), bool))
    else:
        if g0.shape[-1] != state.base_g.shape[-1]:
            raise ValueError(
                f"span width mismatch: control plane tracks {g0.shape[-1]} "
                f"IRs, engine state carries {state.base_g.shape[-1]}")
        state = replace(state, base_g=jnp.asarray(g0),
                        base_pure=jnp.ones((v * nseg, 2), bool))
    if shardings is not None:
        state_sh, bank_sh, _params_sh, x_sh, repl = shardings
        state = jax.device_put(state, state_sh)
        bank = jax.device_put(bank, bank_sh)

    if fast:
        # segment-major virtual packing: t0[s*V + v]
        t0 = jnp.asarray(np.repeat(
            np.arange(nseg, dtype=np.int32) * seg_len - warmup, v))
        vof = (jnp.asarray(np.tile(np.arange(v, dtype=np.int32), nseg))
               if per_voice else None)
        state = _prime_fast(seng, state, xb_dev, t0, tpad, vof, shardings,
                            dec=dec, dec_key=wkey[1:])

    Log.info("offline", "automated bounce: %d blocks as %d segment(s) x %d "
             "+ %d warm-up steps (%d virtual voices, %d regime(s), %d "
             "re-select block(s))", total_blocks, nseg, seg_len, warmup,
             v * nseg, len(sim.regimes), len(sim.ev_changed) - 1)

    out = _collect(step, state, warmup, seg_len,
                   (xb_dev, bank, tables, off_dev))
    # [seg_len, nseg*V, 2, B] (segment-major) -> [V, 2, tpad*B]
    out = (out.reshape(seg_len, nseg, v, 2, b)
              .transpose(2, 3, 1, 0, 4)
              .reshape(v, 2, tpad * b))
    out_samples = t_samples + tail_blocks * b if include_tail else t_samples
    return _decode_wire(out[..., :out_samples], wire)


def _block_tensor(x: np.ndarray, per_voice: bool, t_pad_blocks: int,
                  b: int, t_samples: int) -> np.ndarray:
    """Zero-padded block tensor: [T', 2, B] for shared program material,
    [T', V, 2, B] for per-voice [V, 2, T] input. Keeps x's dtype (int16
    under the pcm16 input wire; zero pad is exact in any grid)."""
    if per_voice:
        v = x.shape[0]
        flat = np.zeros((v, 2, t_pad_blocks * b), x.dtype)
        flat[..., :t_samples] = x
        return np.ascontiguousarray(
            flat.reshape(v, 2, t_pad_blocks, b).transpose(2, 0, 1, 3))
    flat = np.zeros((2, t_pad_blocks * b), x.dtype)
    flat[:, :t_samples] = x
    return np.ascontiguousarray(
        flat.reshape(2, t_pad_blocks, b).transpose(1, 0, 2))


def _mesh_round_segments(nseg: int, v: int, mesh, ratio: int = 1) -> int:
    """Round the segment count up so the sharded axis divides evenly over
    the mesh 'voice' axis: v*nseg virtual voices for fmajor, and
    v*nseg/ratio group-major rows (Vg) for the cascade — Vg divisible by
    the mesh also makes every shard's voice count a whole number of
    stagger groups."""
    if mesh is None:
        return nseg
    voice_n = int(mesh.shape["voice"])
    w = v // ratio
    need = voice_n // math.gcd(w, voice_n)
    return -(-nseg // need) * need


def _mesh_shardings(seng, mesh):
    """(state, bank, params, x, replicated) NamedShardings for a
    mesh-sharded bounce (voice-DP over the virtual-voice axis), or None
    for the single-device path. fmajor engines shard via
    `fmajor_shardings`; the cascade via `cascade_shardings` (the group
    axis replicates, Vg shards — whole stagger groups per device)."""
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec

    from tpu_audio.parallel.mesh import cascade_shardings, fmajor_shardings

    if hasattr(seng, "prime_fdl"):
        state_sh, bank_sh, params_sh, x_sh = fmajor_shardings(mesh, seng)
    else:
        state_sh, bank_sh, params_sh, x_sh = cascade_shardings(mesh, seng)
    return state_sh, bank_sh, params_sh, x_sh, NamedSharding(
        mesh, PartitionSpec())


def _virtual_engine(eng, vv: int):
    """`eng.with_voices(vv)` memoized ON the base engine: every
    render_offline call reuses the same virtual-engine instance, so the
    jitted step/prime functions cached on it (_cached_fn) survive across
    bounces — a fresh closure per call re-traced and re-loaded
    executables every rep (measured ~7 s of the 11.7 s warm bounce)."""
    cache = eng.__dict__.setdefault("_offline_engines", {})
    if vv not in cache:
        if vv == eng.num_voices:
            cache[vv] = eng
        elif (getattr(eng, "mac_strategy", None) == "allk"
              and getattr(eng, "swap_snapshot", False)):
            # a bounce never swaps banks mid-fade: drop the fmajor fade
            # snapshot `base` — ~11 MB of dead HBM per virtual voice at
            # 4 s IRs, the difference between ~500 and ~1500 usable
            # segments on one chip
            cache[vv] = eng.with_voices(vv, swap_snapshot=False)
        else:
            cache[vv] = eng.with_voices(vv)
    return cache[vv]


def _cached_fn(seng, key, builder):
    """Memoize a built (jitted) function on the virtual engine instance,
    keyed by the shape/config tuple that the closure bakes in."""
    cache = seng.__dict__.setdefault("_bounce_fns", {})
    if key not in cache:
        cache[key] = builder()
    return cache[key]


def _prime_fast(seng, state, xb_dev, t0, nt: int, voice_of=None,
                shardings=None, dec=lambda a: a, dec_key=("f32", None)):
    """Bulk-prime every virtual voice's input history: one batched rfft
    over the whole block tensor (engine.input_spectra_bulk), a gather
    into the engine's fdl layout (engine.prime_fdl), and prev_in set to
    block t0-1's raw samples. All big tensors are explicit jit args.
    `voice_of` maps virtual voices onto a per-voice input tensor's base
    voices (None for shared program material); `shardings` pins a
    mesh-sharded bounce's state/output placements; `dec` decodes the
    pcm16 input wire in-graph (identity for f32; `dec_key` is its
    cache identity)."""
    spec_fn, prime = _prime_fns(seng, nt, voice_of is not None, shardings,
                                dec, dec_key)
    spec = spec_fn(xb_dev)
    return prime(state, xb_dev, spec, t0, voice_of)


def _prime_fns(seng, nt: int, per_voice: bool, shardings, dec, dec_key):
    """The prime stage's two jits (bulk input spectra + fdl gather),
    memoized on the virtual engine — factored out of _prime_fast so the
    background precompiler can AOT-compile them from avals before any
    device work runs."""
    mesh_key = None if shardings is None else shardings[4].mesh
    repl_kw = ({} if shardings is None
               else {"out_shardings": shardings[4]})
    spec_fn = _cached_fn(seng, ("spec", mesh_key, dec_key),
                         lambda: jax.jit(
        lambda xb_a: seng.input_spectra_bulk(dec(xb_a)), **repl_kw))

    def build():
        def _prime(st, xb_a, spec_a, t0_a, vof_a):
            st = seng.prime_fdl(st, spec_a, t0_a, voice_of=vof_a)
            prev = jnp.clip(t0_a - 1, 0, nt - 1)
            if vof_a is None:
                pim = dec(jnp.take(xb_a, prev, axis=0))
            else:
                pim = dec(xb_a[prev, vof_a])
            pim = jnp.where((t0_a >= 1)[:, None, None], pim, 0.0)
            return replace(st, prev_in=pim)
        kw = ({} if shardings is None
              else {"out_shardings": shardings[0]})
        return jax.jit(_prime, donate_argnums=0, **kw)

    prime = _cached_fn(
        seng, ("prime", nt, per_voice, mesh_key, dec_key), build)
    return spec_fn, prime


def _sds(tree):
    """Shape/dtype avals for a pytree of arrays (or avals, idempotent)."""
    return jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a),
                                       a.dtype if hasattr(a, "dtype")
                                       else np.asarray(a).dtype), tree)


def _precompile_async(seng, bank, vparams, jobs) -> None:
    """Cold-start lever (opt-in: TPU_AUDIO_OFFLINE_PRECOMPILE=1): AOT
    lower+compile the bounce's executables CONCURRENTLY from worker
    threads while the main thread's serial chain (init compiles -> init
    runs -> prime -> steps) proceeds. XLA releases the GIL during
    compiles, so the cold chain collapses toward max() of the pieces
    instead of their sum. With the persistent
    compile cache configured, the main thread's own later compile of an
    identical program loads from disk (AOT .compile() does not populate
    the jit wrapper's dispatch cache).

    ``jobs``: [(label, jit_fn, make_args(state_aval))] — make_args
    returns the positional avals for fn.lower(). Shape/dtype-only: the
    threads never touch device data; a mismatch only wastes a background
    compile, it can never affect the bounce."""
    if os.environ.get("TPU_AUDIO_OFFLINE_PRECOMPILE") != "1":
        return
    import threading

    try:
        state_aval = jax.eval_shape(seng.init_converged, bank, vparams)
    except Exception as exc:  # noqa: BLE001 - best-effort optimization
        Log.debug("offline", "precompile skipped: %r", exc)
        return

    for label, fn, make_args in jobs:
        def work(label=label, fn=fn, make_args=make_args):
            try:
                import warnings
                t0 = time.perf_counter()
                with warnings.catch_warnings():
                    # AOT compiles from avals have nothing to donate —
                    # the "donated buffers were not usable" warning is
                    # expected and meaningless here (the real call's
                    # donation is unaffected)
                    warnings.filterwarnings(
                        "ignore", message=".*donated buffers.*")
                    fn.lower(*make_args(state_aval)).compile()
                Log.info("offline", "background %s precompile done in "
                         "%.1fs", label, time.perf_counter() - t0)
            except Exception as exc:  # noqa: BLE001 - never fail the bounce
                Log.debug("offline", "background %s precompile failed: %r",
                          label, exc)

        threading.Thread(target=work, daemon=True).start()


def _carry_aval(state_aval):
    return (state_aval, jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.bool_))


def _prime_jobs(seng, nt, per_voice, shardings, dec, dec_key, xb_aval,
                n_virtual: int):
    """Precompile jobs for the prime stage (spec + fdl gather)."""
    spec_fn, prime = _prime_fns(seng, nt, per_voice, shardings, dec,
                                dec_key)
    try:
        spec_aval = jax.eval_shape(spec_fn, xb_aval)
    except Exception as exc:  # noqa: BLE001
        Log.debug("offline", "prime precompile skipped: %r", exc)
        return []
    t0_aval = jax.ShapeDtypeStruct((n_virtual,), jnp.int32)
    vof_aval = (jax.ShapeDtypeStruct((n_virtual,), jnp.int32)
                if per_voice else None)
    return [("spec", spec_fn, lambda st: (xb_aval,)),
            ("prime", prime,
             lambda st: (st, xb_aval, spec_aval, t0_aval, vof_aval))]


def _collect(step, state, warmup: int, seg_len: int,
             consts: tuple = ()) -> np.ndarray:
    """Drive the chained step and collect [seg_len, Vv, 2, B] on the host.

    Every per-step output starts its device->host copy immediately
    (`copy_to_host_async`) and is converted at the end, so the fetch
    overlaps the chain instead of adding to it, while stacking outputs
    on device every N steps serialized dispatch (eager `jnp.stack` of 64
    arrays cost ~15 ms/step amortized; even a jitted stack paid ~2.6).
    `consts` are the step's loop-invariant device arguments (input
    tensor, bank, params — explicit jit args so they never inline into
    the lowered HLO as constants).

    The carry's third element is the in-graph finiteness accumulator
    (every step ANDs `isfinite(raw y).all()` into it before any wire
    encode); non-finite output raises here, so EVERY wire — pcm16
    included, whose encoder clips NaN into valid samples — is
    self-verifying and no separate f32 verification pass is needed."""
    carry = (state, jnp.zeros((), jnp.int32), jnp.asarray(True))
    for _ in range(warmup):
        carry, _ = step(carry, *consts)
    ys = []
    for _ in range(seg_len):
        carry, y = step(carry, *consts)
        try:
            y.copy_to_host_async()
        except Exception:
            pass
        ys.append(y)
    out = np.stack([np.asarray(y) for y in ys])
    if not bool(np.asarray(carry[2])):
        raise RuntimeError(
            "offline bounce produced non-finite output (in-graph "
            "isfinite accumulator on the raw engine output)")
    return out
