"""Proof that the serving path runs on one NVIDIA GPU, end to end.

    python chip_smoke.py                # one card: device, serve_fmajor, serve_cascade
    python chip_smoke.py --multi-gpu    # four cards: the voice-parallel path only

Phases (each must pass, or the script exits non-zero and prints no result):

  device         the first JAX device is a GPU; prints jax's version, the
                 device kind and nvidia-smi's name and power limit.
  serve_fmajor   the headline deployment through the app's own entry point
                 (tpu_audio.app.main): 64 stereo voices, a bank of 4 IRs of
                 4 s at 44.1 kHz, 256-frame blocks, the fmajor engine, a
                 scripted MIDI re-select partway through. The streamed
                 output is compared with a float64 scipy reference over the
                 converged prefix and over a window after the fade settles.
  serve_cascade  the capacity engine through StreamSession: 1024 voices,
                 f32, stagger ratio 16, the same bank, one re-select, the
                 same golden comparison on a sample of voices.

With --multi-gpu only a voice-parallel StreamSession over a 4-card mesh
(4 x 64 voices, full IR length, compared with a one-card run of the same
voices) and then __graft_entry__.dryrun_multichip(4) run. A watchdog
fails the run (exit 1, every thread's stack on stderr) if it has not
finished after WATCHDOG_S seconds.

The IRs are synthesized from --seed (exponentially decaying noise, the
shape benchlib/measure.py uses) and written as WAVs with an index and a
settings file into a scratch directory. Timings printed here are host-timed
diagnostics for the card named on the device line, not benchmark numbers.
The last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 44100
BLOCK = 256
IR_SECONDS = 4.0
NUM_IRS = 4
MAX_PREDELAY = 8192
# float64 reference vs the float32 engine over a 4 s IR (176,400 taps):
# the same bound the bench's golden check uses; the app's 16-bit output
# WAV adds at most 1.5e-5
GOLDEN_TOL = 2e-3
# one voice-parallel mesh vs one card: the same per-voice arithmetic, only
# the device differs
MESH_TOL = 1e-5
# a hung phase (e.g. a collective that never completes) must fail the run
# inside the 1200 s a caller allows: dump every thread's stack and exit 1
WATCHDOG_S = 1100


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# -- inputs ------------------------------------------------------------------


def synth_irs(seed: int, num_irs: int = NUM_IRS, seconds: float = IR_SECONDS,
              sample_rate: int = SR) -> list[np.ndarray]:
    """Stereo exponentially decaying noise IRs [2, L], scaled to unit
    energy per channel so a 0.05-rms input stays well inside the clip."""
    n = int(seconds * sample_rate)
    rng = np.random.default_rng(seed)
    env = np.exp(-np.arange(n) / (0.4 * n))
    irs = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, n)) * env
        ir /= np.sqrt((ir ** 2).sum(axis=-1, keepdims=True))
        irs.append(ir.astype(np.float32))
    return irs


def crossfade_settle_blocks(speed: int, floor: float = 1e-7) -> int:
    """Blocks until the outgoing IR's weight falls below `floor`: the
    engines' recursion a *= 1 - 1/(vsteps + 5), vsteps counting down from
    the channel's speed."""
    a, vsteps, n = 1.0, float(speed), 0
    while a >= floor:
        a *= 1.0 - 1.0 / (vsteps + 5.0)
        vsteps = max(vsteps - 1.0, 0.0)
        n += 1
    return n


# -- float64 reference ---------------------------------------------------------


class Golden:
    """Float64 reference for the engines' output (benchlib/legs.py's
    formula, with per-channel gains):

        out[o] = clip(sum_i wet_i * level_i * panw_i[o]
                      * delay_pd(x_i (*) ir_sel_i[o]), -1, 1)
                 + sum_i dry_i * level_i * pand_i[o] * x_i

    where pd is the voice's channel-0 predelay and pan[o] is the
    constant-sum pan law (ops/mix.py). Convolutions are cached per (input
    channel, IR, output channel): voices share the program material."""

    def __init__(self, x: np.ndarray, irs: list[np.ndarray], n: int):
        self.x = np.asarray(x, np.float64)[:, :n]       # [2, n]
        self.irs = irs
        self.n = n
        self._conv = {}

    def conv(self, i: int, k: int, o: int) -> np.ndarray:
        key = (i, k, o)
        if key not in self._conv:
            from scipy.signal import fftconvolve
            self._conv[key] = fftconvolve(
                self.x[i], np.asarray(self.irs[k][o], np.float64))[:self.n]
        return self._conv[key]

    @staticmethod
    def pan(p: float) -> tuple[float, float]:
        return (1.0 - p if p >= 0 else 1.0, 1.0 + p if p <= 0 else 1.0)

    def voice(self, select, predelay: int, wet, dry, level=(1.0, 1.0),
              pan_wet=(0.0, 0.0), pan_dry=(0.0, 0.0)) -> np.ndarray:
        """[2, n] output of one voice held at these parameters since
        sample 0 (select/wet/dry/level/pans per input channel)."""
        out = np.zeros((2, self.n))
        for o in range(2):
            acc = np.zeros(self.n)
            for i in range(2):
                g = wet[i] * level[i] * self.pan(pan_wet[i])[o]
                acc += g * self.conv(i, int(select[i]), o)
            wet_o = np.zeros(self.n)
            wet_o[predelay:] = acc[:self.n - predelay]
            dry_o = sum(dry[i] * level[i] * self.pan(pan_dry[i])[o]
                        * self.x[i] for i in range(2))
            out[o] = np.clip(wet_o, -1.0, 1.0) + dry_o
        return out


def golden_error(got: np.ndarray, want: np.ndarray, lo: int, hi: int) -> float:
    """Max |got - want| over samples [lo, hi) of [2, T] arrays."""
    return float(np.abs(np.asarray(got, np.float64)[:, lo:hi]
                        - want[:, lo:hi]).max())


# -- phases -------------------------------------------------------------------


def phase_device(expect_count: int | None = None) -> dict:
    import jax

    devs = jax.devices()
    check(devs and devs[0].platform == "gpu",
          f"first JAX device is {devs[0].platform if devs else 'none'!r}, "
          f"not a GPU (nothing falls back to the CPU)")
    if expect_count is not None:
        check(len(devs) >= expect_count,
              f"{len(devs)} GPU(s) visible, need {expect_count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] jax {jax.__version__} | {devs[0].device_kind} x"
          f"{len(devs)} | nvidia-smi: {card}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def precision_note() -> str:
    """The contraction precisions the engines run at (see PERF.md)."""
    from tpu_audio.engine import cascade, fmajor
    from tpu_audio.ops import fft

    def name(p):
        return getattr(p, "name", str(p))

    return (f"mac={name(fmajor.MAC_PRECISION)} "
            f"mix={name(fmajor.MIX_PRECISION)} "
            f"cascade_mix={name(cascade.MIX_PRECISION)} "
            f"fft_auto={fft.auto_backend(512)}@512,"
            f"{fft.auto_backend(8192)}@8192")


def write_inputs(workdir: str, seed: int, blocks: int, voices: int,
                 ir_seconds: float = IR_SECONDS):
    """IR WAVs + index + settings (per-voice parameters) + program WAV."""
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import write_wav

    irs = synth_irs(seed, seconds=ir_seconds)
    paths = []
    for k, ir in enumerate(irs):
        p = os.path.join(workdir, f"ir{k}.wav")
        write_wav(p, ir.T, SR, bits=32, scale="reference")
        paths.append(p)
    index = os.path.join(workdir, "bank.index")
    write_index(index, paths)
    lines = [f"conv.count {2 * voices}"]
    for v in range(voices):
        for ch in range(2):
            n = 2 * v + ch
            lines += [f"conv[{n}].fftSize 131072",
                      f"conv[{n}].maxPredelay {MAX_PREDELAY}",
                      f"conv[{n}].index {index}",
                      f"conv[{n}].cc.message 176",
                      f"conv[{n}].cc.select 21",
                      f"conv[{n}].value.select {(v + ch) % NUM_IRS}",
                      f"conv[{n}].value.predelay {(v % 7) * 300}",
                      f"conv[{n}].value.wet {0.5 + 0.1 * (v % 4):.2f}",
                      f"conv[{n}].value.dry {0.1 + 0.05 * (v % 3):.2f}",
                      f"conv[{n}].value.level {1.0 - 0.1 * (v % 2):.2f}",
                      f"conv[{n}].value.panWet {0.25 * (ch - 0.5) * (v % 3):.3f}",
                      f"conv[{n}].value.panDry 0",
                      f"conv[{n}].value.speed 8"]
    settings = os.path.join(workdir, "settings.txt")
    with open(settings, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((blocks * BLOCK, 2)) * 0.05).astype(np.float32)
    program = os.path.join(workdir, "in.wav")
    write_wav(program, x, SR, bits=32, scale="reference")
    return settings, index, program


def voice_params(control, v: int) -> dict:
    return {"select": control.select[v].copy(),
            "predelay": int(control.predelay[v, 0]),
            "wet": control.wet[v].astype(np.float64),
            "dry": control.dry[v].astype(np.float64),
            "level": control.level[v].astype(np.float64),
            "pan_wet": control.pan_wet[v].astype(np.float64),
            "pan_dry": control.pan_dry[v].astype(np.float64)}


def check_golden(label: str, golden: Golden, outputs: dict, before: dict,
                 after: dict, event_block: int, settled_block: int,
                 total_blocks: int) -> float:
    """Compare each sampled voice's [2, T] output with the reference:
    samples before the event against the initial parameters, samples from
    `settled_block` on against the re-selected ones."""
    worst = 0.0
    pre = (event_block - 1) * BLOCK
    lo, hi = settled_block * BLOCK, total_blocks * BLOCK
    check(hi - lo >= 16 * BLOCK, f"{label}: settled window too short")
    for v, out in outputs.items():
        check(out.shape == (2, total_blocks * BLOCK),
              f"{label}: voice {v} output shape {out.shape}")
        check(np.isfinite(out).all(), f"{label}: voice {v} non-finite")
        e1 = golden_error(out, golden.voice(**before[v]), 0, pre)
        e2 = golden_error(out, golden.voice(**after[v]), lo, hi)
        worst = max(worst, e1, e2)
        check(e1 < GOLDEN_TOL and e2 < GOLDEN_TOL,
              f"{label}: voice {v} golden error {max(e1, e2):.3e} "
              f"(prefix {e1:.3e}, settled {e2:.3e}) > {GOLDEN_TOL}")
    check(max(np.abs(o).max() for o in outputs.values()) > 1e-3,
          f"{label}: silent output")
    return worst


def phase_serve_fmajor(workdir: str, seed: int, voices: int = 64,
                       blocks: int = 200, event: int = 60,
                       ir_seconds: float = IR_SECONDS) -> float:
    from tpu_audio.app.main import main as app_main
    from tpu_audio.engine.bank import IRBank
    from tpu_audio.engine.params import ControlPlane
    from tpu_audio.io.settings import Settings
    from tpu_audio.io.wav import read_wav

    settings, index, program = write_inputs(workdir, seed, blocks, voices,
                                            ir_seconds)
    midi = os.path.join(workdir, "events.txt")
    with open(midi, "w") as fh:
        fh.write(f"{event} B0 15 7F\n")       # every channel -> IR 3
    out_path = os.path.join(workdir, "out.wav")
    t0 = time.perf_counter()
    rc = app_main(["--settings", settings, "--input", program,
                   "--output", out_path, "--out-voice", "all",
                   "--engine", "fmajor", "--bank-prep", "device",
                   "--midi", midi, "--blocks", str(blocks),
                   "--block-size", str(BLOCK), "--quiet"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"app exited {rc}")

    # the reference reads everything back the way the app did
    bank = IRBank.from_index(index, sample_rate=SR, verbose=False)
    irs = [bank.ir(k) for k in range(len(bank))]
    x = read_wav(program, verbose=False).stereo().T
    golden = Golden(x, irs, blocks * BLOCK)
    parsed = Settings().open(settings, verbose=False)
    control = ControlPlane(voices, len(bank), MAX_PREDELAY)
    for v in range(voices):
        for ch in range(2):
            control.load_initial_values(parsed, v, ch, 2 * v + ch)
    sample = sorted({0, 1, 2, 3, voices // 4 + 1, voices // 2 - 1,
                     3 * voices // 4 - 2, voices - 1} & set(range(voices)))
    before = {v: voice_params(control, v) for v in sample}
    control.select[:] = 127 * len(bank) // 128
    after = {v: voice_params(control, v) for v in sample}
    outputs = {v: read_wav(f"{out_path[:-4]}_v{v:03d}.wav", scale="full",
                           verbose=False).stereo().T for v in sample}
    settled = event + crossfade_settle_blocks(8)
    err = check_golden("serve_fmajor", golden, outputs, before, after,
                       event, settled, blocks)
    print(f"[serve_fmajor] {voices} voices x {NUM_IRS} IRs x {ir_seconds} s, "
          f"{blocks} blocks through tpu_audio.app, re-select at block "
          f"{event}: golden max error {err:.3e} (tol {GOLDEN_TOL:g}; "
          f"voices {sample}, both channels, blocks [0,{event - 1}) and "
          f"[{settled},{blocks})) | precision {precision_note()} | "
          f"app wall {wall:.1f} s incl. compile", flush=True)
    return err


class SampledSink:
    """BlockSink keeping only some voices' output (a 1024-voice session
    would otherwise buffer ~2 MB per block on the host)."""

    def __init__(self, voices):
        self.voices = list(voices)
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.asarray(block)[self.voices])

    def close(self):
        pass

    def outputs(self) -> dict:
        data = np.concatenate(self.blocks, axis=-1)
        return {v: data[j] for j, v in enumerate(self.voices)}


def build_model(irs, voices: int, engine: str, **kwargs):
    """ConvolutionReverb over `irs` with varied per-voice parameters and a
    select CC mapped on every channel."""
    from tpu_audio.engine.bank import IRBank
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.models.reverb import ConvolutionReverb

    bank = IRBank(sample_rate=SR)
    for ir in irs:
        bank.append(ir)
    kwargs.setdefault("bank_prep", "device")
    model = ConvolutionReverb(bank, num_voices=voices, block=BLOCK,
                              sample_rate=SR, engine=engine,
                              max_predelay=MAX_PREDELAY, **kwargs)
    c = model.control
    v = np.arange(voices)
    c.select[:] = (v[:, None] + np.arange(2)[None, :]) % len(irs)
    c.predelay[:] = ((v % 7) * 300)[:, None]
    c.wet[:] = (0.5 + 0.1 * (v % 4))[:, None]
    c.dry[:] = (0.1 + 0.05 * (v % 3))[:, None]
    c.speed[:] = 8
    for voice in range(voices):
        for ch in range(2):
            c.set_mapping(voice, ch, CCMapping(message=0xB0, select=21))
    return model


def stream(model, x, blocks: int, event: int, sample, mesh=None):
    """Stream `blocks` blocks of program `x` [2, T] through a session with
    a re-select to the last IR at `event`; returns (outputs, summary, s)."""
    from tpu_audio.runtime.backends import WavSource
    from tpu_audio.runtime.stream import MidiSchedule

    sink = SampledSink(sample)
    session = model.session(WavSource(x, model.engine.num_voices, BLOCK),
                            sink, mesh=mesh)
    t0 = time.perf_counter()
    session.run(model.init_state(), max_blocks=blocks,
                midi=MidiSchedule([(event, "", bytes([0xB0, 0x15, 0x7F]))]))
    return sink.outputs(), session.summary(), time.perf_counter() - t0


def phase_serve_cascade(seed: int, voices: int = 1024, blocks: int = 200,
                        event: int = 40, ratio: int = 16,
                        ir_seconds: float = IR_SECONDS) -> float:
    irs = synth_irs(seed, seconds=ir_seconds)
    x = (np.random.default_rng(seed + 1).standard_normal(
        (2, blocks * BLOCK)) * 0.05).astype(np.float32)
    model = build_model(irs, voices, "cascade", cascade_ratio=ratio)
    check(model.engine.ratio == ratio,
          f"cascade ratio {model.engine.ratio} != {ratio}")
    sample = sorted({0, 1, 5, ratio, voices // 4 - 1, voices // 2 - 1,
                     3 * voices // 4 + 9, voices - 1} & set(range(voices)))
    before = {v: voice_params(model.control, v) for v in sample}
    outputs, summary, wall = stream(model, x, blocks, event, sample)
    after = {v: voice_params(model.control, v) for v in sample}
    golden = Golden(x, [model.bank.ir(k) for k in range(len(model.bank))],
                    blocks * BLOCK)
    # the tail reaches a parameter event up to 2*ratio+1 blocks late
    settled = event + crossfade_settle_blocks(8) + 2 * ratio + 2
    err = check_golden("serve_cascade", golden, outputs, before, after,
                       event, settled, blocks)
    print(f"[serve_cascade] {voices} voices f32 ratio {ratio} x {NUM_IRS} "
          f"IRs x {ir_seconds} s, tail FFT n={2 * model.engine.b2} "
          f"({model.engine.xf2.backend}), tail_mac {model.engine.tail_mac}, "
          f"re-select at block {event}: golden max error {err:.3e} "
          f"(tol {GOLDEN_TOL:g}; voices {sample}) | precision "
          f"{precision_note()} | host-timed p50 {summary['p50_ms']:.3f} ms "
          f"p99 {summary['p99_ms']:.3f} ms per block, run wall {wall:.1f} s "
          f"incl. compile", flush=True)
    return err


def phase_multi_gpu(seed: int, cards: int = 4, voices_per_card: int = 64,
                    blocks: int = 120, event: int = 30,
                    ir_seconds: float = IR_SECONDS) -> None:
    """The voice-parallel session first (its hot loop needs no
    collective), then __graft_entry__.dryrun_multichip, whose sharded
    steps run collectives across the cards."""
    import jax

    from tpu_audio.parallel.mesh import make_mesh

    voices = cards * voices_per_card
    irs = synth_irs(seed, seconds=ir_seconds)
    x = (np.random.default_rng(seed + 1).standard_normal(
        (2, blocks * BLOCK)) * 0.05).astype(np.float32)
    sample = list(range(0, voices, 5))
    mesh = make_mesh(cards, part=1)
    sharded, _, wall_m = stream(build_model(irs, voices, "fmajor"), x,
                                blocks, event, sample, mesh=mesh)
    with jax.default_device(jax.devices()[0]):
        single, _, wall_1 = stream(build_model(irs, voices, "fmajor"),
                                   x, blocks, event, sample)
    diff = max(float(np.abs(sharded[v] - single[v]).max()) for v in sample)
    check(diff < MESH_TOL, f"mesh vs one card max diff {diff:.3e} "
          f"> {MESH_TOL}")
    check(max(np.abs(o).max() for o in single.values()) > 1e-3,
          "multi_gpu: silent output")
    print(f"[multi_gpu] voice-parallel StreamSession over a {cards}-card "
          f"mesh, {voices} voices x {NUM_IRS} IRs x {ir_seconds} s, {blocks} "
          f"blocks with a re-select: max |mesh - one card| {diff:.3e} "
          f"(tol {MESH_TOL:g}, {len(sample)} voices) | wall mesh "
          f"{wall_m:.1f} s, one card {wall_1:.1f} s incl. compile",
          flush=True)

    sys.path.insert(0, HERE)
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(cards)
    print(f"[multi_gpu] dryrun_multichip({cards}) passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the 4-card voice-parallel path and its "
                         "one-card comparison")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    try:
        if not os.path.isdir(os.path.join(HERE, "tpu_audio")):
            raise SmokeFailure("tpu_audio is not beside chip_smoke.py")
        sys.path.insert(0, HERE)
        from tpu_audio.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        device = phase_device(4 if args.multi_gpu else None)
        if args.multi_gpu:
            phase_multi_gpu(args.seed)
        else:
            with tempfile.TemporaryDirectory() as workdir:
                phase_serve_fmajor(workdir, args.seed)
            phase_serve_cascade(args.seed)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
