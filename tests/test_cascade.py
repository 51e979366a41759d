"""Cascade (two-stage non-uniform partitioned) engine tests.

Steady state must be EXACT vs the uniform fmajor engine (which is itself
golden-tested against scipy.fftconvolve); fades converge to the uniform
trajectory with the documented tail quantization bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_audio.engine import ControlPlane, IRBank
from tpu_audio.engine.cascade import CascadeConvolution
from tpu_audio.engine.fmajor import FMajorPartitionedConvolution

B = 32       # block
M = 4        # stagger ratio -> B2 = 128, head = 256 samples
V = 4        # voices (divisible by M)
K = 3
IR_LEN = 1200
MAXPD = 64


def build(seed=0, ir_len=IR_LEN, num_voices=V):
    rng = np.random.default_rng(seed)
    bank = IRBank()
    for _ in range(K):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        bank.append(ir * (0.4 / np.abs(ir).max()))
    p = bank.max_partitions(B)
    cas = CascadeConvolution(num_voices, B, p, ratio=M, max_predelay=MAXPD)
    fm = FMajorPartitionedConvolution(num_voices, B, p, max_predelay=MAXPD)
    return bank, cas, cas.prepare_bank(bank), fm, fm.prepare_bank(
        bank.partitioned_spectra(B))


def control(num_voices=V):
    cp = ControlPlane(num_voices, K, max_predelay=MAXPD)
    cp.wet[:] = 0.8
    cp.dry[:] = 0.15
    cp.level[:] = 0.9
    cp.pan_wet[:] = [[-0.5, 0.25]] * (num_voices // 2) + \
                    [[0.0, 0.75]] * (num_voices - num_voices // 2)
    cp.predelay[:, 0] = [0, 9, 37, 63][:num_voices] * (num_voices // V or 1)
    cp.select[:, 0] = np.arange(num_voices) % K
    cp.select[:, 1] = (np.arange(num_voices) + 1) % K
    return cp


def run_steps(engine, bank_d, cp, x_blocks, step=None):
    params = jax.tree.map(jnp.asarray, cp.snapshot())
    state = engine.init_converged(bank_d, params)
    fn = jax.jit(step or engine.step_coef_steady, donate_argnums=())
    outs = []
    for x in x_blocks:
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state, o = fn(state, bank_d, params, jnp.asarray(x))
        outs.append(np.asarray(o))
        cp.end_block()
    return np.concatenate(outs, axis=-1), state


def test_geometry_guards():
    bank, cas, *_ = build()
    assert cas.head_parts == 2 * M
    assert cas.b2 == M * B
    with pytest.raises(ValueError, match="divisible"):
        CascadeConvolution(3, B, 40, ratio=M)
    with pytest.raises(ValueError, match="fmajor"):
        CascadeConvolution(V, B, 2 * M, ratio=M)


def test_steady_matches_fmajor_exactly():
    """With constant parameters (mixed predelays incl. sub-block parts,
    pans, levels, per-channel selects) the cascade must reproduce the
    uniform engine sample-for-sample once both are warm."""
    bank, cas, cas_bank, fm, fm_bank = build()
    rng = np.random.default_rng(1)
    n_blocks = 64
    xs = [rng.standard_normal((V, 2, B)).astype(np.float32) * 0.05
          for _ in range(n_blocks)]
    got, _ = run_steps(cas, cas_bank, control(), xs)
    want, _ = run_steps(fm, fm_bank, control(), xs)
    np.testing.assert_allclose(got, want, atol=3e-5)
    assert np.abs(want).max() > 1e-3  # the tail actually sounded


def test_steady_impulse_tail_content():
    """An impulse through the cascade must reproduce the full IR including
    the tail-stage region (samples >= 2*B2), verifying the tail scheduling
    offsets directly against the IR samples."""
    bank, cas, cas_bank, _, _ = build()
    cp = control()
    cp.dry[:] = 0.0
    cp.wet[:] = 1.0
    cp.level[:] = 1.0
    cp.pan_wet[:] = 0.0
    cp.predelay[:] = 0
    cp.select[:] = 1
    n_blocks = IR_LEN // B + 3 * M
    xs = [np.zeros((V, 2, B), np.float32) for _ in range(n_blocks)]
    xs[0][:, :, 0] = 1.0
    got, _ = run_steps(cas, cas_bank, cp, xs)
    ir = bank.ir(1)
    from tpu_audio.ops.mix import pan_gains as _pg
    # both input channels convolve with IR channel o at center pan (gain
    # sqrt(1/2) each per the engines' pan law)
    gl, _ = _pg(jnp.zeros(()))
    expect = float(gl) * (ir + ir)  # impulse on both channels
    for v in range(V):
        np.testing.assert_allclose(got[v, :, : IR_LEN], expect[:, :IR_LEN],
                                   atol=3e-5, err_msg=f"voice {v}")
    # beyond the IR: silence
    assert np.abs(got[..., IR_LEN + B:]).max() < 3e-5


@pytest.mark.parametrize("vsteps,bound,check_settle", [
    # worst case: a 6-block full-bank fade over flat-noise IRs whose tails
    # carry most of the energy — the new selection's tail fades in up to
    # one tail window late (documented); bounded, no blowup
    (6, 0.35, True),
    # realistic fade speeds: the deviation shrinks with the fade rate
    (120, 0.04, False),
])
def test_fade_converges_to_uniform(vsteps, bound, check_settle):
    """A span collapse + crossfade: the cascade's head responds per block
    and its tail within one tail window; after the fade decays the two
    engines agree at steady tolerance again. During the fade the deviation
    is bounded (no clicks) and scales down with the fade length."""
    bank, cas, cas_bank, fm, fm_bank = build()
    rng = np.random.default_rng(2)
    n_blocks = 140
    xs = [rng.standard_normal((V, 2, B)).astype(np.float32) * 0.05
          for _ in range(n_blocks)]

    def run(engine, bank_d):
        cp = control()
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state = engine.init_converged(bank_d, params)
        step = jax.jit(engine.step_coef_indexed, donate_argnums=())
        cpure = jax.jit(engine.collapse_pure, donate_argnums=())
        takes_params = getattr(engine, "collapse_pure_takes_params", False)
        outs = []
        for t, x in enumerate(xs):
            if t == 8:  # re-select everything
                old = cp.select.copy()
                cp.select[:] = (cp.select + 1) % K
                cp.vsteps[:] = vsteps
                args = (state, jnp.asarray(old),
                        jnp.asarray(np.ones_like(old, bool)))
                if takes_params:
                    args += (jax.tree.map(jnp.asarray, cp.snapshot()),)
                state = cpure(*args)
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            state, o = step(state, bank_d, params, jnp.asarray(x))
            outs.append(np.asarray(o))
            cp.end_block()
        return np.concatenate(outs, axis=-1)

    got = run(cas, cas_bank)
    want = run(fm, fm_bank)
    # before the fade: exact
    np.testing.assert_allclose(got[..., : 8 * B], want[..., : 8 * B],
                               atol=3e-5)
    # during/after the fade: bounded deviation (tail quantization), no blowup
    assert np.abs(got - want).max() < bound
    if check_settle:
        # well after convergence (fade + tail window + predelay): exact again
        settle = (8 + 70 + 3 * M + MAXPD // B) * B
        np.testing.assert_allclose(got[..., settle:], want[..., settle:],
                                   atol=3e-5)


def test_selected_strategy_matches_allk():
    """'selected' (per-voice materialized rhs, large-bank strategy) must
    reproduce 'allk' through steady state AND a full re-select crossfade:
    same affine-fade math — allk contracts the span against all-K products,
    selected MACs a materialized base rhs (the MAC is linear in its rhs) —
    so they agree at f32 steady tolerance, general vs indexed step,
    collapse vs collapse_pure, in-flight tail rescale included."""
    bank, cas, cas_bank, fm, fm_bank = build()
    sel = CascadeConvolution(V, B, cas.partitions, ratio=M,
                             max_predelay=MAXPD, mac_strategy="selected")
    assert sel.mac_strategy == "selected" and sel.swap_snapshot
    assert cas.mac_strategy == "allk" and not cas.swap_snapshot
    sel_bank = sel.prepare_bank(bank)
    rng = np.random.default_rng(13)
    xs = [rng.standard_normal((V, 2, B)).astype(np.float32) * 0.05
          for _ in range(72)]

    def run(engine, bank_d, selected):
        cp = control()
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state = engine.init_converged(bank_d, params)
        step = jax.jit(
            (lambda s, bk, p, x: engine.step_coef(s, bk, p, x,
                                                  with_base=True))
            if selected else engine.step_coef_indexed, donate_argnums=())
        outs = []
        for t, x in enumerate(xs):
            if t == 8:
                old = cp.select.copy()
                cp.select[:] = (cp.select + 1) % K
                cp.vsteps[:] = 24
                ch = jnp.asarray(np.ones_like(old, bool))
                pd = jax.tree.map(jnp.asarray, cp.snapshot())
                if selected:
                    state = jax.jit(engine.collapse)(
                        state, bank_d, jnp.asarray(old), ch,
                        jnp.asarray(cp.select), pd)
                else:
                    state = jax.jit(engine.collapse_pure)(
                        state, jnp.asarray(old), ch, pd)
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            state, o = step(state, bank_d, params, jnp.asarray(x))
            outs.append(np.asarray(o))
            cp.end_block()
        return np.concatenate(outs, axis=-1)

    got = run(sel, sel_bank, True)
    want = run(cas, cas_bank, False)
    np.testing.assert_allclose(got, want, atol=3e-5)
    assert np.abs(want).max() > 1e-3


def test_selected_session_matches_allk_session():
    """StreamSession integration for the 'selected' cascade: MIDI-driven
    re-selects route through the materializing collapse (+ the in-flight
    tail rescale via collapse_takes_params) and the general fade step;
    the stream must match the allk session at steady tolerance, and a
    checkpoint resume must be bit-exact against its own uninterrupted
    run."""
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.runtime.backends import WavSink, WavSource
    from tpu_audio.runtime.checkpoint import load_checkpoint, save_checkpoint
    from tpu_audio.runtime.stream import MidiSchedule, StreamSession

    bank, cas, cas_bank, _, _ = build()
    sel = CascadeConvolution(V, B, cas.partitions, ratio=M,
                             max_predelay=MAXPD, mac_strategy="selected")
    sel_bank = sel.prepare_bank(bank)

    def run_session(engine, bank_d, sink, src):
        cp = control()
        cp.set_mapping(0, 0, CCMapping(message=0xB0, select=0x15))
        cp.set_mapping(0, 1, CCMapping(message=0xB0, select=0x15))
        sess = StreamSession(engine, bank_d, cp, src, sink,
                             warmup=0, donate=False)
        midi = MidiSchedule([(5, "", bytes([0xB0, 0x15, 64]))])
        # init_converged: the 'selected' strategy gathers its per-voice
        # rhs there (init_state leaves them zero — silence)
        state0 = engine.init_converged(
            bank_d, jax.tree.map(jnp.asarray, cp.snapshot()))
        return sess, sess.run(state0, midi=midi)

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((V, 2, B * 40)) * 0.05).astype(np.float32)

    sink_a = WavSink("/dev/null", keep_data=True)
    sess_a, _ = run_session(cas, cas_bank, sink_a, WavSource(x, V, B))
    sink_s = WavSink("/dev/null", keep_data=True)
    sess_s, _ = run_session(sel, sel_bank, sink_s, WavSource(x, V, B))
    assert getattr(sess_a, "indexed_blocks", 0) >= 1   # allk rode the span
    np.testing.assert_allclose(sink_s.data, sink_a.data, atol=3e-5)
    assert np.abs(sink_a.data).max() > 1e-3

    # checkpoint resume, selected strategy: bit-exact vs its own full run
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ck = f"{td}/c.npz"
        cp2 = control()
        cp2.set_mapping(0, 0, CCMapping(message=0xB0, select=0x15))
        cp2.set_mapping(0, 1, CCMapping(message=0xB0, select=0x15))
        sink2 = WavSink("/dev/null", keep_data=True)
        sess2 = StreamSession(sel, sel_bank, cp2,
                              WavSource(x[..., : B * 22], V, B), sink2,
                              warmup=0, donate=False)
        state = sess2.run(
            sel.init_converged(sel_bank,
                               jax.tree.map(jnp.asarray, cp2.snapshot())),
            midi=MidiSchedule([(5, "", bytes([0xB0, 0x15, 64]))]))
        save_checkpoint(ck, state, cp2)

        cp3 = control()
        sink3 = WavSink("/dev/null", keep_data=True)
        state3, _ = load_checkpoint(ck, sel.init_state(), cp3)
        sess3 = StreamSession(sel, sel_bank, cp3,
                              WavSource(x[..., B * 22:], V, B), sink3,
                              warmup=0, donate=False)
        sess3.run(state3, midi=None)
        got = np.concatenate([sink2.data, sink3.data], axis=-1)
    np.testing.assert_array_equal(got, sink_s.data)


def test_selected_auto_strategy_and_guards():
    bank, cas, *_ = build()
    auto_small = CascadeConvolution(V, B, cas.partitions, ratio=M,
                                    max_predelay=MAXPD, num_irs=3,
                                    mac_strategy="auto")
    assert auto_small.mac_strategy == "allk"
    auto_big = CascadeConvolution(V, B, cas.partitions, ratio=M,
                                  max_predelay=MAXPD, num_irs=17,
                                  mac_strategy="auto")
    assert auto_big.mac_strategy == "selected"
    sel = CascadeConvolution(V, B, cas.partitions, ratio=M,
                             max_predelay=MAXPD, mac_strategy="selected")
    sel_bank = sel.prepare_bank(bank)
    cp = control()
    params = jax.tree.map(jnp.asarray, cp.snapshot())
    st = sel.init_converged(sel_bank, params)
    with pytest.raises(ValueError, match="allk"):
        sel.step_coef_indexed(st, sel_bank, params, jnp.zeros((V, 2, B)))
    with pytest.raises(ValueError, match="allk"):
        sel.collapse_pure(st, params.select,
                          jnp.ones((V, 2), bool), params)
    with pytest.raises(ValueError, match="allk"):
        sel.update_bank_slot(sel_bank, 0, np.zeros((2, 64), np.float32))
    with pytest.raises(ValueError, match="span-only"):
        cas.collapse(st, sel_bank, params.select,
                     jnp.ones((V, 2), bool), params.select, params)


def test_tail_mac_mxu_matches_vpu():
    """The dot_general tail-MAC lowering (auto-selected at large Vg,
    forced here at test shapes) must agree with the reduce form at
    f32 steady tolerance, through a mid-run span collapse + crossfade.
    Same math, different units — this guards the dimension numbers and
    the transpose back to the frequency-minor layout."""
    bank, cas, cas_bank, fm, fm_bank = build()
    assert cas.tail_mac == "reduce"     # auto picks reduce at Vg*I = 2 rows
    cas_m = CascadeConvolution(V, B, cas.partitions, ratio=M,
                               max_predelay=MAXPD, tail_mac="dot")
    assert cas_m.tail_mac == "dot"
    cas_m_bank = cas_m.prepare_bank(bank)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((V, 2, B)).astype(np.float32) * 0.05
          for _ in range(72)]

    def run(engine, bank_d):
        cp = control()
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state = engine.init_converged(bank_d, params)
        step = jax.jit(engine.step_coef_indexed, donate_argnums=())
        cpure = jax.jit(engine.collapse_pure, donate_argnums=())
        outs = []
        for t, x in enumerate(xs):
            if t == 8:
                old = cp.select.copy()
                cp.select[:] = (cp.select + 1) % K
                cp.vsteps[:] = 24
                state = cpure(state, jnp.asarray(old),
                              jnp.asarray(np.ones_like(old, bool)),
                              jax.tree.map(jnp.asarray, cp.snapshot()))
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            state, o = step(state, bank_d, params, jnp.asarray(x))
            outs.append(np.asarray(o))
            cp.end_block()
        return np.concatenate(outs, axis=-1)

    got = run(cas_m, cas_m_bank)
    want = run(cas, cas_bank)
    np.testing.assert_allclose(got, want, atol=3e-5)
    assert np.abs(want).max() > 1e-3


def test_predelay_change_transient_bounded_then_exact():
    """Mid-stream predelay changes: both engines scatter at WRITE time
    (reference src/conv.cu:411), but the cascade's in-flight tail chunks
    carry their compute-time predelay, so the tail's delay switches up to
    one tail window (2*ratio+1 blocks) later than the uniform engine's —
    the documented parameter-event quantization (engine docstring). The
    transient must stay bounded (no blowup, head responds immediately)
    and the engines must re-agree exactly once the window drains."""
    bank, cas, cas_bank, fm, fm_bank = build()
    rng = np.random.default_rng(11)
    n_blocks = 60
    xs = [rng.standard_normal((V, 2, B)).astype(np.float32) * 0.05
          for _ in range(n_blocks)]

    def run(engine, bank_d):
        cp = control()
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state = engine.init_converged(bank_d, params)
        step = jax.jit(engine.step_coef_steady, donate_argnums=())
        outs = []
        for t, x in enumerate(xs):
            if t == 20:
                cp.predelay[:, 0] = [63, 0, 17, 40][:V]   # jumps both ways
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            state, o = step(state, bank_d, params, jnp.asarray(x))
            outs.append(np.asarray(o))
            cp.end_block()
        return np.concatenate(outs, axis=-1)

    got = run(cas, cas_bank)
    want = run(fm, fm_bank)
    # exact before the change
    np.testing.assert_allclose(got[..., : 20 * B], want[..., : 20 * B],
                               atol=3e-5)
    # transient bounded by the wet signal scale itself (delayed-vs-not
    # content differs pointwise but never blows up)
    assert np.abs(got - want).max() < 2.0 * np.abs(want).max()
    # exact again after the tail window + old/new predelay drain
    settle = (20 + 2 * M + 2 + 2 * (MAXPD // B + 2)) * B
    np.testing.assert_allclose(got[..., settle:], want[..., settle:],
                               atol=3e-5)
    assert np.abs(want[..., settle:]).max() > 1e-3


def test_session_and_checkpoint_resume():
    """StreamSession drives the cascade (span fades via MIDI) and an
    in-stream checkpoint resumes bit-exactly (the t counter in state keeps
    the group stagger phase)."""
    from tpu_audio.engine.params import CCMapping
    from tpu_audio.runtime.backends import WavSink, WavSource
    from tpu_audio.runtime.checkpoint import load_checkpoint, save_checkpoint
    from tpu_audio.runtime.stream import MidiSchedule, StreamSession

    bank, cas, cas_bank, _, _ = build()

    def make_session(sink):
        cp = control()
        cp.set_mapping(0, 0, CCMapping(message=0xB0, select=0x15))
        cp.set_mapping(0, 1, CCMapping(message=0xB0, select=0x15))
        return cp, lambda src: StreamSession(cas, cas_bank, cp, src, sink,
                                             warmup=0, donate=False)

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((V, 2, B * 40)) * 0.05).astype(np.float32)
    midi = lambda: MidiSchedule([(5, "", bytes([0xB0, 0x15, 64]))])

    sink1 = WavSink("/dev/null", keep_data=True)
    cp1, mk1 = make_session(sink1)
    sess1 = mk1(WavSource(x, V, B))
    sess1.run(cas.init_state(), midi=midi())
    assert getattr(sess1, "indexed_blocks", 0) >= 1
    ref = sink1.data

    # split run with a checkpoint in the middle
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ck = f"{td}/c.npz"
        sink2 = WavSink("/dev/null", keep_data=True)
        cp2, mk2 = make_session(sink2)
        sess2 = mk2(WavSource(x[..., : B * 22], V, B))
        state = sess2.run(cas.init_state(), midi=midi())
        save_checkpoint(ck, state, cp2)

        sink3 = WavSink("/dev/null", keep_data=True)
        cp3, mk3 = make_session(sink3)
        state3, _ = load_checkpoint(ck, cas.init_state(), cp3)
        sess3 = mk3(WavSource(x[..., B * 22:], V, B))
        sess3.run(state3, midi=None)
        got = np.concatenate([sink2.data, sink3.data], axis=-1)
    np.testing.assert_array_equal(got, ref)


def test_model_and_cli_cascade(tmp_path):
    """engine='cascade' through the product surfaces: ConvolutionReverb
    picks a geometry-fitting stagger ratio, and the CLI streams a WAV
    through the cascade end-to-end."""
    from tpu_audio.app.main import main
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import read_wav, write_wav
    from tpu_audio.models.reverb import ConvolutionReverb, _fit_cascade_ratio

    assert _fit_cascade_ratio(16, 4, 63) == 4
    assert _fit_cascade_ratio(16, 64, 700) == 16
    with pytest.raises(ValueError, match="fmajor"):
        _fit_cascade_ratio(16, 5, 4)  # IR too short for any ratio >= 2

    rng = np.random.default_rng(4)
    paths = []
    for k in range(2):
        ir = rng.uniform(-0.3, 0.3, (4000, 2)).astype(np.float32)
        p = tmp_path / f"ir{k}.wav"
        write_wav(p, ir, 44100)
        paths.append(str(p))
    idx = tmp_path / "bank.index"
    write_index(idx, paths)
    sfile = tmp_path / "settings.txt"
    sfile.write_text(f"conv.count 2\nconv[0].index {idx}\n"
                     f"conv[1].index {idx}\nconv[0].value.wet 0.8\n"
                     f"conv[1].value.wet 0.8\n")

    model = ConvolutionReverb.from_settings(
        str(sfile), engine="cascade", block=32, num_voices=4,
        cascade_ratio=16, verbose=False)
    from tpu_audio.engine.cascade import CascadeConvolution
    assert isinstance(model.engine, CascadeConvolution)
    assert model.engine.ratio == 4  # auto-shrunk from 16 to fit 4 voices

    x = rng.uniform(-0.2, 0.2, (1600, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    out = tmp_path / "out.wav"
    rc = main(["--settings", str(sfile), "--input", str(tmp_path / "in.wav"),
               "--output", str(out), "--block-size", "32", "--quiet",
               "--engine", "cascade", "--voices", "4"])
    assert rc == 0
    w = read_wav(out, scale="full", verbose=False)
    assert np.abs(w.frames).max() > 1e-4


def test_span_only_guards():
    bank, cas, cas_bank, _, _ = build()
    cp = control()
    params = jax.tree.map(jnp.asarray, cp.snapshot())
    state = cas.init_converged(cas_bank, params)
    with pytest.raises(ValueError, match="span-only"):
        cas.step_coef(state, cas_bank, params,
                      jnp.zeros((V, 2, B)))
    with pytest.raises(ValueError, match="span-only"):
        cas.collapse(state, cas_bank, params.select, None)


def test_simultaneous_predelay_and_reselect():
    """A single MIDI event that changes predelay AND re-selects: the span
    collapse maps in-flight tail slots to compute blocks with the NEW
    predelay while the content was scattered under the OLD one, so the
    old tail's fade-out is mis-scaled by up to the predelay delta — a
    bounded transient (factors are products of (1-r) in [0,1]: never
    amplification, no blowup) that drains within one tail window, after
    which the engines agree exactly again."""
    bank, cas, cas_bank, fm, fm_bank = build()
    rng = np.random.default_rng(13)
    n_blocks = 120
    xs = [rng.standard_normal((V, 2, B)).astype(np.float32) * 0.05
          for _ in range(n_blocks)]

    def run(engine, bank_d):
        cp = control()
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state = engine.init_converged(bank_d, params)
        step = jax.jit(engine.step_coef_indexed, donate_argnums=())
        cpure = jax.jit(engine.collapse_pure, donate_argnums=())
        takes_params = getattr(engine, "collapse_pure_takes_params", False)
        outs = []
        for t, x in enumerate(xs):
            if t == 16:  # one event: big predelay jumps + re-select + fade
                old = cp.select.copy()
                cp.select[:] = (cp.select + 1) % K
                cp.predelay[:, 0] = [0, 63, 1, 40][:V]
                cp.vsteps[:] = 30
                args = (state, jnp.asarray(old),
                        jnp.asarray(np.ones_like(old, bool)))
                if takes_params:
                    args += (jax.tree.map(jnp.asarray, cp.snapshot()),)
                state = cpure(*args)
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            state, o = step(state, bank_d, params, jnp.asarray(x))
            outs.append(np.asarray(o))
            cp.end_block()
        return np.concatenate(outs, axis=-1)

    got = run(cas, cas_bank)
    want = run(fm, fm_bank)
    np.testing.assert_allclose(got[..., : 16 * B], want[..., : 16 * B],
                               atol=3e-5)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 2.0 * np.abs(want).max()  # bounded
    settle = (16 + 3 * (30 + 5) + 3 * M + 2 * (MAXPD // B + 2)) * B
    np.testing.assert_allclose(got[..., settle:], want[..., settle:],
                               atol=3e-5)


def test_device_bank_pack_matches_numpy_formula():
    """prepare_bank's on-device MAC-tensor derivation must equal the
    reference numpy packing (pack_mac_rhs + double_reversed, with the tail
    transposed frequency-minor) bit for bit."""
    from tpu_audio.engine.fmajor import double_reversed, pack_mac_rhs

    bank, cas, dev, _, _ = build()
    head_spec = bank.partitioned_spectra(B, max_partitions=cas.head_parts)
    tail_spec = bank.partitioned_spectra(cas.b2, offset=2 * cas.b2)
    pad = cas.tail_parts - tail_spec.shape[2]
    if pad > 0:
        tail_spec = np.pad(tail_spec, ((0, 0), (0, 0), (0, pad), (0, 0)))
    tail_spec = tail_spec[:, :, : cas.tail_parts]
    want_head = double_reversed(pack_mac_rhs(head_spec, cas.pp1), axis=2)
    want_tail = double_reversed(np.transpose(
        pack_mac_rhs(tail_spec, cas.pp2), (1, 2, 3, 0)), axis=1)
    np.testing.assert_array_equal(np.asarray(dev.head_rhs2), want_head)
    np.testing.assert_array_equal(np.asarray(dev.tail_rhs2), want_tail)


def test_update_bank_slot_matches_full_prepare():
    """Device-side single-slot packing == re-preparing the whole bank."""
    bank, cas, dev, _, _ = build()
    rng = np.random.default_rng(11)
    new_ir = rng.standard_normal((2, IR_LEN)).astype(np.float32) * 0.3
    updated = cas.update_bank_slot(dev, 1, new_ir)
    bank2 = IRBank()
    for k in range(K):
        bank2.append(new_ir if k == 1 else bank.ir(k))
    ref = cas.prepare_bank(bank2)
    np.testing.assert_array_equal(np.asarray(updated.head_rhs2),
                                  np.asarray(ref.head_rhs2))
    np.testing.assert_array_equal(np.asarray(updated.tail_rhs2),
                                  np.asarray(ref.tail_rhs2))


def test_read_side_predelay_equals_write_side_when_constant():
    """predelay_side='read' (FIFO head ring) must equal the write-side
    scatter EXACTLY while predelay is constant — fades, re-selects and
    per-voice q/r mixes included. Only predelay EDITS may differ (the
    documented skip/repeat vs gap/overlap semantics)."""
    bank, _, _, _, _ = build()
    p = bank.max_partitions(B)

    def run(side):
        eng = CascadeConvolution(V, B, p, ratio=M, max_predelay=MAXPD,
                                 predelay_side=side)
        dev = eng.prepare_bank(bank)
        cp = control()
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        state = eng.init_converged(dev, params)
        step = jax.jit(eng.step_coef_indexed, donate_argnums=())
        collapse = jax.jit(eng.collapse_pure, donate_argnums=())
        rng = np.random.default_rng(13)
        outs = []
        for t in range(3 * M * M + 8):
            if t == 7:  # mid-run re-select with a fade
                old = cp.select.copy()
                cp.select[:, 0] = (cp.select[:, 0] + 1) % K
                cp.vsteps[:] = 9
                params = jax.tree.map(jnp.asarray, cp.snapshot())
                state = collapse(state, jnp.asarray(old),
                                 jnp.asarray(old != cp.select), params)
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            x = jnp.asarray(rng.standard_normal((V, 2, B))
                            .astype(np.float32) * 0.05)
            state, o = step(state, dev, params, x)
            outs.append(np.asarray(o))
            cp.end_block()
        return np.concatenate(outs, axis=-1)

    got = run("read")
    want = run("write")
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 1e-4


def _run_predelay_session(side, edits, blocks=40, seed=14, init_pd=None,
                          maxpd=None):
    """Shared driver: cascade session on `side` with scripted host-side
    predelay edits {block: [V]-array-or-scalar}.

    maxpd: defaults to a DEEP predelay range (8*B + 17, deliberately not
    a multiple of B) — at the old MAXPD=64 with B=32 the only q=2 value
    is exactly 64, whose sub-block spill is zero, which made the first
    version of these tests structurally blind to the spill-slot
    clear-vs-accumulate bug (content emitting 2+ blocks in the future
    after a predelay decrease)."""
    maxpd = maxpd if maxpd is not None else 8 * B + 17
    bank, _, _, _, _ = build()
    p = bank.max_partitions(B)
    eng = CascadeConvolution(V, B, p, ratio=M, max_predelay=maxpd,
                             predelay_side=side)
    dev = eng.prepare_bank(bank)
    cp = control()
    cp.predelay[:, 0] = np.minimum(cp.predelay[:, 0], maxpd)
    if init_pd is not None:
        cp.predelay[:, 0] = init_pd
    params = jax.tree.map(jnp.asarray, cp.snapshot())
    state = eng.init_converged(dev, params)
    step = jax.jit(eng.step_coef_steady, donate_argnums=())
    rng = np.random.default_rng(seed)
    outs = []
    for t in range(blocks):
        if t in edits:
            cp.predelay[:, 0] = edits[t]
        params = jax.tree.map(jnp.asarray, cp.snapshot())
        x = jnp.asarray(rng.standard_normal((V, 2, B))
                        .astype(np.float32) * 0.05)
        state, o = step(state, dev, params, x)
        outs.append(np.asarray(o))
        cp.end_block()
    return np.stack(outs)


def test_read_side_predelay_edit_equals_write_side():
    """Predelay EDITS are now EXACT on the read side: the edit-block
    retime (per-voice forward roll + liveness mask, engine/cascade.py
    _head_stage) keeps every buffered sample's absolute emit time, which
    is precisely the write-side/reference residual-buffer semantics
    (src/conv.cu:89-100) — old wet keeps its old delay, new wet lands at
    the new one. Deepest jump both directions (with nonzero sub-block
    spill on both sides), plus chained edits inside the drain window."""
    pd = 8 * B + 17
    nh = pd // B + 2
    late = 6 * nh + 3   # WELL past t = 4*nh, where the first mask broke
    for edits, init_pd, blocks in (
            ({12: 5}, pd, 40),             # deep -> near-zero (forward roll)
            ({12: pd}, 5, 40),             # near-zero -> deep (backward)
            ({10: pd // 2, 13: 33}, pd, 40),  # chained, 2nd inside drain
            ({12: 0}, pd - 17, 40),        # r 15 -> 0, q -> 0 crossing
            # LATE edits: the retime's liveness offset must reduce t mod
            # nh BEFORE subtracting — the first implementation's
            # `src - (t - pd_q) + 4*nh` went negative past t ~ 4*nh,
            # truncating rem returned negative offsets that always
            # passed the live test, and stale already-emitted wet rolled
            # into live slots (review repro: maxdiff 0.31 at t=60 while
            # t=12 was bit-exact — every early test was blind)
            ({late: 5, late + 2 * nh: pd}, pd, late + 4 * nh),
            ({200: 33}, pd, 230)):
        got = _run_predelay_session("read", edits, init_pd=init_pd,
                                    blocks=blocks)
        want = _run_predelay_session("write", edits, init_pd=init_pd,
                                     blocks=blocks)
        np.testing.assert_array_equal(got, want)
        assert np.abs(want).max() > 1e-4


def test_read_side_predelay_fuzz_equals_write_side():
    """Randomized per-voice predelay edits (arbitrary magnitudes and
    spacing, no constraints) — read == write throughout."""
    rng = np.random.default_rng(99)
    pd = 8 * B + 17
    edits = {}
    # spread edits across the whole 150-block horizon (early tests only
    # edited before t=46 and missed the t > 4*nh mask bug)
    for t in sorted(rng.choice(np.arange(2, 146), size=10, replace=False)):
        edits[int(t)] = rng.integers(0, pd + 1, size=V)
    got = _run_predelay_session("read", edits, blocks=150, seed=21,
                                init_pd=pd)
    want = _run_predelay_session("write", edits, blocks=150, seed=21,
                                 init_pd=pd)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 1e-4


def test_materialize_base_equals_no_change_collapse():
    """Cascade 'selected': materialize_base == collapse(changed=all-False)
    leaf for leaf (the rescale factor is exactly 1.0 for unchanged voices,
    so keeping tail_ring untouched is identical), WITHOUT the full-bank
    gathers the traced form pays (stream.py bank-swap/resume callers)."""
    bank, cas, *_ = build()
    sel = CascadeConvolution(V, B, cas.partitions, ratio=M,
                             max_predelay=MAXPD, mac_strategy="selected")
    sel_bank = sel.prepare_bank(bank)
    cp = control()
    cp.vsteps[:] = 30
    params = jax.tree.map(jnp.asarray, cp.snapshot())
    state = sel.init_converged(sel_bank, params)
    assert bool(np.asarray(state.base_pure).all())
    no_change = jnp.asarray(np.zeros((V, 2), bool))
    ref = sel.collapse(state, sel_bank, params.select, no_change,
                       params.select, params)
    got = sel.materialize_base(state, sel_bank)
    for name in type(state).__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    with pytest.raises(ValueError, match="span-only"):
        cas.materialize_base(state, sel_bank)


@pytest.mark.parametrize("voices,want", [
    (16, "reduce"), (128, "reduce"), (256, "dot"), (1024, "dot"),
    (2048, "dot"),
])
def test_tail_mac_auto_threshold(voices, want):
    """tail_mac='auto' takes the dot form from Vg*I = 32 rows (256 voices
    at ratio 16) up, where the H100 A/B measured it faster at every
    count (PERF.md); smaller groups keep the reduce form."""
    assert CascadeConvolution.TAIL_DOT_MIN_ROWS == 32
    eng = CascadeConvolution(voices, 256, 64, ratio=16, num_irs=2)
    assert eng.tail_mac == want


def test_with_voices_keeps_transform_backends_and_knobs(monkeypatch):
    """Clones must re-resolve the REQUESTED backend per transform size,
    never inherit the head's resolved one: propagating a 'matmul' head
    (n=512) would force the n=8192 tail transform onto dense [n, F] DFT
    matrices — 4 x 134 MB HLO constants in every offline-bounce step
    (CLAUDE.md landmine 8 family). The auto table is patched to differ
    per size so the test can tell. tail_mac keeps its requested value
    too: 'auto' re-resolves at the clone's voice count, an explicit form
    propagates."""
    from tpu_audio.ops import fft

    monkeypatch.setattr(fft, "AUTO_BACKENDS", {512: "matmul", 8192: "split"})
    eng = CascadeConvolution(16, 256, 64, ratio=16, num_irs=2)
    assert eng.xf1.backend == "matmul"          # n=512
    assert eng.xf2.backend == "split"           # n=8192
    clone = eng.with_voices(128)
    assert clone.xf2.backend == "split"
    assert clone.xf1 is eng.xf1 and clone.xf2 is eng.xf2
    # 'auto' tail_mac re-resolves at the clone's Vg rows (Vg*I =
    # voices/16 * 2 against TAIL_DOT_MIN_ROWS)
    rows = CascadeConvolution.TAIL_DOT_MIN_ROWS
    for v in (128, 2048):
        assert eng.with_voices(v).tail_mac == (
            "dot" if v // 16 * 2 >= rows else "reduce")
    forced = CascadeConvolution(16, 256, 64, ratio=16, num_irs=2,
                                tail_mac="reduce")
    assert forced.with_voices(2048).tail_mac == "reduce"
