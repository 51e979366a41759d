"""chip_smoke.py off the card: it refuses to report success without a GPU,
and its float64 reference agrees with the engines on a tiny CPU run."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_smoke(args, cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [[], ["--multi-gpu"]])
def test_smoke_fails_without_a_gpu_and_prints_no_result(args):
    r = run_smoke(args, REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_smoke_alone_without_the_program_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = run_smoke([], tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase", ["serve_fmajor", "serve_cascade"])
def test_reference_agrees_with_a_tiny_engine_run(phase, tmp_path):
    """The phases' own comparison, at 4 voices and 50 ms IRs on the CPU:
    the float64 reference must agree with the streamed engine output
    across the re-select (prefix and settled window)."""
    if phase == "serve_fmajor":
        err = cs.phase_serve_fmajor(str(tmp_path), 0, voices=4, blocks=110,
                                    event=12, ir_seconds=0.05)
    else:
        err = cs.phase_serve_cascade(0, voices=4, blocks=110, event=10,
                                     ratio=2, ir_seconds=0.05)
    assert 0.0 <= err < cs.GOLDEN_TOL


def test_golden_mix_with_a_unit_impulse():
    """With a unit-impulse IR the reference reduces to the closed form:
    wet * delayed input (clipped) plus dry input, per pan law."""
    n = 64
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n)) * 0.1
    delta = np.zeros((2, 8), np.float32)
    delta[:, 0] = 1.0
    g = cs.Golden(x, [delta], n)
    out = g.voice(select=(0, 0), predelay=3, wet=(0.5, 0.5),
                  dry=(0.25, 0.25))
    wet = np.zeros((2, n))
    wet[:, 3:] = 0.5 * (x[0] + x[1])[:n - 3]
    want = np.clip(wet, -1, 1) + 0.25 * (x[0] + x[1])
    np.testing.assert_allclose(out, want, atol=1e-12)


@pytest.mark.parametrize("pan", [-0.5, 0.0, 0.7])
def test_golden_pan_law_matches_the_engines(pan):
    from tpu_audio.ops.mix import pan_gains

    gl, gr = pan_gains(np.float32(pan))
    np.testing.assert_allclose(cs.Golden.pan(pan), (float(gl), float(gr)),
                               atol=1e-7)


def test_crossfade_settle_follows_the_engine_recursion():
    n = cs.crossfade_settle_blocks(8)
    # the engines' slew of the outgoing weight: a *= 1 - 1/(vsteps + 5)
    a, vsteps = 1.0, 8.0
    for _ in range(n):
        a *= 1.0 - 1.0 / (vsteps + 5.0)
        vsteps = max(vsteps - 1.0, 0.0)
    assert a < 1e-7
    assert cs.crossfade_settle_blocks(8, floor=1e-3) < n
    assert cs.crossfade_settle_blocks(16) > n


def test_check_golden_rejects_a_wrong_output():
    n = 40 * cs.BLOCK
    x = np.random.default_rng(1).standard_normal((2, n)) * 0.05
    ir = np.zeros((2, 4), np.float32)
    ir[:, 0] = 1.0
    g = cs.Golden(x, [ir], n)
    params = dict(select=(0, 0), predelay=0, wet=(0.5, 0.5), dry=(0.1, 0.1))
    good = g.voice(**params)
    assert cs.check_golden("t", g, {0: good}, {0: params}, {0: params},
                           5, 20, 40) < 1e-12
    bad = good.copy()
    bad[1, 30 * cs.BLOCK] += 0.01
    with pytest.raises(cs.SmokeFailure, match="golden error"):
        cs.check_golden("t", g, {0: bad}, {0: params}, {0: params}, 5, 20, 40)


def test_watchdog_is_armed_inside_the_time_limit_and_cancelled(monkeypatch):
    """A hung phase must fail the run before a 1200 s caller limit; an
    in-process call must not leave the watchdog armed."""
    calls = []
    monkeypatch.setattr(cs.faulthandler, "dump_traceback_later",
                        lambda t, exit=False: calls.append(("arm", t, exit)))
    monkeypatch.setattr(cs.faulthandler, "cancel_dump_traceback_later",
                        lambda: calls.append(("cancel",)))
    from tpu_audio.utils import compile_cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    assert cs.main([]) == 1                  # the CPU is not a GPU
    assert calls == [("arm", cs.WATCHDOG_S, True), ("cancel",)]
    assert cs.WATCHDOG_S < 1200
