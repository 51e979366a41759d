import io
import sys

import numpy as np

from tpu_audio.utils.log import Log
from tpu_audio.utils.profiling import BlockTimer


def test_log_levels(capsys):
    old = Log.level
    try:
        Log.level = 3
        Log.force_color = False
        Log.info("t", "hello %d", 42)
        Log.warn("t", "warn %s", "x")
        Log.error("t", "bad")
        Log.newline("cont")
        out = capsys.readouterr()
        assert "hello 42" in out.out
        assert "[t]" in out.out
        assert "warn x" in out.err
        assert "bad" in out.err
        assert "cont" in out.out
        Log.level = 0
        Log.info("t", "silent")
        out = capsys.readouterr()
        assert out.out == ""
    finally:
        Log.level = old
        Log.force_color = None


def test_block_timer_warmup_discard():
    """First `warmup` blocks are excluded from stats (reference conv.h:80)."""
    t = BlockTimer(warmup=3, deadline_s=0.01)
    for i in range(3):
        t.record(100.0)  # huge warmup outliers must be ignored
    for i in range(10):
        t.record(0.001)
    assert t.count == 10
    assert abs(t.avg_runtime() - 0.001) < 1e-9
    assert t.missed == 0


def test_block_timer_deadline_and_percentiles():
    t = BlockTimer(warmup=0, deadline_s=0.005)
    for v in [0.001] * 98 + [0.004, 0.02]:
        t.record(v)
    assert t.missed == 1
    assert t.percentile(50) == 0.001
    assert t.percentile(99) == 0.004
    s = t.summary(block_period_s=256 / 44100)
    assert s["missed_deadlines"] == 1
    assert s["rtf"] > 1


def test_block_timer_start_stop():
    t = BlockTimer(warmup=0)
    t.start()
    elapsed = t.stop()
    assert elapsed >= 0
    assert t.count == 1


def test_wire_pcm16_roundtrip_within_one_lsb():
    """The shared host-link wire codec (used by StreamSession, bench, and
    the offline bounce) round-trips within HALF a PCM16 LSB
    (round-to-nearest) and clips out-of-range samples."""
    import jax
    import numpy as np

    from tpu_audio.utils.wire import decode_pcm16, encode_pcm16

    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, (3, 2, 64)).astype(np.float32)
    enc = np.asarray(jax.jit(encode_pcm16)(x))
    assert enc.dtype == np.int16
    got = decode_pcm16(enc)
    np.testing.assert_allclose(got, np.clip(x, -1, 1), atol=0.51 / 32767.0)


def test_engine_package_exports_flagship():
    from tpu_audio.engine import FMajorPartitionedConvolution  # noqa: F401


def test_diskcache_roundtrip_and_torn_entries(tmp_path):
    """utils/diskcache: atomic multi-tensor entries — manifest-gated
    loads, None fields recorded absent, torn entries are misses, and
    pre-manifest (legacy) entries load when every file exists."""
    import numpy as np
    from tpu_audio.utils import diskcache

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    diskcache.store(tmp_path, "e1", {"head": a, "tail": a * 2, "opt": None})
    got = diskcache.load(tmp_path, "e1", ["head", "tail", "opt"])
    assert got is not None
    np.testing.assert_array_equal(np.asarray(got["head"]), a)
    np.testing.assert_array_equal(np.asarray(got["tail"]), a * 2)
    assert got["opt"] is None
    # missing entry -> miss
    assert diskcache.load(tmp_path, "nope", ["head"]) is None
    # torn entry (manifest names a deleted file) -> miss, not a crash
    (tmp_path / "e1_tail.npy").unlink()
    assert diskcache.load(tmp_path, "e1", ["head", "tail"]) is None
    # legacy entry: files but no manifest -> hit when all requested exist
    np.save(tmp_path / "leg_head.npy", a)
    got = diskcache.load(tmp_path, "leg", ["head"])
    np.testing.assert_array_equal(np.asarray(got["head"]), a)
    assert diskcache.load(tmp_path, "leg", ["head", "tail"]) is None


def test_log_env_level_and_format_fallback(monkeypatch, capsys):
    from tpu_audio.utils.log import Log, _env_level

    monkeypatch.setenv("TPU_AUDIO_LOG", "debug")
    assert _env_level() == 4
    monkeypatch.setenv("TPU_AUDIO_LOG", "2")
    assert _env_level() == 2
    monkeypatch.setenv("TPU_AUDIO_LOG", "bogus")
    assert _env_level() == 3  # info default
    # a bad printf template degrades to repr, never raises mid-stream
    old_level, old_color = Log.level, Log.force_color
    Log.level, Log.force_color = 4, False
    try:
        Log.debug("t", "only %d fits", 1, 2)
        out = capsys.readouterr().out
        assert "only %d fits" in out and "(1, 2)" in out
        Log.force_color = True          # exercise the ANSI branch
        Log.debug("t", "colored %s", "msg")
        assert "\x1b[" in capsys.readouterr().out
    finally:
        Log.level, Log.force_color = old_level, old_color


def test_transfer_complex_with_explicit_sharding():
    """device_put_maybe_complex with a sharding arg: complex leaves stage
    as f32 pairs and come back complex ON THE REQUESTED SHARDING, for
    host numpy AND already-device-resident inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpu_audio.parallel.mesh import make_mesh
    from tpu_audio.utils.transfer import (device_put_maybe_complex,
                                          to_host_maybe_complex)

    mesh = make_mesh(min(2, len(jax.devices())))
    sh = NamedSharding(mesh, P("voice"))
    x = (np.arange(8, dtype=np.float32)
         + 1j * np.ones(8, np.float32)).astype(np.complex64)
    dev = device_put_maybe_complex(x, sh)
    assert dev.sharding.is_equivalent_to(sh, dev.ndim)
    np.testing.assert_array_equal(to_host_maybe_complex(dev), x)
    # device-resident complex re-placement
    dev2 = device_put_maybe_complex(dev, sh)
    np.testing.assert_array_equal(to_host_maybe_complex(dev2), x)
    # real leaves pass straight through with the sharding honored
    r = device_put_maybe_complex(np.ones(8, np.float32), sh)
    assert r.sharding.is_equivalent_to(sh, r.ndim)


def test_every_contraction_pins_explicit_precision():
    """Source audit: every contraction call in the package passes an
    explicit ``precision=``. On the GPU an f32 contraction at DEFAULT
    precision may run in TF32 (10-bit mantissa) and follows a global
    config flag, so an unannotated contraction would round the signal it
    carries and make the f32 engine disagree with itself between the
    streamed and the bounced path. The CPU suite cannot catch this
    numerically (CPU DEFAULT is f32), so enforce it at the AST level:
    einsum/matmul/tensordot/dot/vdot/inner/dot_general calls need the
    keyword, and the ``@`` operator (which cannot carry one) is banned
    outright. Pure-permutation einsums (a single operand, no products)
    are exempt."""
    import ast
    import pathlib

    names = {"einsum", "matmul", "tensordot", "dot", "vdot", "inner",
             "dot_general"}
    root = pathlib.Path(__file__).resolve().parent.parent / "tpu_audio"
    offenders = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                offenders.append(f"{rel}:{node.lineno} (@ operator — "
                                 "use jnp.matmul(..., precision=...))")
                continue
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in names):
                continue
            # single-operand einsum = pure permutation (no products)
            if node.func.attr == "einsum" and len(node.args) == 2:
                continue
            if not any(kw.arg == "precision" for kw in node.keywords):
                offenders.append(f"{rel}:{node.lineno} ({node.func.attr})")
    assert not offenders, (
        "contractions without an explicit precision= (DEFAULT may be "
        f"TF32 on the GPU — see CLAUDE.md): {offenders}")
