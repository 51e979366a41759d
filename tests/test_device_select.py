"""utils/device.select_device and utils/compile_cache: which device the
app runs on, and where every entry point keeps its compilation cache."""

import importlib
import os
import pathlib
import types

import pytest

from tpu_audio.utils import compile_cache
from tpu_audio.utils import device as device_mod

REPO = pathlib.Path(__file__).resolve().parent.parent


def fake_devices(platform, n=1):
    return [types.SimpleNamespace(platform=platform, id=i,
                                  device_kind=f"{platform} kind",
                                  process_index=0) for i in range(n)]


@pytest.fixture
def platform(monkeypatch):
    """Set what jax.devices() returns and what was requested."""
    def set_(platform, requested, n=1):
        monkeypatch.setattr(device_mod.jax, "devices",
                            lambda: fake_devices(platform, n))
        monkeypatch.setattr(device_mod, "requested_platforms",
                            lambda raw=None: list(requested))
    return set_


@pytest.mark.parametrize("requested", [[], ["gpu"], ["cuda"], ["cuda", "cpu"]])
def test_select_device_takes_the_gpu(platform, requested):
    platform("gpu", requested, n=2)
    dev = device_mod.select_device(verbose=False)
    assert dev.platform == "gpu" and dev.id == 0


def test_select_device_refuses_an_unrequested_cpu(platform):
    platform("cpu", [])
    with pytest.raises(RuntimeError, match="no GPU found"):
        device_mod.select_device(verbose=False)


@pytest.mark.parametrize("requested", [["cpu"], ["cuda", "cpu"]])
def test_select_device_runs_on_the_cpu_only_on_request(platform, requested):
    platform("cpu", requested)
    if "cuda" in requested:
        # a GPU was asked for first and the CPU came up: still loud
        with pytest.raises(RuntimeError, match="GPU requested"):
            device_mod.select_device(verbose=False)
    else:
        assert device_mod.select_device(verbose=False).platform == "cpu"


def test_select_device_reports_a_missing_gpu_backend(monkeypatch):
    def no_backend():
        raise RuntimeError("Unknown backend: 'cuda' requested")
    monkeypatch.setattr(device_mod.jax, "devices", no_backend)
    monkeypatch.setattr(device_mod, "requested_platforms",
                        lambda raw=None: ["cuda"])
    with pytest.raises(RuntimeError, match="no usable device.*cuda"):
        device_mod.select_device(verbose=False)


def test_select_device_logs_the_device_table(platform, capfd):
    from tpu_audio.utils.log import Log

    platform("gpu", [], n=2)
    old = Log.level
    Log.level = 3
    try:
        device_mod.select_device(verbose=True)
    finally:
        Log.level = old
    err = capfd.readouterr()
    text = err.out + err.err
    assert "2 device(s)" in text and "gpu kind" in text


@pytest.mark.parametrize("raw,want", [
    ("cpu", ["cpu"]),
    ("cuda,cpu", ["cuda", "cpu"]),
    (" GPU ", ["gpu"]),
    ("", []),
])
def test_requested_platforms_parses_the_request(raw, want):
    assert device_mod.requested_platforms(raw) == want


def test_requested_platforms_reads_the_test_config():
    # the suite forces the CPU through the config (tests/conftest.py)
    assert device_mod.requested_platforms() == ["cpu"]


def test_app_exits_2_when_no_device_qualifies(monkeypatch, tmp_path):
    app_main = importlib.import_module("tpu_audio.app.main")

    def refuse(verbose=True):
        raise RuntimeError("no GPU found")
    monkeypatch.setattr(app_main, "select_device", refuse)
    rc = app_main.main(["--settings", str(tmp_path / "missing.txt"),
                        "--quiet"])
    assert rc == 2


# -- compile cache -------------------------------------------------------------


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (the real
    cache latches process-wide on first use)."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_cache_env_var_wins_and_nothing_else_is_set(monkeypatch,
                                                    config_updates, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert not [k for k, _ in config_updates
                if k == "jax_compilation_cache_dir"]


def test_cache_defaults_to_one_fixed_path_in_the_checkout(monkeypatch,
                                                          config_updates):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(REPO / ".jax_cache") == compile_cache.DEFAULT_DIR
    assert ("jax_compilation_cache_dir", got) in config_updates
    # the same path every time, never a temporary, per-process name
    assert compile_cache.enable_compile_cache() == got
    assert str(os.getpid()) not in got and "tmp" not in got.lower()


def test_cache_dir_is_ignored_by_git():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_bench_child_uses_the_cache_helper(monkeypatch, config_updates):
    import argparse

    import bench

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    bench._configure_xla_cache(argparse.Namespace(platform=None))
    assert ("jax_compilation_cache_dir",
            compile_cache.DEFAULT_DIR) in config_updates


def test_app_uses_the_cache_helper(monkeypatch, tmp_path):
    app_main = importlib.import_module("tpu_audio.app.main")

    used = []
    monkeypatch.setattr(app_main, "enable_compile_cache",
                        lambda: used.append(True))
    app_main.main(["--settings", str(tmp_path / "missing.txt"), "--quiet"])
    assert used == [True]


@pytest.mark.parametrize("entry", [
    "bench.py", "chip_smoke.py", "examples/soak.py",
    "examples/probe_bringup.py", "tpu_audio/app/main.py",
])
def test_entry_points_take_the_cache_from_the_helper(entry):
    src = (REPO / entry).read_text()
    assert "enable_compile_cache" in src
    assert "jax_compilation_cache_dir" not in src


def test_no_other_code_sets_a_cache_directory():
    offenders = []
    for path in list(REPO.glob("*.py")) + list(REPO.glob("tpu_audio/**/*.py")) \
            + list(REPO.glob("benchlib/*.py")) + list(REPO.glob("examples/*.py")):
        if path.name == "compile_cache.py":
            continue
        if "jax_compilation_cache_dir" in path.read_text():
            offenders.append(str(path.relative_to(REPO)))
    assert not offenders


def test_ring_producer_never_initialises_a_jax_backend():
    """The live path's producer process (tests/test_live_path.py) imports
    the native ring and nothing that touches a device: one JAX process per
    card stays the app's."""
    import subprocess
    import sys

    code = ("from tpu_audio.runtime.native import NativeRing\n"
            "import jax._src.xla_bridge as xb\n"
            "print(sorted(xb._backends))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
