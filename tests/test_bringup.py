"""Start-up rules: where the compile cache lives, how the native host
library is named, and which devices each multihost worker gets."""

import os
from pathlib import Path

import pytest


def test_compile_cache_honours_env_else_checkout(monkeypatch):
    from spacedust_tpu.utils import jaxconf
    repo = Path(__file__).resolve().parent.parent
    assert jaxconf.CACHE_DIR == repo / ".jax_cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxconf.cache_dir() == str(repo / ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert jaxconf.cache_dir() == "/elsewhere/cache"


def test_compile_cache_is_ignored_by_git():
    repo = Path(__file__).resolve().parent.parent
    ignored = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_native_library_name_keys_flags_and_cpu(monkeypatch):
    from spacedust_tpu import native
    base = native.library_path()
    monkeypatch.setattr(native, "_cpu_features", lambda: b"flags : fpu sse2")
    other_cpu = native.library_path()
    monkeypatch.setattr(native, "_flags", lambda san: ["-O2"])
    other_flags = native.library_path()
    assert len({base, other_cpu, other_flags}) == 3
    assert native.library_path(sanitize=True).name.endswith("_asan.so")


def test_multihost_workers_get_disjoint_cards():
    from spacedust_tpu.parallel.multihost import worker_env
    base = {"PATH": "/bin"}
    envs = [worker_env(base, r, 2, 2, 1234) for r in range(2)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0,1", "2,3"]
    assert all("XLA_FLAGS" not in e for e in envs)
    assert envs[1]["SPACEDUST_PROC_ID"] == "1"
    assert envs[0]["SPACEDUST_COORDINATOR"] == "127.0.0.1:1234"
    sub = worker_env({"CUDA_VISIBLE_DEVICES": "4,5,6,7"}, 1, 2, 2, 1)
    assert sub["CUDA_VISIBLE_DEVICES"] == "6,7"
    with pytest.raises(RuntimeError):
        worker_env({"CUDA_VISIBLE_DEVICES": "0,1"}, 1, 2, 2, 1)


def test_multihost_cpu_workers_keep_virtual_devices():
    from spacedust_tpu.parallel.multihost import worker_env
    env = worker_env({"JAX_PLATFORMS": "cpu"}, 0, 2, 4, 1)
    assert "device_count=4" in env["XLA_FLAGS"]
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
