"""base/backend.py: the one place that knows the platform, interpret
mode, the compile cache and the accelerator choice."""

import os

import jax
import pytest

from lucille_tpu.base import backend


def _as_platform(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)


def test_suite_runs_on_cpu():
    assert backend.platform() == "cpu"


@pytest.mark.parametrize("name,interp", [("cpu", True), ("gpu", False)])
def test_interpret_only_on_cpu(monkeypatch, name, interp):
    _as_platform(monkeypatch, name)
    assert backend.interpret() is interp


@pytest.mark.parametrize("name", ["neuron", "rocm", "METAL"])
def test_unknown_platform_raises(monkeypatch, name):
    _as_platform(monkeypatch, name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()
    with pytest.raises(RuntimeError):
        backend.interpret()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)
    _as_platform(monkeypatch, "gpu")
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert backend.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    _as_platform(monkeypatch, "gpu")
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert backend.enable_compile_cache() == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir",
                      os.path.join(repo, ".jax_cache"))]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_keeps_no_compile_cache(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert backend.enable_compile_cache() is None
    assert calls == []


@pytest.mark.parametrize(
    "name,method,n_tris,want",
    [
        ("cpu", "auto", 100, "mxu"),
        ("cpu", "auto", 10**6, "mxu"),
        ("gpu", "auto", 1796, "pallas"),
        ("gpu", "auto", backend.AUTO_DENSE_MAX_TRIS, "pallas"),
        ("gpu", "auto", backend.AUTO_DENSE_MAX_TRIS + 1, "pbvh"),
        ("gpu", "bvh", 100, "pbvh"),
        ("cpu", "bvh", 100, "pbvh"),
        ("gpu", "grid", 100, "ugrid"),
        ("gpu", "mxu", 100, "mxu"),
        ("gpu", "pallas", 10**6, "pallas"),
        ("gpu", "bruteforce", 100, "bruteforce"),
    ],
)
def test_choose_accel(monkeypatch, name, method, n_tris, want):
    _as_platform(monkeypatch, name)
    assert backend.choose_accel(method, n_tris) == want
