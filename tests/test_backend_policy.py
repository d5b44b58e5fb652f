"""The run-wide backend policy: route, f64 matmuls, precision, cache."""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from zeldovich.ops import mmfft, ozaki
from zeldovich.utils import backend


@pytest.fixture(params=["cpu", "gpu"])
def on_backend(request, monkeypatch):
    """Run the test as if jax's default backend were ``request.param``."""
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


@pytest.mark.parametrize(
    "dtype_name,pair,want",
    [
        ("float64", False, False),
        ("float32", False, False),
        ("df64", False, True),
        ("float64", True, True),
    ],
)
def test_pair_route_choice(on_backend, dtype_name, pair, want):
    """Only --pair and df64 take the real-pair route, on every backend."""
    assert backend.use_pair_route(dtype_name, pair) is want


def test_ozaki_off_by_default(on_backend, monkeypatch):
    monkeypatch.delenv("ZT_OZAKI", raising=False)
    assert not ozaki.use_ozaki(jnp.float64)


def test_ozaki_knob(on_backend, monkeypatch):
    monkeypatch.setenv("ZT_OZAKI", "1")
    assert ozaki.use_ozaki(jnp.float64)
    assert not ozaki.use_ozaki(jnp.float32)


def test_precision_default_highest(on_backend, monkeypatch):
    """f32 dots never fall to TF32 unless asked for."""
    monkeypatch.delenv("ZT_FFT_PRECISION", raising=False)
    assert mmfft.precision_name() == "highest"
    assert mmfft._resolve_precision(None) == jax.lax.Precision.HIGHEST


def test_precision_knob(on_backend, monkeypatch):
    monkeypatch.setenv("ZT_FFT_PRECISION", "high")
    assert mmfft._resolve_precision(None) == jax.lax.Precision.HIGH
    explicit = jax.lax.Precision.DEFAULT
    assert mmfft._resolve_precision(explicit) == explicit


@pytest.fixture
def cache_config():
    """Restore jax's cache settings after a test changes them."""
    saved = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_dir_from_environment(monkeypatch, cache_config, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as it is; no other dir is set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.enable_compilation_cache.__wrapped__() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = backend.enable_compilation_cache.__wrapped__()
    assert Path(d) == backend.CHECKOUT / ".jax_cache"
    assert Path(d).is_dir()
    assert jax.config.jax_compilation_cache_dir == d
    assert (backend.CHECKOUT / "zeldovich" / "cli.py").is_file()


def test_cache_dir_never_temporary(monkeypatch, cache_config, tmp_path):
    """The default does not follow TMPDIR or HOME: a per-run temporary
    directory would hold entries no later run's cache finds again."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    d = Path(backend.enable_compilation_cache.__wrapped__())
    assert d == backend.DEFAULT_CACHE_DIR
    assert not d.is_relative_to(tmp_path)
