"""Where the persistent compilation cache goes (helm_tpu/compile_cache.py)."""

import os
import subprocess
import sys

import jax
import pytest

from helm_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir", "jax_enable_compilation_cache")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_outside_dir_is_honoured_and_written(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no other path, and
    a compiled executable lands in that directory."""
    outside = tmp_path / "outside"
    env = {k: v for k, v in os.environ.items() if k != "HELM_TPU_COMPILE_CACHE"}
    env["JAX_COMPILATION_CACHE_DIR"] = str(outside)
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from helm_tpu.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(outside), str(outside)]
    assert any(outside.iterdir())


def test_default_dir_is_repo_jax_cache(monkeypatch, tmp_path,
                                       restore_cache_config):
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("HELM_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "c"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def test_empty_setting_turns_the_cache_off(monkeypatch, restore_cache_config):
    monkeypatch.setenv("HELM_TPU_COMPILE_CACHE", "")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/dir")
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_enable_compilation_cache is False
