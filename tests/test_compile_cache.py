"""Persistent-compile-cache helper: where the cache goes, and idempotence.

Rules (utils/compile_cache.py): ``JAX_COMPILATION_CACHE_DIR`` set -> JAX
uses it and nothing else is set; unset -> the fixed ``.jax_cache`` inside
the checkout; never on the CPU backend (jax 0.9's XLA:CPU executable
serialization segfaulted full-suite runs).
"""
from pathlib import Path

import pytest

from probabilistic_point_clouds_registration_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def clean_cache_config():
    import jax

    prev = jax.config.jax_compilation_cache_dir
    prev_flag = compile_cache._enabled
    compile_cache._enabled = False
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        yield jax
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        compile_cache._enabled = prev_flag


@pytest.mark.parametrize(
    "platform, env, expected",
    [
        ("gpu", None, REPO / ".jax_cache"),
        ("gpu", "/somewhere/else", None),
        ("cpu", None, None),
        ("cpu", "/somewhere/else", None),
    ],
)
def test_cache_dir_rules(monkeypatch, platform, env, expected):
    if env is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
    assert compile_cache.cache_dir(platform) == expected


def test_default_dir_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "/.jax_cache/" in ignored
    assert compile_cache.DEFAULT_DIR == REPO / ".jax_cache"


def test_enable_on_gpu_backend(monkeypatch, clean_cache_config):
    jax = clean_cache_config
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    made = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        Path, "mkdir", lambda self, **kw: made.append(self)
    )
    assert compile_cache.enable_persistent_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert made == [REPO / ".jax_cache"]
    assert compile_cache.enable_persistent_compilation_cache()  # idempotent


def test_env_var_sets_nothing(monkeypatch, clean_cache_config):
    jax = clean_cache_config
    monkeypatch.setenv(compile_cache.ENV_VAR, "/somewhere/else")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not compile_cache.enable_persistent_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None


def test_disabled_on_cpu_backend(monkeypatch, clean_cache_config):
    """This suite runs on the CPU backend — enable must refuse and leave
    the config unset."""
    jax = clean_cache_config
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert jax.default_backend() == "cpu"
    assert not compile_cache.enable_persistent_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None
