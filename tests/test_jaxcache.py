"""The persistent compile cache's directory rules."""

import pytest

from raytracer_tpu.utils import jaxcache


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/tmp/elsewhere"}, "/tmp/elsewhere"),
    ({}, jaxcache.DEFAULT_DIR),
    ({"RAYTRACER_TPU_CACHE": "off",
      "JAX_COMPILATION_CACHE_DIR": "/tmp/elsewhere"}, None),
])
def test_cache_dir_rules(monkeypatch, env, want):
    """JAX_COMPILATION_CACHE_DIR wins when set, else the fixed in-checkout
    directory; 'off' disables the cache either way."""
    for k in ("JAX_COMPILATION_CACHE_DIR", "RAYTRACER_TPU_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert jaxcache.cache_dir() == want


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_sets_only_the_chosen_dir(monkeypatch, tmp_path, env_dir):
    """With the env var set, nothing here names a directory (JAX reads the
    variable itself); unset, the fixed in-checkout directory is created
    and configured."""
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("RAYTRACER_TPU_CACHE", raising=False)
    default = str(tmp_path / "cache")
    monkeypatch.setattr(jaxcache, "DEFAULT_DIR", default)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        assert jaxcache.enable_persistent_cache() == str(tmp_path / "env")
        assert "jax_compilation_cache_dir" not in calls
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jaxcache.enable_persistent_cache() == default
        assert calls["jax_compilation_cache_dir"] == default
        assert (tmp_path / "cache").is_dir()


def test_default_dir_is_in_the_checkout_and_ignored():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(jaxcache.DEFAULT_DIR) == repo
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
