"""Tests for the unified render entry point (render/api.py): input
validation and backend resolution per platform."""

import jax
import numpy as np
import pytest

from raytracer_tpu.render import api
from raytracer_tpu.render.api import render_image, resolve_backend
from raytracer_tpu.render.options import TraceOptions
from raytracer_tpu.scene import presets


def test_spp_zero_raises():
    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    with pytest.raises(ValueError, match="spp"):
        render_image(scene, cam, 32, 16, 0, jax.random.PRNGKey(0))


def test_step_fn_spp_zero_raises():
    from raytracer_tpu.progressive.step import make_step_fn

    with pytest.raises(ValueError, match="spp"):
        make_step_fn(32, 16, spp=0)


def test_resolve_backend_cpu():
    # tests run on the CPU backend: auto must resolve to jnp there
    assert resolve_backend("auto") == "jnp"
    assert resolve_backend("pallas") == "pallas"
    assert resolve_backend("jnp") == "jnp"


@pytest.mark.parametrize("platform,backend,interpret", [
    ("cpu", "jnp", True),
    ("gpu", "pallas", False),
    ("rocm", None, None),
])
def test_backend_and_interpret_rule_per_platform(monkeypatch, platform,
                                                 backend, interpret):
    """'auto' is fixed per platform (the kernel on the GPU, jnp on the
    CPU); Pallas interprets only on the CPU; any other platform raises
    instead of silently interpreting or falling back."""
    from raytracer_tpu.render import pallas_kernel as pk

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resolve_backend("jnp") == "jnp"
    if backend is None:
        with pytest.raises(ValueError, match=platform):
            resolve_backend("auto")
        with pytest.raises(ValueError, match=platform):
            pk.interpret_mode()
    else:
        assert resolve_backend("auto") == backend
        assert pk.interpret_mode() is interpret


def test_jnp_render_is_one_program(key):
    """The jnp path renders in ONE jitted call per static configuration
    (no host loop over bands or spp chunks): a repeat render reuses the
    cached executable and reproduces the image bitwise."""
    scene, cam = presets.get_config("two_sphere", 48, 32)[:2]
    opts = TraceOptions(max_depth=4, backend="jnp")
    api._jitted_jnp.cache_clear()
    a, st = render_image(scene, cam, 48, 32, 5, key, opts, return_stats=True)
    b = render_image(scene, cam, 48, 32, 5, key, opts)
    assert api._jitted_jnp.cache_info().currsize == 1
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(st["segments"]) >= 48 * 32 * 5
