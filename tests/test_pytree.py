"""Every state pytree flattens and unflattens to an equal value, keeps its
static fields out of the leaves, and supports ``.replace``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera.camera import CameraConfig, derive_camera
from raytracer_tpu.core.ray import Ray
from raytracer_tpu.interact.picking import center_hit
from raytracer_tpu.progressive.state import init_render_state
from raytracer_tpu.render.options import DebugParams
from raytracer_tpu.scene import presets
from raytracer_tpu.scene.accel import build_clustered, build_grid_clustered


def _make(name):
    scene, cam, *_ = presets.get_config("cover", 32, 16)
    return {
        "Ray": lambda: Ray(origin=jnp.zeros((4, 3)), direction=jnp.ones((4, 3))),
        "CameraConfig": lambda: CameraConfig.create(),
        "DerivedCamera": lambda: derive_camera(CameraConfig.create()),
        "Scene": lambda: scene,
        "ClusteredScene": lambda: build_clustered(scene),
        "GridClusteredScene": lambda: build_grid_clustered(scene),
        "RenderState": lambda: init_render_state(8, 4),
        "DebugParams": DebugParams.none,
        "CenterHit": lambda: center_hit(scene, cam),
    }[name]()


@pytest.mark.parametrize("name", [
    "Ray", "CameraConfig", "DerivedCamera", "Scene", "ClusteredScene",
    "GridClusteredScene", "RenderState", "DebugParams", "CenterHit",
])
def test_flatten_unflatten_round_trip(name):
    obj = _make(name)
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert all(hasattr(x, "shape") for x in leaves)  # no static leaves
    # doubled through a jit boundary, structure intact
    out = jax.jit(lambda t: jax.tree_util.tree_map(lambda x: x, t))(obj)
    assert jax.tree_util.tree_structure(out) == treedef
    first = next(iter(obj.__dataclass_fields__))
    assert getattr(obj.replace(**{first: getattr(obj, first)}), first) is (
        getattr(obj, first)
    )
