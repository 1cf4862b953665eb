"""Picking + autofocus: ray through the viewport center vs. the scene.

One jitted device function replaces the reference's entire CPU mirror
(src/glsl.rs:43-82 Sphere::hit + 213-239 get_center_hit): we reuse
:func:`raytracer_tpu.render.tracer.hit_world` — the same code that renders —
so host and device can never disagree about what is under the cursor.

Semantics preserved from the reference:
- the center ray has no lens offset (src/glsl.rs:216-220),
- t_min is 0.0, not the render epsilon (src/glsl.rs:226),
- autofocus only applies when aperture > 0; a miss resets focus to 10
  (src/state.rs:453-469),
- no selection is NO_SELECTED_OBJECT_ID = 1000 (src/state.rs:12).
"""

from __future__ import annotations


from raytracer_tpu.core import pytree
import jax
import jax.numpy as jnp

from raytracer_tpu.camera.camera import CameraConfig, center_ray, derive_camera
from raytracer_tpu.core import vec
from raytracer_tpu.render.options import MAX_T
from raytracer_tpu.render.tracer import hit_world
from raytracer_tpu.scene.spheres import NO_SELECTED_OBJECT_ID, Scene


@pytree.dataclass
class CenterHit:
    """Result of the center-of-view pick (mirror of HitResultData,
    src/glsl.rs:96-103, plus the derived focus data)."""

    hit: jnp.ndarray  # () bool
    t: jnp.ndarray  # ()
    point: jnp.ndarray  # (3,)
    uuid: jnp.ndarray  # () int32 — NO_SELECTED_OBJECT_ID on miss
    distance: jnp.ndarray  # () — |point - camera origin| (src/state.rs:455)


@jax.jit
def center_hit(scene: Scene, camera: CameraConfig) -> CenterHit:
    """Cast the viewport-center ray and return the closest hit."""
    dcam = derive_camera(camera)
    ray = center_ray(dcam)
    rec = hit_world(
        ray.origin[None, :], ray.direction[None, :], scene, t_min=0.0, t_max=MAX_T
    )
    hit = rec.hit[0]
    point = jnp.where(hit, rec.point[0], jnp.zeros(3, rec.point.dtype))
    uuid = jnp.where(hit, rec.uuid[0], NO_SELECTED_OBJECT_ID).astype(jnp.int32)
    distance = vec.length(point - dcam.origin)
    return CenterHit(hit=hit, t=rec.t[0], point=point, uuid=uuid, distance=distance)


def update_cursor_state(scene: Scene, camera: CameraConfig):
    """update_cursor_position_in_world (src/state.rs:453-471) as a pure
    function: returns (new_camera, cursor_point (3,), selected_object i32).

    Autofocus mutates only focus_distance, and only when aperture > 0.
    """
    ch = center_hit(scene, camera)
    aperture_open = camera.aperture > 0.0
    new_focus = jnp.where(
        aperture_open,
        jnp.where(ch.hit, ch.distance, jnp.asarray(10.0, jnp.float32)),
        camera.focus_distance,
    )
    return camera.replace(focus_distance=new_focus), ch.point, ch.uuid
