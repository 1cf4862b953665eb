"""Camera model: primitives → derived basis → per-pixel ray generation.

``CameraConfig`` holds the *primitive* camera parameters the user controls
(src/state.rs:38-50: origin, yaw, pitch, fov, aperture, focus_distance);
:func:`derive_camera` is ``State::update_pipeline`` (src/state.rs:319-347)
re-expressed as a pure function producing the viewport basis the kernel
consumes (the 8 derived uniforms of static/shader.frag:88-99);
:func:`generate_rays` is the vectorized ``get_ray_from_camera``
(static/shader.frag:342-351) over the whole pixel grid at once.

All fields are traced values, so camera motion NEVER recompiles the render —
only resolution/spp/depth changes do (they are static shapes/bounds).
"""

from __future__ import annotations

import math

from raytracer_tpu.core import pytree
import jax
import jax.numpy as jnp

from raytracer_tpu.core import sampling, vec
from raytracer_tpu.core.ray import Ray

# Clamps from the reference (src/state.rs:349-358).
FOV_MIN = 0.0001
FOV_MAX = math.pi * 0.75
PITCH_LIMIT_DEG = 89.0


@pytree.dataclass
class CameraConfig:
    """Primitive camera state. yaw/pitch in degrees (reference convention,
    src/state.rs:108-113), fov in radians (src/state.rs:43-44)."""

    origin: jnp.ndarray  # (3,)
    yaw: jnp.ndarray  # degrees; -90 looks down -z
    pitch: jnp.ndarray  # degrees, clamped ±89 by the controller
    fov: jnp.ndarray  # radians, clamped (1e-4, 0.75π) by the controller
    aperture: jnp.ndarray
    focus_distance: jnp.ndarray
    aspect_ratio: jnp.ndarray  # width / height
    vup: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.array([0.0, 1.0, 0.0], jnp.float32)
    )

    @classmethod
    def create(
        cls,
        origin=(0.0, 0.0, 0.0),
        yaw=-90.0,
        pitch=0.0,
        fov=math.pi / 3.0,
        aperture=0.0,
        focus_distance=1.0,
        aspect_ratio=16.0 / 9.0,
        vup=(0.0, 1.0, 0.0),
    ) -> "CameraConfig":
        """Build from python scalars/tuples, converting to f32 arrays.

        (Conversion lives here, not in ``__post_init__``, because pytree
        unflattening re-invokes the constructor with arbitrary leaves.)
        """
        f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
        return cls(
            origin=f32(origin),
            yaw=f32(yaw),
            pitch=f32(pitch),
            fov=f32(fov),
            aperture=f32(aperture),
            focus_distance=f32(focus_distance),
            aspect_ratio=f32(aspect_ratio),
            vup=f32(vup),
        )


@pytree.dataclass
class DerivedCamera:
    """The derived viewport basis — the kernel's camera ABI, matching the
    uniforms u_camera_origin/u_horizontal/u_vertical/u_lower_left_corner/
    u_lens_radius/u_u/u_v/u_w (static/shader.frag:88-99)."""

    origin: jnp.ndarray  # (3,)
    lower_left_corner: jnp.ndarray  # (3,)
    horizontal: jnp.ndarray  # (3,)
    vertical: jnp.ndarray  # (3,)
    u: jnp.ndarray  # (3,)
    v: jnp.ndarray  # (3,)
    w: jnp.ndarray  # (3,)
    lens_radius: jnp.ndarray
    front: jnp.ndarray  # (3,) camera_front — used by the fly-cam controller


def camera_front(yaw, pitch):
    """front = (cos(yaw)cos(pitch), sin(pitch), sin(yaw)cos(pitch)),
    yaw/pitch in degrees (src/state.rs:325-329)."""
    yaw_r = vec.degrees_to_radians(yaw)
    pitch_r = vec.degrees_to_radians(pitch)
    cp = jnp.cos(pitch_r)
    return vec.vec3(jnp.cos(yaw_r) * cp, jnp.sin(pitch_r), jnp.sin(yaw_r) * cp)


def derive_camera(cfg: CameraConfig) -> DerivedCamera:
    """Pure re-derivation of the viewport basis (src/state.rs:319-347).

    The reference mutates 10 State fields and diff-checks the whole struct to
    decide whether to reset accumulation; here derivation is pure and the
    host engine compares configs instead (raytracer_tpu.interact.appstate).
    """
    camera_h = jnp.tan(cfg.fov / 2.0)
    front = camera_front(cfg.yaw, cfg.pitch)
    # look_at = origin + front; w = normalize(origin - look_at) = -front
    w = vec.normalize(-front)
    u = vec.normalize(vec.cross(cfg.vup, w))
    v = vec.cross(w, u)
    viewport_height = 2.0 * camera_h
    viewport_width = viewport_height * cfg.aspect_ratio
    horizontal = cfg.focus_distance * viewport_width * u
    vertical = cfg.focus_distance * viewport_height * v
    lower_left = cfg.origin - horizontal / 2.0 - vertical / 2.0 - cfg.focus_distance * w
    return DerivedCamera(
        origin=cfg.origin,
        lower_left_corner=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        w=w,
        lens_radius=cfg.aperture / 2.0,
        front=front,
    )


def pixel_st_grid(width: int, height: int, dtype=jnp.float32):
    """Fragment-center viewport coordinates st ∈ (0,1)², shape (H, W, 2).

    Row 0 is the BOTTOM of the image (GL convention, like ``v_position``
    interpolated over the fullscreen quad, static/shader.frag:406-410);
    image I/O flips to scanline order at export.
    """
    xs = (jnp.arange(width, dtype=dtype) + 0.5) / width
    ys = (jnp.arange(height, dtype=dtype) + 0.5) / height
    s, t = jnp.meshgrid(xs, ys)  # (H, W)
    return jnp.stack([s, t], axis=-1)


def generate_rays(
    dcam: DerivedCamera,
    st: jnp.ndarray,
    key,
    width: int,
    height: int,
    jitter: bool = True,
    uv=None,
) -> Ray:
    """Vectorized thin-lens camera ray generation for a batch of st coords.

    Mirrors get_pixel_color's jitter (static/shader.frag:365-369: st +
    u[0,1)²/(w,h) — note the reference jitters *forward* of the fragment
    center, a quirk we preserve) and get_ray_from_camera's lens offset
    (static/shader.frag:342-351). Directions are NOT normalized, matching
    the reference; ``a = |d|²`` is handled in the intersector.

    ``uv``: optional (..., 4) uniforms [jitter_u, jitter_v, lens_u, lens_v]
    replacing the key-based draws — the stratified-sampler hook
    (TraceOptions.sampler; the mapping to jitter/disk is identical, so the
    distributions match the random path draw-for-draw).
    """
    shape = st.shape[:-1]
    kj, kl = jax.random.split(key)
    if jitter:
        j = (
            uv[..., 0:2] if uv is not None else sampling.pixel_jitter(kj, shape)
        ) / jnp.array([width, height], dtype=st.dtype)
        st = st + j
    disk = (
        sampling.disk_from_uv(uv[..., 2], uv[..., 3])
        if uv is not None
        else sampling.random_in_unit_disk(kl, shape)
    )
    rd = dcam.lens_radius * disk  # (..., 2)
    offset = rd[..., 0:1] * dcam.u + rd[..., 1:2] * dcam.v
    direction = (
        dcam.lower_left_corner
        + st[..., 0:1] * dcam.horizontal
        + st[..., 1:2] * dcam.vertical
        - dcam.origin
        - offset
    )
    return Ray(origin=jnp.broadcast_to(dcam.origin + offset, shape + (3,)),
               direction=direction)


def center_ray(dcam: DerivedCamera) -> Ray:
    """Ray through the viewport center, no lens offset — used for picking and
    autofocus (src/glsl.rs:216-220)."""
    direction = (
        dcam.lower_left_corner
        + dcam.horizontal / 2.0
        + dcam.vertical / 2.0
        - dcam.origin
    )
    return Ray(origin=dcam.origin, direction=direction)
