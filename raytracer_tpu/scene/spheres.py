"""Struct-of-arrays sphere scene pytree.

The replacement for the reference's two parallel scene
representations (host ``Vec<Sphere>`` src/glsl.rs:35-40 + device
``Sphere[15]`` uniforms static/shader.frag:55-61, 103). SoA layout means the
per-bounce closest-hit scan is a vectorized sweep over contiguous arrays —
exactly what vector hardware wants — and the sphere count is a static shape with no
15-slot ABI cap (src/webgl.rs:225-274 set a hard 15).

Negative radii are supported and flip the outward normal, which the RTiOW
book (and the reference scene, src/state.rs:200, 211) uses for hollow-glass
and inverted shells: ``outward_normal = (p - center) / radius``
(static/shader.frag:170).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from raytracer_tpu.core import pytree
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.scene.materials import Material

# Matches src/state.rs:12 — "so high that it's unlikely to be a real id".
NO_SELECTED_OBJECT_ID = 1000


@pytree.dataclass
class Scene:
    """All sphere + material data as SoA arrays of static length N.

    ``active`` mirrors the reference's ``is_active`` slot flag
    (static/shader.frag:59, 184-186): padding slots are inactive and can
    never be hit. Unlike the reference (which *breaks* at the first inactive
    slot), inactive slots are simply masked out — order-independent and
    branch-free.

    ``uuid`` is the sphere's index (src/glsl.rs:84-88 assigns uuid = i).
    """

    center: jnp.ndarray  # (N, 3) f32
    radius: jnp.ndarray  # (N,)  f32 — negative radius flips normals
    material_type: jnp.ndarray  # (N,) i32 — DIFFUSE/METAL/GLASS
    albedo: jnp.ndarray  # (N, 3) f32
    fuzz: jnp.ndarray  # (N,)  f32
    refraction_index: jnp.ndarray  # (N,)  f32
    active: jnp.ndarray  # (N,)  f32 — 1.0 live, 0.0 padding

    @property
    def count(self) -> int:
        """Static slot count (including padding)."""
        return self.center.shape[0]

    def num_active(self) -> jnp.ndarray:
        return jnp.sum(self.active).astype(jnp.int32)

    def pad_to(self, n: int) -> "Scene":
        """Pad with inactive slots up to static size ``n`` (for kernel tiling)."""
        cur = self.count
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad scene of {cur} spheres down to {n}")
        extra = n - cur

        def pad(x, fill=0.0):
            widths = [(0, extra)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths, constant_values=fill)

        return Scene(
            center=pad(self.center),
            # Padding radius 1 (not 0) keeps 1/radius finite in masked lanes.
            radius=pad(self.radius, 1.0),
            material_type=pad(self.material_type),
            albedo=pad(self.albedo),
            fuzz=pad(self.fuzz),
            refraction_index=pad(self.refraction_index, 1.0),
            active=pad(self.active, 0.0),
        )


def make_scene(
    spheres: Sequence[Tuple[Tuple[float, float, float], float, Material]],
    pad_to: int | None = None,
) -> Scene:
    """Build a :class:`Scene` from (center, radius, material) triples.

    The analog of building ``state.sphere_list`` + ``set_sphere_uuids``
    (src/state.rs:148-263); uuid == index by construction.
    """
    n = len(spheres)
    if n == 0:
        raise ValueError("scene must contain at least one sphere")
    centers = np.array([s[0] for s in spheres], dtype=np.float32)
    radii = np.array([s[1] for s in spheres], dtype=np.float32)
    mats = [s[2] for s in spheres]
    scene = Scene(
        center=jnp.asarray(centers),
        radius=jnp.asarray(radii),
        material_type=jnp.asarray([m.material_type for m in mats], dtype=jnp.int32),
        albedo=jnp.asarray(np.array([m.albedo for m in mats], dtype=np.float32)),
        fuzz=jnp.asarray([m.fuzz for m in mats], dtype=jnp.float32),
        refraction_index=jnp.asarray(
            [m.refraction_index for m in mats], dtype=jnp.float32
        ),
        active=jnp.ones((n,), dtype=jnp.float32),
    )
    if pad_to is not None:
        scene = scene.pad_to(pad_to)
    return scene


def update_sphere(
    scene: Scene,
    index: int,
    center=None,
    radius=None,
    material: Material | None = None,
    active: bool | None = None,
) -> Scene:
    """Return a new Scene with sphere ``index`` modified (pure update).

    The reference had no scene editing at all (the sphere list was uploaded
    once at startup, src/webgl.rs:225-274); here edits are cheap pytree
    updates — pair with ``reset_accumulation`` to restart convergence, like
    any camera change.
    """
    s = scene
    if center is not None:
        s = s.replace(center=s.center.at[index].set(jnp.asarray(center, jnp.float32)))
    if radius is not None:
        s = s.replace(radius=s.radius.at[index].set(float(radius)))
    if material is not None:
        s = s.replace(
            material_type=s.material_type.at[index].set(material.material_type),
            albedo=s.albedo.at[index].set(jnp.asarray(material.albedo, jnp.float32)),
            fuzz=s.fuzz.at[index].set(material.fuzz),
            refraction_index=s.refraction_index.at[index].set(
                material.refraction_index
            ),
        )
    if active is not None:
        s = s.replace(active=s.active.at[index].set(1.0 if active else 0.0))
    return s


def add_sphere(scene: Scene, center, radius, material: Material) -> Scene:
    """Append a sphere, reusing an inactive slot when available (no shape
    change → no recompile), else growing the arrays by one (recompiles)."""
    inactive = np.where(np.asarray(scene.active) == 0.0)[0]
    if inactive.size:
        return update_sphere(
            scene, int(inactive[0]), center=center, radius=radius,
            material=material, active=True,
        )

    def app(arr, value):
        return jnp.concatenate(
            [arr, jnp.asarray(value, arr.dtype)[None]], axis=0
        )

    return Scene(
        center=app(scene.center, jnp.asarray(center, jnp.float32)),
        radius=app(scene.radius, float(radius)),
        material_type=app(scene.material_type, material.material_type),
        albedo=app(scene.albedo, jnp.asarray(material.albedo, jnp.float32)),
        fuzz=app(scene.fuzz, material.fuzz),
        refraction_index=app(scene.refraction_index, material.refraction_index),
        active=app(scene.active, 1.0),
    )


def remove_sphere(scene: Scene, index: int) -> Scene:
    """Deactivate a sphere (slot becomes reusable padding; no recompile)."""
    return update_sphere(scene, index, active=False)
