"""Reference path tracer in plain batched jnp — the correctness baseline.

A wavefront re-formulation of the GLSL megakernel (static/shader.frag):
every stage operates on the entire ray batch at once with live-lane masks
instead of per-thread early returns. One implementation serves rendering,
picking, and autofocus — eliminating the reference's duplicated CPU mirror
(src/glsl.rs:1-2).

Structure (reference line map):
- :func:`hit_world`        — shader.frag:136-196 (half-b quadratic, nearest
                              root with far-root fallback, closest-hit scan)
- :func:`scatter`          — shader.frag:210-286 (diffuse/metal/glass)
- :func:`background`       — shader.frag:289-294 (sky gradient)
- :func:`trace_rays`       — shader.frag:297-339 (bounce loop + debug AOVs)
- :func:`render_sample`    — one jittered 1-spp pass over the pixel grid
- :func:`render_image_jnp` — shader.frag:360-383 (spp loop, 1/spp scale,
                              sqrt gamma)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.camera.camera import DerivedCamera, generate_rays, pixel_st_grid
from raytracer_tpu.core import sampling, vec
from raytracer_tpu.render.options import MAX_T, MIN_T, DebugParams, TraceOptions
from raytracer_tpu.scene.materials import DIFFUSE, GLASS, METAL
from raytracer_tpu.scene.spheres import Scene


class HitRecord(NamedTuple):
    """Batched hit record (mirror of shader.frag:63-70), gathered from the
    winning sphere of the closest-hit scan."""

    hit: jnp.ndarray  # (P,) bool
    t: jnp.ndarray  # (P,)
    point: jnp.ndarray  # (P, 3)
    normal: jnp.ndarray  # (P, 3) — front-face corrected
    front_face: jnp.ndarray  # (P,) bool
    uuid: jnp.ndarray  # (P,) int32 — sphere index; -1 on miss
    material_type: jnp.ndarray  # (P,) int32
    albedo: jnp.ndarray  # (P, 3)
    fuzz: jnp.ndarray  # (P,)
    refraction_index: jnp.ndarray  # (P,)


def hit_world(origin, direction, scene: Scene, t_min=MIN_T, t_max=MAX_T) -> HitRecord:
    """Closest-hit over all spheres for a batch of rays.

    shader.frag:145-196 re-expressed as a fori_loop over spheres carrying
    (best_t, best_idx) per ray; inactive slots are masked rather than
    breaking the scan (shader.frag:184-186). Ties at equal t go to the
    later sphere, matching the reference's ``t_max < root`` reject test.
    """
    p = origin.shape[0]
    a = vec.length_squared(direction)  # (P,) — dirs are unnormalized
    inv_a = 1.0 / a
    t_max_arr = jnp.full((p,), t_max, origin.dtype)

    def body(i, carry):
        best_t, best_idx = carry
        center = jax.lax.dynamic_index_in_dim(scene.center, i, keepdims=False)
        radius = scene.radius[i]
        oc = origin - center
        half_b = vec.dot(oc, direction)
        c_coef = vec.length_squared(oc) - radius * radius
        disc = half_b * half_b - a * c_coef
        sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
        root_near = (-half_b - sqrtd) * inv_a
        root_far = (-half_b + sqrtd) * inv_a
        near_ok = (root_near >= t_min) & (root_near <= best_t)
        root = jnp.where(near_ok, root_near, root_far)
        valid = (
            (disc >= 0.0)
            & (scene.active[i] > 0.0)
            & (root >= t_min)
            & (root <= best_t)
        )
        best_t = jnp.where(valid, root, best_t)
        best_idx = jnp.where(valid, i, best_idx)
        return best_t, best_idx

    best_t, best_idx = jax.lax.fori_loop(
        0, scene.count, body, (t_max_arr, jnp.full((p,), -1, jnp.int32))
    )
    hit = best_idx >= 0
    safe_idx = jnp.maximum(best_idx, 0)

    center = jnp.take(scene.center, safe_idx, axis=0)
    radius = jnp.take(scene.radius, safe_idx)
    point = origin + best_t[..., None] * direction
    outward = (point - center) / radius[..., None]  # shader.frag:170
    front_face = vec.dot(direction, outward) < 0.0  # shader.frag:137
    normal = jnp.where(front_face[..., None], outward, -outward)

    return HitRecord(
        hit=hit,
        t=best_t,
        point=point,
        normal=normal,
        front_face=front_face,
        uuid=best_idx,
        material_type=jnp.take(scene.material_type, safe_idx),
        albedo=jnp.take(scene.albedo, safe_idx, axis=0),
        fuzz=jnp.take(scene.fuzz, safe_idx),
        refraction_index=jnp.take(scene.refraction_index, safe_idx),
    )


def schlick(cosine, refraction_ratio):
    """Schlick's reflectance approximation (shader.frag:203-207)."""
    r0 = ((1.0 - refraction_ratio) / (1.0 + refraction_ratio)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(direction, rec: HitRecord, key, opts: TraceOptions,
            uniforms=None):
    """Branch-free material evaluation (shader.frag:210-286).

    All three materials are computed for every lane and selected by
    material type — the batched answer to the GLSL if-chain. Returns
    (did_scatter (P,), attenuation (P,3), new_direction (P,3)).

    ``uniforms``: optional (unit_vec_draw (P,3), unit_sphere_draw (P,3),
    glass_u (P,)) replacing the key-based draws — the stratified
    first-bounce hook (distributions must match the samplers above)."""
    shape = rec.t.shape
    if uniforms is not None:
        unit_vec_draw, unit_sphere_draw, glass_u = uniforms
    else:
        unit_vec_draw, unit_sphere_draw, glass_u = (
            sampling.sphere_disk_glass_uniforms(key, shape)
        )

    # DIFFUSE (shader.frag:212-229): normal + random unit vector.
    diffuse_dir = rec.normal + unit_vec_draw
    if opts.near_zero_guard:
        # Canonical book guard; the reference ships with it disabled
        # (shader.frag:222-225).
        diffuse_dir = jnp.where(
            vec.near_zero(diffuse_dir)[..., None], rec.normal, diffuse_dir
        )

    # METAL (shader.frag:232-247): reflect + fuzz; absorbed below surface.
    reflected = vec.reflect(direction, rec.normal)
    metal_dir = reflected + rec.fuzz[..., None] * unit_sphere_draw
    metal_ok = vec.dot(rec.normal, metal_dir) > 0.0

    # GLASS (shader.frag:250-282): Snell + total internal reflection +
    # Schlick russian-roulette reflect/refract. Never absorbs.
    ratio = jnp.where(
        rec.front_face, 1.0 / rec.refraction_index, rec.refraction_index
    )
    unit_dir = vec.normalize(direction, eps=1e-20)
    cos_theta = jnp.minimum(vec.dot(-unit_dir, rec.normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = ratio * sin_theta > 1.0
    reflect_roll = schlick(cos_theta, ratio) > glass_u
    glass_reflects = cannot_refract | reflect_roll
    glass_dir = jnp.where(
        glass_reflects[..., None],
        vec.reflect(unit_dir, rec.normal),
        vec.refract(unit_dir, rec.normal, ratio),
    )

    mat = rec.material_type
    new_dir = jnp.where(
        (mat == DIFFUSE)[..., None],
        diffuse_dir,
        jnp.where((mat == METAL)[..., None], metal_dir, glass_dir),
    )
    did_scatter = jnp.where(
        mat == DIFFUSE,
        True,
        jnp.where(mat == METAL, metal_ok, mat == GLASS),
    )
    # Unknown material codes absorb (shader.frag:284-285) — handled above
    # because mat == GLASS is False for them.
    return did_scatter, rec.albedo, new_dir


def background(direction):
    """Sky gradient on miss (shader.frag:289-294)."""
    unit = vec.normalize(direction, eps=1e-20)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = jnp.ones_like(direction)
    blue = jnp.broadcast_to(
        jnp.array([0.5, 0.7, 1.0], direction.dtype), direction.shape
    )
    return vec.mix(white, blue, t)


def trace_rays(
    origin,
    direction,
    scene: Scene,
    key,
    opts: TraceOptions,
    debug: DebugParams | None = None,
    uv_b0=None,
):
    """The bounce loop (shader.frag:297-339) over a flat ray batch.

    Returns (color (P,3) linear, segments () f32) where ``segments`` counts
    live ray-bounce iterations — the "rays" of the Mrays/s metric.

    ``uv_b0``: optional (P, 3) stratified uniforms for the FIRST bounce —
    [diffuse hx, diffuse phi, glass roll] (the stratified sampler's
    bounce-0 dims; deeper bounces always draw from the key)."""
    p = origin.shape[0]
    dbg = debug if debug is not None else DebugParams.none()

    def body(i, carry):
        o, d, color, result, alive, segments = carry
        bkey = jax.random.fold_in(key, i)
        segments = segments + jnp.sum(alive, dtype=jnp.float32)

        rec = hit_world(o, d, scene)
        miss = alive & ~rec.hit
        result = jnp.where(miss[..., None], color * background(d), result)

        live_hit = alive & rec.hit
        if opts.enable_debug:
            # Debug AOVs terminate the ray immediately (shader.frag:306-318):
            # blue cursor marker, red grazing-angle outline on the selection.
            cursor_hit = live_hit & (
                vec.length(rec.point - dbg.cursor_point) < 0.1
            )
            result = jnp.where(
                cursor_hit[..., None],
                jnp.array([0.0, 0.0, 1.0], result.dtype),
                result,
            )
            live_hit = live_hit & ~cursor_hit
            outline = (
                live_hit
                & (rec.uuid == dbg.selected_object)
                & (vec.dot(rec.normal, d) > -0.05)
            )
            result = jnp.where(
                outline[..., None],
                jnp.array([1.0, 0.0, 0.0], result.dtype),
                result,
            )
            live_hit = live_hit & ~outline

        if uv_b0 is None:
            did_scatter, attenuation, new_dir = scatter(d, rec, bkey, opts)
        else:
            uvd, usd, gu = sampling.sphere_disk_glass_uniforms(
                bkey, rec.t.shape
            )
            first = i == 0
            uvd = jnp.where(
                first,
                sampling.unit_vector_from_uv(uv_b0[..., 0], uv_b0[..., 1]),
                uvd,
            )
            gu = jnp.where(first, uv_b0[..., 2], gu)
            did_scatter, attenuation, new_dir = scatter(
                d, rec, bkey, opts, uniforms=(uvd, usd, gu)
            )
        scat = live_hit & did_scatter
        # Absorbed rays contribute black (shader.frag:328) — result already 0.
        color = jnp.where(scat[..., None], color * attenuation, color)
        o = jnp.where(scat[..., None], rec.point, o)
        d = jnp.where(scat[..., None], new_dir, d)
        if opts.russian_roulette_depth > 0:
            # unbiased termination: survive with p = max(throughput)
            p_surv = jnp.clip(jnp.max(color, axis=-1), 0.05, 1.0)
            u = jax.random.uniform(jax.random.fold_in(bkey, 7), p_surv.shape)
            roll = i >= opts.russian_roulette_depth
            survive = jnp.where(roll, u < p_surv, True)
            color = jnp.where(
                (scat & roll & survive)[..., None], color / p_surv[..., None],
                color,
            )
            scat = scat & survive
        return o, d, color, result, scat, segments

    color0 = jnp.ones((p, 3), origin.dtype)
    result0 = jnp.zeros((p, 3), origin.dtype)
    alive0 = jnp.ones((p,), bool)
    _, _, color, result, alive, segments = jax.lax.fori_loop(
        0, opts.max_depth, body, (origin, direction, color0, result0, alive0, 0.0)
    )
    # Depth exhausted: the reference returns the accumulated throughput
    # (shader.frag:338); the book returns black. Selected by exhaust_black.
    tail = jnp.zeros_like(color) if opts.exhaust_black else color
    result = jnp.where(alive[..., None], tail, result)
    return result, segments


def render_sample(
    scene: Scene,
    dcam: DerivedCamera,
    st_flat,
    sample_key,
    width: int,
    height: int,
    opts: TraceOptions,
    debug: DebugParams | None = None,
    uv=None,
    uv_b0=None,
):
    """One jittered 1-spp pass: ray-gen + trace. Returns ((P,3), segments).

    ``uv``: optional (P, 4) stratified camera uniforms (see generate_rays);
    ``uv_b0``: optional (P, 3) stratified first-bounce uniforms (see
    trace_rays)."""
    ray = generate_rays(dcam, st_flat, sample_key, width, height, uv=uv)
    return trace_rays(ray.origin, ray.direction, scene, sample_key, opts,
                      debug, uv_b0=uv_b0)


def render_image_jnp(
    scene: Scene,
    dcam: DerivedCamera,
    width: int,
    height: int,
    spp: int,
    key,
    opts: TraceOptions,
    debug: DebugParams | None = None,
    return_stats: bool = False,
    sample_offset=0,
    row_offset: int = 0,
    band_height: int | None = None,
):
    """Full offline render (shader.frag:360-383): spp loop, average, gamma.

    Returns (H, W, 3) f32, row 0 at the image *bottom* (GL orientation);
    with ``return_stats`` also a dict with the traced segment count.
    ``sample_offset`` shifts the per-sample RNG streams so a render split
    into spp chunks reproduces the unchunked sample decomposition exactly
    (the caller averages linear chunk sums).

    ``row_offset``/``band_height`` render a horizontal band of the full
    image (returns (band_height, W, 3)): same camera geometry as the full
    render, but the per-pixel RNG draws are batch-POSITION-keyed (shape
    (P,) draws), so a banded render is a statistically equivalent — not
    bitwise-identical — Monte Carlo estimate. The api layer uses this only
    for renders so large that a single full-grid execution would trip the
    device watchdog (where the unbanded render cannot run at all)."""
    bh = band_height if band_height is not None else height
    grid = pixel_st_grid(width, height)
    if bh == height:
        st = grid
    else:
        # dynamic slice: row_offset may be traced, so every band of the
        # same height shares ONE compiled program
        st = jax.lax.dynamic_slice_in_dim(
            grid, jnp.asarray(row_offset, jnp.int32), bh, axis=0
        )
    st = st.reshape(-1, 2)
    p = st.shape[0]

    if opts.sampler == "stratified":
        # one Cranley-Patterson rotation per pixel, constant across the
        # render and across spp chunks: 4 camera dims + 3 first-bounce
        # dims (core/sampling.stratified_rotations — shared with the
        # sharded band path)
        cp, cp_b0 = sampling.stratified_rotations(key, p)
    else:
        cp = cp_b0 = None

    def body(s, carry):
        acc, segments = carry
        s_abs = sample_offset + s
        skey = jax.random.fold_in(key, s_abs)
        uv = sampling.r2_point(cp, s_abs) if cp is not None else None
        uv_b0 = (
            sampling.r2_point(cp_b0, s_abs, sampling.R2_ALPHAS_B0)
            if cp_b0 is not None else None
        )
        color, seg = render_sample(
            scene, dcam, st, skey, width, height, opts, debug, uv=uv,
            uv_b0=uv_b0,
        )
        return acc + color, segments + seg

    acc, segments = body(0, (jnp.zeros((p, 3), jnp.float32), jnp.asarray(0.0)))
    if spp > 1:
        acc, segments = jax.lax.fori_loop(1, spp, body, (acc, segments))
    color = acc * (1.0 / spp)
    if opts.gamma:
        color = jnp.sqrt(jnp.maximum(color, 0.0))  # shader.frag:380
    image = color.reshape(bh, width, 3)
    if return_stats:
        return image, {"segments": segments}
    return image
