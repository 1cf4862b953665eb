"""Pixel-row + spp sharding of the tracer over a 2-D device mesh.

Layout: mesh ``(rows, spp)``. Each device traces ``H/rows`` image rows at
``spp/spp_axis`` samples. Row shards never communicate; spp shards reduce
with a single ``psum`` of linear color before gamma. Keys are folded per
(row-shard, spp-shard) so the full-mesh render equals a single-device render
of the same (shard, sample) decomposition — deterministic at every mesh size.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytracer_tpu.camera.camera import CameraConfig, DerivedCamera, derive_camera, pixel_st_grid
from raytracer_tpu.progressive.state import RenderState
from raytracer_tpu.progressive.step import (
    DEFAULT_LAST_FRAME_WEIGHT,
    DEFAULT_MAX_RENDER_COUNT,
    accumulate,
)
from raytracer_tpu.render.options import DebugParams, TraceOptions
from raytracer_tpu.core import sampling
from raytracer_tpu.render.tracer import render_sample
from raytracer_tpu.scene.spheres import Scene


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] = ("rows", "spp")):
    """Build a Mesh over the first prod(axis_sizes) visible devices."""
    n = int(np.prod(axis_sizes))
    avail = jax.devices()
    if len(avail) < n:
        raise ValueError(
            f"mesh {tuple(axis_sizes)} needs {n} devices, "
            f"only {len(avail)} visible"
        )
    devices = np.array(avail[:n]).reshape(tuple(axis_sizes))
    return Mesh(devices, tuple(axis_names))


def _render_shard(
    scene: Scene,
    dcam: DerivedCamera,
    st_block,  # (rows_local, W, 2) — this shard's pixel rows
    key,
    width: int,
    height: int,
    spp_local: int,
    opts: TraceOptions,
    debug: DebugParams,
    spp_axis: str | None,
    sample_offset=0,
):
    """Per-device body: trace this row block at spp_local samples, mean over
    the spp mesh axis in linear space, then gamma.

    ``sample_offset`` (static int or traced i32) shifts the per-shard
    sample indices — the stratified progressive step passes frame·spp_local
    so each shard walks its pixels' R2 prefixes in order across frames."""
    rows_local = st_block.shape[0]
    st = st_block.reshape(-1, 2)
    # distinct stream per (row-shard, spp-shard)
    key = jax.random.fold_in(key, jax.lax.axis_index("rows"))
    if spp_axis is not None:
        key = jax.random.fold_in(key, jax.lax.axis_index(spp_axis))

    if opts.sampler == "stratified":
        # per-pixel Cranley-Patterson rotation, per shard (the spp axis, if
        # sharded, contributes independently-rotated LDS prefixes — still
        # unbiased and stratified within each shard); ONE implementation
        # shared with render_image_jnp so the streams cannot drift
        cp, cp_b0 = sampling.stratified_rotations(key, st.shape[0])
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

    acc, segments = jax.lax.fori_loop(
        0,
        spp_local,
        body,
        (jnp.zeros((st.shape[0], 3), jnp.float32), jnp.asarray(0.0)),
    )
    if spp_axis is not None:
        acc = jax.lax.psum(acc, spp_axis)
        segments = jax.lax.psum(segments, spp_axis)
        total_spp = spp_local * jax.lax.axis_size(spp_axis)
    else:
        total_spp = spp_local
    color = acc * (1.0 / total_spp)
    if opts.gamma:
        color = jnp.sqrt(jnp.maximum(color, 0.0))
    return color.reshape(rows_local, -1, 3), segments[None]


def _seed_and_offsets(key, spp_axis, spp_local: int, local_h: int):
    """Per-shard kernel seed, first absolute sample and first image row."""
    from raytracer_tpu.render import pallas_kernel as pk

    samp0 = jax.lax.axis_index(spp_axis) * spp_local if spp_axis else 0
    return (pk._seed_from_key(key), samp0,
            jax.lax.axis_index("rows") * local_h)


@functools.lru_cache(maxsize=16)
def _sharded_render_fn(mesh: Mesh, width: int, height: int, spp: int,
                       opts: TraceOptions, g_full: int, sizes):
    """The jitted shard_map render for one static configuration, cached so
    repeated renders reuse one executable."""
    from raytracer_tpu.render import pallas_kernel as pk

    spp_axis = "spp" if "spp" in mesh.shape else None
    local_h = height // mesh.shape["rows"]
    spp_local = spp // mesh.shape.get("spp", 1)
    band = dict(width=width, height=height, band_h=local_h, opts=opts,
                g_full=g_full)

    def shard_body(scene, uuid, dcam, key):
        seed, samp0, row0 = _seed_and_offsets(key, spp_axis, spp_local,
                                              local_h)
        if sizes is not None:
            acc, seg = pk.adaptive_band(scene, uuid, dcam, seed, row0,
                                        sizes=list(sizes), **band)
            image, mean_spp, spp_map = pk._finalize_adaptive(
                acc, width, local_h, opts.gamma
            )
            return image, seg[None], mean_spp[None], spp_map
        sums, _, segs = pk.trace_band(scene, uuid, dcam, None, seed, samp0,
                                      row0, spp=spp_local, **band)
        lin, seg = sums[:3], pk._seg_pair(segs)
        if spp_axis is not None:
            lin = jax.lax.psum(lin, spp_axis)
            seg = jax.lax.psum(seg, spp_axis)
        image = pk._band_image(lin, width, local_h) * (1.0 / spp)
        return pk._gamma(image, opts.gamma), seg[None]

    # segments ride as per-shard exact int32 [hi, lo] pairs
    # (pallas_kernel._seg_pair), summed and rounded to f32 once outside
    out_specs = (P("rows", None, None), P("rows", None))
    if sizes is not None:
        out_specs += (P("rows"), P("rows", None))
    return jax.jit(jax.shard_map(shard_body, mesh=mesh,
                                 in_specs=(P(), P(), P(), P()),
                                 out_specs=out_specs, check_vma=False))


def render_image_sharded_pallas(
    scene: Scene,
    camera: CameraConfig,
    width: int,
    height: int,
    spp: int,
    key,
    mesh: Mesh,
    opts: TraceOptions | None = None,
    return_stats: bool = False,
):
    """Multi-device render through the Pallas kernel.

    Each 'rows' shard renders its horizontal band via the kernel's
    row-offset path, and each 'spp' shard a disjoint global sample range.
    Every pixel's RNG stream and camera ray derive from ABSOLUTE pixel
    coordinates and sample indices, so a rows-only mesh reproduces the
    single-device render bitwise; an spp axis adds one psum of linear
    color, which changes only the f32 summation order.
    """
    from raytracer_tpu.render import pallas_kernel as pk

    opts = opts or TraceOptions()
    if opts.enable_debug:
        # the debug overlay is an interactive single-device feature; the
        # sharded bands never carry the cursor/selection uniforms
        opts = dataclasses.replace(opts, enable_debug=False)
    rows = mesh.shape["rows"]
    spp_axis = "spp" if "spp" in mesh.shape else None
    spp_size = mesh.shape.get("spp", 1)
    if height % rows:
        raise ValueError(f"height {height} not divisible by rows axis {rows}")
    if spp % spp_size:
        raise ValueError(f"spp {spp} not divisible by spp axis {spp_size}")
    dcam = derive_camera(camera)
    # static far-root analysis on the concrete scene, as the single-device
    # path does — a value-neutral sphere reordering
    scene, uuid, g_full = pk._apply_split(
        scene, pk._containable_split(scene, dcam, opts)
    )

    # adaptive sampling decides per pixel from that pixel's own sums, so
    # rows bands decide independently (no collectives). An spp shard
    # stopping a pixel early would desync the disjoint sample ranges, so
    # spp-sharded renders run fixed-spp.
    sizes = None
    if opts.adaptive_tolerance > 0.0 and spp_size == 1:
        sizes = pk.adaptive_schedule(
            spp, opts.adaptive_chunk_spp or pk.ADAPTIVE_AUTO_CHUNK
        )
    if sizes is None:
        opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    fn = _sharded_render_fn(mesh, width, height, spp, opts, g_full,
                            None if sizes is None else tuple(sizes))
    out = fn(scene, uuid, dcam, key)
    image = out[0]
    if return_stats:
        stats = {"segments": pk._seg_value(jnp.sum(out[1], axis=0))}
        if sizes is not None:
            # equal band heights ⇒ the mean of per-band means is exact
            stats["mean_spp"] = jnp.mean(out[2])
            stats["spp_map"] = out[3]
        return image, stats
    return image


def render_image_sharded(
    scene: Scene,
    camera: CameraConfig,
    width: int,
    height: int,
    spp: int,
    key,
    mesh: Mesh,
    opts: TraceOptions | None = None,
    debug: DebugParams | None = None,
    return_stats: bool = False,
):
    """Offline render sharded over ``mesh`` (axes 'rows' and optionally
    'spp'). Requires height % rows == 0 and spp % spp_axis == 0."""
    opts = opts or TraceOptions()
    debug = debug if debug is not None else DebugParams.none()
    rows = mesh.shape["rows"]
    spp_axis = "spp" if "spp" in mesh.shape else None
    spp_size = mesh.shape.get("spp", 1)
    if height % rows:
        raise ValueError(f"height {height} not divisible by rows axis {rows}")
    if spp % spp_size:
        raise ValueError(f"spp {spp} not divisible by spp axis {spp_size}")

    dcam = derive_camera(camera)
    st = pixel_st_grid(width, height)  # (H, W, 2)

    body = functools.partial(
        _render_shard,
        width=width,
        height=height,
        spp_local=spp // spp_size,
        opts=opts,
        debug=debug,
        spp_axis=spp_axis,
    )
    in_specs = (
        P(),  # scene (replicated)
        P(),  # dcam
        P("rows", None, None),  # st rows
        P(),  # key
    )
    out_specs = (P("rows", None, None), P("rows"))
    fn = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    image, segments = jax.jit(fn)(scene, dcam, st, key)
    if return_stats:
        return image, {"segments": jnp.sum(segments)}
    return image


def make_sharded_step_fn(
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 1,
    opts: TraceOptions | None = None,
    should_average: bool = True,
    last_frame_weight: float = DEFAULT_LAST_FRAME_WEIGHT,
    max_render_count: int = DEFAULT_MAX_RENDER_COUNT,
    static_scene: Scene | None = None,
    static_camera: CameraConfig | None = None,
):
    """Progressive step over the mesh: the accumulation buffer lives sharded
    over rows frame-to-frame (no gather until display/export). The full
    device-state update — trace, psum over spp, blend — is one jitted
    program; the input state is donated.

    ``static_scene``/``static_camera``: optional CONCRETE copies of the
    scene/camera that every ``step`` call will receive. When given (fixed-
    scene accumulation, e.g. the CLI's --progressive-frames), the Pallas
    path runs the split-scan static analysis once at build time and the
    per-frame kernels skip the far-root ops for non-containable spheres —
    the same analysis the offline path performs (pallas_kernel.
    _containable_split). The step's traced scene is assumed to MATCH the
    hint's geometry/materials and the camera to stay put; interactive
    sessions (scene edits / a flying camera can move ray origins inside
    formerly-safe spheres) must omit them — the default keeps full
    near→far logic, exactly like the single-device progressive step."""
    from raytracer_tpu.render.api import resolve_backend

    opts = opts or TraceOptions()
    opts = dataclasses.replace(opts, backend=resolve_backend(opts.backend))
    rows = mesh.shape["rows"]
    spp_axis = "spp" if "spp" in mesh.shape else None
    spp_size = mesh.shape.get("spp", 1)
    if height % rows:
        raise ValueError(f"height {height} not divisible by rows axis {rows}")
    if spp % spp_size:
        raise ValueError(f"spp {spp} not divisible by spp axis {spp_size}")

    if opts.backend == "pallas" and not opts.enable_debug:
        return _make_sharded_step_fn_pallas(
            width, height, mesh, spp, opts, should_average,
            last_frame_weight, max_render_count,
            static_scene=static_scene, static_camera=static_camera,
        )

    st_full = pixel_st_grid(width, height)

    stratified = opts.sampler == "stratified"

    def shard_body(accum_block, st_block, frame, key, scene, dcam, debug):
        if stratified:
            # fixed per-session stream; frames advance each shard's
            # absolute sample index so every pixel consumes its R2
            # prefix in order (see progressive/step.py)
            frame_key, s_off = key, frame[0] * (spp // spp_size)
        else:
            frame_key, s_off = jax.random.fold_in(key, frame[0]), 0
        color, segments = _render_shard(
            scene,
            dcam,
            st_block,
            frame_key,
            width,
            height,
            spp // spp_size,
            opts,
            debug,
            spp_axis,
            sample_offset=s_off,
        )
        return color, segments

    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(
            P("rows", None, None),  # accum block (carried for locality)
            P("rows", None, None),  # st rows
            P(),  # frame (replicated, (1,))
            P(),  # key
            P(),  # scene
            P(),  # dcam
            P(),  # debug
        ),
        out_specs=(P("rows", None, None), P("rows")),
        check_vma=False,
    )

    def step(state: RenderState, scene: Scene, camera: CameraConfig,
             debug: DebugParams):
        dcam = derive_camera(camera)
        color, segments = fn(
            state.accum,
            st_full,
            state.frame[None],
            state.key,
            scene,
            dcam,
            debug,
        )
        render_count = jnp.minimum(state.render_count + 1, max_render_count)
        if should_average:
            accum = accumulate(state.accum, color, render_count, last_frame_weight)
        else:
            accum = color
        new_state = state.replace(
            accum=accum, render_count=render_count, frame=state.frame + 1
        )
        return new_state, {"segments": jnp.sum(segments)}

    return jax.jit(step, donate_argnums=0)


def _make_sharded_step_fn_pallas(
    width: int,
    height: int,
    mesh: Mesh,
    spp: int,
    opts: TraceOptions,
    should_average: bool,
    last_frame_weight: float,
    max_render_count: int,
    static_scene: Scene | None = None,
    static_camera: CameraConfig | None = None,
):
    """Progressive step through the Pallas kernel over the mesh — the
    reference's primary realtime use case (static/shader.frag:387-404).
    Each 'rows' shard renders its band via the kernel's row-offset path
    and each 'spp' shard a disjoint global sample range, reproducing the
    single-device RNG streams: a rows-only frame equals the single-device
    frame bitwise, an spp axis to one psum's f32 summation order. The
    accumulation buffer stays row-sharded frame to frame."""
    from raytracer_tpu.render import pallas_kernel as pk

    opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    rows = mesh.shape["rows"]
    spp_axis = "spp" if "spp" in mesh.shape else None
    spp_size = mesh.shape.get("spp", 1)
    local_h = height // rows
    spp_local = spp // spp_size

    # fixed-scene sessions: run the split-scan analysis ONCE at build time
    # on the concrete hints (inside the jitted step everything is traced)
    split = None
    if static_scene is not None and static_camera is not None:
        split = pk._containable_split(
            static_scene, derive_camera(static_camera), opts
        )
    stratified = opts.sampler == "stratified"

    def shard_body(frame, key, scene, dcam):
        scene, uuid, g_full = pk._apply_split(scene, split)
        if stratified:
            # fixed per-session seed; frames shift the global sample range
            # by spp so the session decomposes exactly like one offline
            # render (see progressive/step.py)
            frame_key, frame_base = key, frame[0] * spp
        else:
            frame_key, frame_base = jax.random.fold_in(key, frame[0]), 0
        seed, samp0, row0 = _seed_and_offsets(frame_key, spp_axis,
                                              spp_local, local_h)
        sums, _, segs = pk.trace_band(
            scene, uuid, dcam, None, seed, frame_base + samp0, row0,
            width=width, height=height, band_h=local_h, spp=spp_local,
            opts=opts, g_full=g_full,
        )
        lin, seg = sums[:3], pk._seg_pair(segs)
        if spp_axis is not None:
            lin = jax.lax.psum(lin, spp_axis)
            seg = jax.lax.psum(seg, spp_axis)
        image = pk._band_image(lin, width, local_h) * (1.0 / spp)
        return pk._gamma(image, opts.gamma), seg[None]

    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P("rows", None, None), P("rows", None)),
        check_vma=False,
    )

    def step(state: RenderState, scene: Scene, camera: CameraConfig,
             debug: DebugParams):
        dcam = derive_camera(camera)
        color, segments = fn(state.frame[None], state.key, scene, dcam)
        render_count = jnp.minimum(state.render_count + 1, max_render_count)
        if should_average:
            accum = accumulate(state.accum, color, render_count,
                               last_frame_weight)
        else:
            accum = color
        new_state = state.replace(
            accum=accum, render_count=render_count, frame=state.frame + 1
        )
        return new_state, {
            "segments": pk._seg_value(jnp.sum(segments, axis=0))
        }

    return jax.jit(step, donate_argnums=0)


def shard_render_state(state: RenderState, mesh: Mesh) -> RenderState:
    """Place the accumulation buffer row-sharded on the mesh (everything
    else replicated)."""
    accum = jax.device_put(
        state.accum, NamedSharding(mesh, P("rows", None, None))
    )
    rep = NamedSharding(mesh, P())
    return RenderState(
        accum=accum,
        render_count=jax.device_put(state.render_count, rep),
        frame=jax.device_put(state.frame, rep),
        key=jax.device_put(state.key, rep),
    )
