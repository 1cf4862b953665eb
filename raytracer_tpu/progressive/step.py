"""The jitted progressive step: trace 1 frame, fold into the running average.

Rebuilds the realtime path of the reference — update_render_globals
(src/state.rs:443-450) + the shader's progressive blend
(static/shader.frag:387-404) — as a single pure ``step(state) -> state`` with
the accumulation buffer donated, so XLA updates it in place and nothing
round-trips to the host. The reference traced every frame TWICE (to screen
and to the accumulation FBO, src/webgl.rs:196-204); here each frame is
traced once and the display reads the accumulation buffer.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from raytracer_tpu.camera.camera import CameraConfig, derive_camera
from raytracer_tpu.progressive.state import RenderState
from raytracer_tpu.render.options import DebugParams, TraceOptions
from raytracer_tpu.render.tracer import render_image_jnp
from raytracer_tpu.scene.spheres import Scene

# Reference defaults (src/state.rs:134-135).
DEFAULT_LAST_FRAME_WEIGHT = 1.0
DEFAULT_MAX_RENDER_COUNT = 100_000


def accumulate(prev, new, render_count, last_frame_weight=DEFAULT_LAST_FRAME_WEIGHT):
    """The exact progressive blend (static/shader.frag:390-399).

    ``render_count`` is the post-increment count, as set by
    update_render_globals *before* the draw (src/state.rs:443-450). Note the
    faithful quirk: for render_count = N the blend is
    ``(prev·N + new·w)/(N + w)``, which over-weights history slightly
    relative to a true running mean (frame 1 effectively counts twice);
    it still converges to the same limit. Clamping render_count at
    max_render_count turns the mean into a sliding average thereafter
    (src/state.rs:73-75).
    """
    rc = jnp.asarray(render_count, prev.dtype)
    merged = (prev * rc + new * last_frame_weight) / (rc + last_frame_weight)
    return jnp.where(rc <= 1.0, new, merged)


def make_step_fn(
    width: int,
    height: int,
    spp: int = 1,
    opts: TraceOptions | None = None,
    should_average: bool = True,
    last_frame_weight: float = DEFAULT_LAST_FRAME_WEIGHT,
    max_render_count: int = DEFAULT_MAX_RENDER_COUNT,
    backend: str | None = None,
    jit: bool = True,
    static_scene: Scene | None = None,
    static_camera: CameraConfig | None = None,
):
    """Build ``step(state, scene, camera, debug) -> (state', aux)``.

    Resolution/spp/depth are compile-time constants; camera and scene are
    traced, so interactive motion never recompiles (SURVEY §7 hard part 5).
    ``aux['segments']`` counts traced ray-bounces for Mrays/s telemetry.

    ``static_scene``/``static_camera``: optional CONCRETE copies of what
    every ``step`` call will receive. Fixed-scene accumulation sessions
    (e.g. the CLI's --progressive-frames) get the Pallas split-scan
    static analysis at build time; interactive sessions (scene edits, a
    flying camera) must omit them — the default keeps full near→far
    logic. Same contract as the sharded factory.

    NOTE: the input state is DONATED (its buffers are updated in place on
    device); do not reuse it after the call — use the returned state.
    """
    import dataclasses

    from raytracer_tpu.render.api import resolve_backend

    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    opts = opts or TraceOptions()
    if backend is not None:
        opts = dataclasses.replace(opts, backend=backend)
    # resolve 'auto' here (compile-time): the viewer/engine default to it,
    # and the realtime path must hit the fast kernel where there is one
    opts = dataclasses.replace(opts, backend=resolve_backend(opts.backend))

    # fixed-scene sessions: run the split-scan analysis once at build time
    # on the concrete hints (traced scenes can't be analyzed per frame)
    split = None
    if (opts.backend == "pallas" and static_scene is not None
            and static_camera is not None):
        from raytracer_tpu.render import pallas_kernel as pk

        split = pk._containable_split(
            static_scene, derive_camera(static_camera), opts
        )

    if opts.adaptive_tolerance > 0.0:
        # progressive accumulation running-averages FIXED-spp frames;
        # a per-frame adaptive render returns per-pixel means over
        # VARYING sample counts, which the running average would weight
        # as if uniform (biased), and stratified sessions additionally
        # could not resume per-pixel R2 prefixes from a uniform frame·spp
        # offset. Strip the tolerance — adaptive sampling is an OFFLINE
        # mode (the CLI warns; same policy as the sharded step factory).
        opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    stratified = opts.sampler == "stratified"

    def step(
        state: RenderState,
        scene: Scene,
        camera: CameraConfig,
        debug: DebugParams,
    ):
        dcam = derive_camera(camera)
        if stratified:
            # stratified accumulation: ONE RNG stream for the whole session,
            # frames advance the absolute sample index — frame i is exactly
            # the offline render's spp-chunk [i·spp, (i+1)·spp), so the
            # accumulated session consumes each pixel's R2 sequence in
            # order (every prefix low-discrepancy). sample_offset is a
            # traced kernel input, so this never recompiles per frame.
            frame_key = state.key
            s_off = state.frame * spp
        else:
            frame_key = jax.random.fold_in(state.key, state.frame)
            s_off = 0
        if opts.backend == "pallas":
            from raytracer_tpu.render.pallas_kernel import render_image_pallas

            color, stats = render_image_pallas(
                scene, dcam, width, height, spp, frame_key, opts, debug,
                return_stats=True,
                sample_offset=s_off, static_split=split,
            )
        else:
            color, stats = render_image_jnp(
                scene, dcam, width, height, spp, frame_key, opts, debug,
                return_stats=True,
                sample_offset=s_off,
            )
        render_count = jnp.minimum(state.render_count + 1, max_render_count)
        if should_average:
            accum = accumulate(state.accum, color, render_count, last_frame_weight)
        else:
            accum = color
        new_state = state.replace(
            accum=accum, render_count=render_count, frame=state.frame + 1
        )
        return new_state, {"segments": stats["segments"]}

    if jit:
        step = jax.jit(step, donate_argnums=0)
    return step


def run_frames(step_fn, state, scene, camera, n_frames: int,
               debug: DebugParams | None = None):
    """Drive ``n_frames`` progressive steps (host loop, like the rAF loop of
    src/lib.rs:61-107 but with nothing per-frame on the host). Returns the
    final state and total traced segments."""
    dbg = debug if debug is not None else DebugParams.none()
    total = jnp.asarray(0.0)
    for _ in range(n_frames):
        state, aux = step_fn(state, scene, camera, dbg)
        # device-array accumulation: async dispatch, no per-frame host sync
        total = total + aux["segments"]
    return state, float(total)
