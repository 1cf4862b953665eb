"""Progressive accumulation tests: the exact blend semantics of
static/shader.frag:387-404 + src/state.rs:443-450, convergence toward the
offline render, checkpoint/resume, and reset-on-change."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.camera.camera import derive_camera
from raytracer_tpu.progressive.state import (
    init_render_state,
    load_render_state,
    reset_accumulation,
    save_render_state,
)
from raytracer_tpu.progressive.step import accumulate, make_step_fn, run_frames
from raytracer_tpu.render.options import DebugParams, TraceOptions
from raytracer_tpu.render.tracer import render_image_jnp
from raytracer_tpu.scene import presets

W, H = 48, 27


def setup():
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    return scene, cam


def test_accumulate_first_frame_straight():
    prev = jnp.zeros((2, 2, 3))
    new = jnp.ones((2, 2, 3)) * 0.5
    out = accumulate(prev, new, render_count=1)
    np.testing.assert_allclose(np.asarray(out), 0.5)


def test_accumulate_reference_formula():
    """Frame N blend = (prev·N + new)/(N+1) with rc incremented pre-draw —
    the faithful (slightly history-biased) reference formula."""
    prev = jnp.full((1, 1, 3), 0.4)
    new = jnp.full((1, 1, 3), 1.0)
    out = accumulate(prev, new, render_count=2)
    np.testing.assert_allclose(np.asarray(out), (0.4 * 2 + 1.0) / 3.0, rtol=1e-6)


def test_accumulate_last_frame_weight():
    prev = jnp.full((1, 1, 3), 0.0)
    new = jnp.full((1, 1, 3), 1.0)
    out = accumulate(prev, new, render_count=10, last_frame_weight=5.0)
    np.testing.assert_allclose(np.asarray(out), 5.0 / 15.0, rtol=1e-6)


def test_step_advances_counters(key):
    scene, cam = setup()
    step = make_step_fn(W, H, spp=1, opts=TraceOptions(max_depth=4))
    state = init_render_state(W, H, key)
    state, aux = step(state, scene, cam, DebugParams.none())
    assert int(state.render_count) == 1
    assert int(state.frame) == 1
    assert float(aux["segments"]) > 0
    state, _ = step(state, scene, cam, DebugParams.none())
    assert int(state.render_count) == 2 and int(state.frame) == 2


def test_progressive_converges_to_offline(key):
    """Averaging N 1-spp frames approaches the offline N-spp render.

    Not bitwise equal (offline averages linear then gammas once; progressive
    averages gamma'd frames — the reference's semantics, shader.frag:376-380
    vs 387-399), but close on a smooth scene."""
    scene, cam = setup()
    opts = TraceOptions(max_depth=6)
    step = make_step_fn(W, H, spp=1, opts=opts)
    state = init_render_state(W, H, key)
    state, _ = run_frames(step, state, scene, cam, 64)
    offline = render_image_jnp(scene, derive_camera(cam), W, H, 64, key, opts)
    diff = np.abs(np.asarray(state.accum) - np.asarray(offline)).mean()
    assert diff < 0.02, diff


def test_run_frames_deterministic(key):
    scene, cam = setup()
    step = make_step_fn(W, H, spp=1, opts=TraceOptions(max_depth=4))
    a, _ = run_frames(step, init_render_state(W, H, key), scene, cam, 5)
    b, _ = run_frames(step, init_render_state(W, H, key), scene, cam, 5)
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))


def test_reset_keeps_frame_counter(key):
    scene, cam = setup()
    step = make_step_fn(W, H, spp=1, opts=TraceOptions(max_depth=2))
    state = init_render_state(W, H, key)
    state, _ = step(state, scene, cam, DebugParams.none())
    state = reset_accumulation(state)
    assert int(state.render_count) == 0
    assert int(state.frame) == 1  # RNG never replays after a reset
    np.testing.assert_allclose(np.asarray(state.accum), 0.0)


def test_checkpoint_roundtrip(tmp_path, key):
    scene, cam = setup()
    step = make_step_fn(W, H, spp=1, opts=TraceOptions(max_depth=2))
    state = init_render_state(W, H, key)
    state, _ = step(state, scene, cam, DebugParams.none())
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, state)
    loaded = load_render_state(path)
    np.testing.assert_array_equal(np.asarray(loaded.accum), np.asarray(state.accum))
    # resuming from the checkpoint continues identically to never stopping
    cont_a, _ = step(state, scene, cam, DebugParams.none())
    cont_b, _ = step(loaded, scene, cam, DebugParams.none())
    np.testing.assert_array_equal(
        np.asarray(cont_a.accum), np.asarray(cont_b.accum)
    )


def test_no_average_mode_overwrites(key):
    scene, cam = setup()
    step = make_step_fn(W, H, spp=2, opts=TraceOptions(max_depth=4), should_average=False)
    state = init_render_state(W, H, key)
    s1, _ = step(state, scene, cam, DebugParams.none())
    first = np.asarray(s1.accum).copy()
    s2, _ = step(s1, scene, cam, DebugParams.none())
    # frame 2 replaces frame 1 entirely (plain render, shader.frag:400-403)
    assert not np.array_equal(first, np.asarray(s2.accum))


def test_camera_motion_does_not_recompile(key):
    scene, cam = setup()
    opts = TraceOptions(max_depth=3)
    step = make_step_fn(W, H, spp=1, opts=opts)
    state = init_render_state(W, H, key)
    state, _ = step(state, scene, cam, DebugParams.none())
    moved = cam.replace(origin=cam.origin + jnp.array([0.1, 0.0, 0.0]))
    with jax.log_compiles():
        import io
        import logging

        stream = io.StringIO()
        handler = logging.StreamHandler(stream)
        logging.getLogger("jax").addHandler(handler)
        try:
            state, _ = step(state, scene, moved, DebugParams.none())
        finally:
            logging.getLogger("jax").removeHandler(handler)
        assert "Compiling" not in stream.getvalue()


def test_step_fn_static_split_hints(key):
    """make_step_fn with concrete scene/camera hints (fixed-scene
    accumulation) produces bitwise-identical frames to the hint-less
    step — the split scan is exact."""
    import numpy as np

    from raytracer_tpu.render import pallas_kernel as pk
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    scene = make_scene(
        [((0, -1000, 0), 1000.0, Material.diffuse((0.5, 0.5, 0.5))),
         ((0, 1, 0), 1.0, Material.glass(1.5))]
        + [((4 * i, 3, 0), 1.0, Material.diffuse((0.4, 0.2, 0.1)))
           for i in range(1, 10)]
    )
    cam = presets.simple_camera(64, 32)
    opts = TraceOptions(max_depth=3, backend="pallas")
    split = pk._containable_split(scene, derive_camera(cam), opts)
    assert split is not None  # the hints really engage the analysis

    step_h = make_step_fn(64, 32, spp=1, opts=opts, static_scene=scene,
                          static_camera=cam)
    step_0 = make_step_fn(64, 32, spp=1, opts=opts)
    sa = init_render_state(64, 32, key)
    sb = init_render_state(64, 32, key)
    for _ in range(2):
        sa, _ = step_h(sa, scene, cam, DebugParams.none())
        sb, _ = step_0(sb, scene, cam, DebugParams.none())
    np.testing.assert_array_equal(np.asarray(sa.accum), np.asarray(sb.accum))


def test_stratified_frames_decompose_like_offline(key):
    """Stratified progressive: frame i is the offline render's spp-chunk
    [i·spp, (i+1)·spp) — fixed session key, advancing sample_offset
    (should_average=False exposes raw frames). Equal to jit-fusion
    rounding (the step jits the whole pipeline; the offline call runs
    eagerly — few-ULP differences on a fraction of a percent of pixels,
    measured max ~2e-6 through the gamma sqrt)."""
    scene, cam = setup()
    opts = TraceOptions(max_depth=4, sampler="stratified")
    step = make_step_fn(W, H, spp=2, opts=opts, should_average=False)
    state = init_render_state(W, H, key)
    dcam = derive_camera(cam)
    for i in range(3):
        state, _ = step(state, scene, cam, DebugParams.none())
        offline = render_image_jnp(
            scene, dcam, W, H, 2, key, opts, sample_offset=i * 2
        )
        np.testing.assert_allclose(
            np.asarray(state.accum), np.asarray(offline),
            rtol=0, atol=5e-6, err_msg=f"frame {i}",
        )


def test_stratified_pallas_frames_decompose_like_offline(key):
    """Same decomposition through the Pallas kernel (interpret mode)."""
    from raytracer_tpu.render.pallas_kernel import render_image_pallas

    scene, cam = setup()
    opts = TraceOptions(max_depth=4, sampler="stratified", backend="pallas")
    step = make_step_fn(W, H, spp=2, opts=opts, should_average=False,
                        static_scene=scene, static_camera=cam)
    state = init_render_state(W, H, key)
    dcam = derive_camera(cam)
    for i in range(2):
        state, _ = step(state, scene, cam, DebugParams.none())
        offline = render_image_pallas(
            scene, dcam, W, H, 2, key, opts, sample_offset=i * 2
        )
        np.testing.assert_array_equal(
            np.asarray(state.accum), np.asarray(offline), err_msg=f"frame {i}"
        )


def test_stratified_frames_distinct_and_converge(key):
    """Frames draw DIFFERENT samples (the offset advances) and the
    accumulated session converges to the offline render like the random
    sampler does."""
    scene, cam = setup()
    opts = TraceOptions(max_depth=6, sampler="stratified")
    step = make_step_fn(W, H, spp=1, opts=opts)
    state = init_render_state(W, H, key)
    state, _ = step(state, scene, cam, DebugParams.none())
    f0 = np.asarray(state.accum).copy()
    state, _ = step(state, scene, cam, DebugParams.none())
    assert not np.array_equal(f0, np.asarray(state.accum))
    state, _ = run_frames(step, state, scene, cam, 62)
    offline = render_image_jnp(
        scene, derive_camera(cam), W, H, 64, key,
        TraceOptions(max_depth=6),
    )
    diff = np.abs(np.asarray(state.accum) - np.asarray(offline)).mean()
    assert diff < 0.02, diff


def test_progressive_strips_adaptive(key):
    """adaptive_tolerance is an OFFLINE mode: per-frame adaptive renders
    return per-pixel means over varying sample counts, which the running
    average would weight as if uniform. The step must strip the tolerance
    and behave exactly like the fixed-spp step — for BOTH samplers (the
    stratified session keeps its sampler; only the tolerance drops)."""
    scene, cam = setup()
    for sampler in ("random", "stratified"):
        o_a = TraceOptions(max_depth=4, sampler=sampler,
                           adaptive_tolerance=0.05)
        o_f = TraceOptions(max_depth=4, sampler=sampler)
        s1 = make_step_fn(W, H, spp=2, opts=o_a)
        s2 = make_step_fn(W, H, spp=2, opts=o_f)
        a, _ = run_frames(s1, init_render_state(W, H, key), scene, cam, 2)
        b, _ = run_frames(s2, init_render_state(W, H, key), scene, cam, 2)
        np.testing.assert_array_equal(
            np.asarray(a.accum), np.asarray(b.accum), err_msg=sampler
        )
