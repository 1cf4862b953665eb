"""Multi-device tests on the 8-device virtual CPU mesh: sharded renders are
correct, deterministic, and row shards match single-device tracing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera.camera import derive_camera
from raytracer_tpu.parallel.sharding import (
    make_mesh,
    make_sharded_step_fn,
    render_image_sharded,
    shard_render_state,
)
from raytracer_tpu.progressive.state import init_render_state
from raytracer_tpu.render.options import DebugParams, TraceOptions
from raytracer_tpu.scene import presets

W, H = 64, 32


@pytest.fixture(scope="module")
def setup():
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    return scene, cam


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_render_shapes_and_range(setup, key):
    scene, cam = setup
    mesh = make_mesh((4, 2))
    img = render_image_sharded(
        scene, cam, W, H, 4, key, mesh, TraceOptions(max_depth=4)
    )
    a = np.asarray(img)
    assert a.shape == (H, W, 3)
    assert a.min() >= 0 and a.max() <= 1 + 1e-6


def test_sharded_deterministic(setup, key):
    scene, cam = setup
    mesh = make_mesh((4, 2))
    opts = TraceOptions(max_depth=4)
    a = render_image_sharded(scene, cam, W, H, 4, key, mesh, opts)
    b = render_image_sharded(scene, cam, W, H, 4, key, mesh, opts)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_size_invariance(setup, key):
    """Renders with different rows-axis sizes agree statistically (different
    key folds → different noise, same converged limit)."""
    scene, cam = setup
    opts = TraceOptions(max_depth=6)
    a = render_image_sharded(scene, cam, W, H, 16, key, make_mesh((2,), ("rows",)), opts)
    b = render_image_sharded(scene, cam, W, H, 16, key, make_mesh((8,), ("rows",)), opts)
    diff = np.abs(np.asarray(a) - np.asarray(b)).mean()
    assert diff < 0.04, diff


def test_rows_only_mesh(setup, key):
    scene, cam = setup
    mesh = make_mesh((8,), ("rows",))
    img, stats = render_image_sharded(
        scene, cam, W, H, 2, key, mesh, TraceOptions(max_depth=4),
        return_stats=True,
    )
    assert np.asarray(img).shape == (H, W, 3)
    assert float(stats["segments"]) >= W * H * 2


def test_indivisible_raises(setup, key):
    scene, cam = setup
    mesh = make_mesh((8,), ("rows",))
    with pytest.raises(ValueError):
        render_image_sharded(scene, cam, W, 30, 2, key, mesh)


def test_sharded_step_matches_quality(setup, key):
    """Sharded progressive accumulation converges to the offline image."""
    scene, cam = setup
    mesh = make_mesh((4, 2))
    opts = TraceOptions(max_depth=6)
    step = make_sharded_step_fn(W, H, mesh, spp=2, opts=opts)
    state = shard_render_state(init_render_state(W, H, key), mesh)
    dbg = DebugParams.none()
    for _ in range(32):
        state, _ = step(state, scene, cam, dbg)
    from raytracer_tpu.render.tracer import render_image_jnp

    offline = render_image_jnp(scene, derive_camera(cam), W, H, 64, key, opts)
    diff = np.abs(np.asarray(state.accum) - np.asarray(offline)).mean()
    assert diff < 0.03, diff


def test_sharded_state_stays_sharded(setup, key):
    scene, cam = setup
    mesh = make_mesh((4,), ("rows",))
    step = make_sharded_step_fn(W, H, mesh, spp=1, opts=TraceOptions(max_depth=3))
    state = shard_render_state(init_render_state(W, H, key), mesh)
    state, _ = step(state, scene, cam, DebugParams.none())
    sharding = state.accum.sharding
    assert not sharding.is_fully_replicated


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_pallas_matches_single_chip(setup, key):
    """The Pallas kernel under shard_map (rows x spp mesh) reproduces the
    single-device pallas render to f32 summation order (the spp psum)."""
    from raytracer_tpu.parallel.sharding import render_image_sharded_pallas
    from raytracer_tpu.render import pallas_kernel as pk

    scene, cam = setup
    opts = TraceOptions(max_depth=4)
    img, stats = render_image_sharded_pallas(
        scene, cam, W, H, 4, key, make_mesh((4, 2)), opts, return_stats=True
    )
    single = pk.render_image_pallas(
        scene, derive_camera(cam), W, H, 4, key, opts
    )
    np.testing.assert_allclose(
        np.asarray(img), np.asarray(single), atol=1e-6
    )
    assert float(stats["segments"]) >= W * H * 4


def test_sharded_pallas_progressive_matches_single_chip(setup, key):
    """The Pallas-backend progressive step over a pure-rows mesh reproduces
    the single-chip Pallas progressive step bitwise (same kernel, same
    row-offset RNG streams, no collectives)."""
    from raytracer_tpu.progressive.step import make_step_fn

    scene, cam = setup
    opts = TraceOptions(max_depth=3, backend="pallas")
    mesh = make_mesh((4,), ("rows",))
    step_m = make_sharded_step_fn(W, H, mesh, spp=1, opts=opts)
    state_m = shard_render_state(init_render_state(W, H, key), mesh)
    step_1 = make_step_fn(W, H, spp=1, opts=opts)
    state_1 = init_render_state(W, H, key)
    for _ in range(2):
        state_m, aux_m = step_m(state_m, scene, cam, DebugParams.none())
        state_1, aux_1 = step_1(state_1, scene, cam, DebugParams.none())
    assert np.array_equal(np.asarray(state_m.accum), np.asarray(state_1.accum))
    assert float(aux_m["segments"]) == float(aux_1["segments"])
    assert not state_m.accum.sharding.is_fully_replicated


def test_sharded_pallas_progressive_spp_axis(setup, key):
    """rows × spp mesh: the spp axis psums linear color; result matches the
    single-chip render statistically (identical sample decomposition, f32
    summation order differs only at the psum)."""
    from raytracer_tpu.progressive.step import make_step_fn

    scene, cam = setup
    opts = TraceOptions(max_depth=3, backend="pallas")
    mesh = make_mesh((2, 2))
    step_m = make_sharded_step_fn(W, H, mesh, spp=2, opts=opts)
    state_m = shard_render_state(init_render_state(W, H, key), mesh)
    step_1 = make_step_fn(W, H, spp=2, opts=opts)
    state_1 = init_render_state(W, H, key)
    state_m, _ = step_m(state_m, scene, cam, DebugParams.none())
    state_1, _ = step_1(state_1, scene, cam, DebugParams.none())
    np.testing.assert_allclose(
        np.asarray(state_m.accum), np.asarray(state_1.accum), atol=1e-6
    )


def test_sharded_pallas_split_scan_parity(key):
    """The offline sharded path threads the split scan (containable
    permutation + g_full) through shard_map: a scene with a non-trivial
    near-only suffix must match the single-chip render, which runs the
    same analysis."""
    from raytracer_tpu.parallel.sharding import render_image_sharded_pallas
    from raytracer_tpu.render import pallas_kernel as pk
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    scene = make_scene([
        ((0, -1000, 0), 1000.0, Material.diffuse((0.5, 0.5, 0.5))),
        ((0, 1, 0), 1.0, Material.glass(1.5)),
        ((0, 1, 0), -0.45, Material.glass(1.5)),
        ((4, 3, 0), 1.0, Material.metal((0.7, 0.6, 0.5), 0.0)),
        ((8, 5, 0), 1.0, Material.diffuse((0.4, 0.2, 0.1))),
        ((-8, 5, 0), 1.0, Material.metal((0.7, 0.7, 0.7), 0.1)),
        ((-8, 9, 0), 1.0, Material.diffuse((0.1, 0.4, 0.2))),
        ((12, 9, 4), 1.0, Material.diffuse((0.2, 0.1, 0.4))),
        ((12, 9, -4), 1.0, Material.metal((0.5, 0.5, 0.6), 0.0)),
        ((-12, 9, 4), 1.0, Material.diffuse((0.3, 0.3, 0.1))),
        ((0, 3, -4), 1.0, Material.diffuse((0.6, 0.2, 0.2))),
    ])
    cam, *_ = (presets.simple_camera(W, H),)
    opts = TraceOptions(max_depth=4)
    # preconditions: the analysis really is active with a near-only suffix
    split = pk._containable_split(scene, derive_camera(cam), opts)
    assert split is not None and split[1] < scene.count

    img = render_image_sharded_pallas(
        scene, cam, W, H, 2, key, make_mesh((2,), ("rows",)), opts
    )
    single = pk.render_image_pallas(
        scene, derive_camera(cam), W, H, 2, key, opts
    )
    np.testing.assert_allclose(
        np.asarray(img), np.asarray(single), atol=1e-6
    )


def test_sharded_progressive_static_scene_split(key):
    """make_sharded_step_fn with static scene/camera hints runs the
    split-scan analysis at build time; frames must match the hint-less
    step bitwise (the split scan is exact)."""
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene
    from raytracer_tpu.render import pallas_kernel as pk

    scene = make_scene(
        [((0, -1000, 0), 1000.0, Material.diffuse((0.5, 0.5, 0.5))),
         ((0, 1, 0), 1.0, Material.glass(1.5))]
        + [((4 * i, 3, 0), 1.0, Material.diffuse((0.4, 0.2, 0.1)))
           for i in range(1, 10)]
    )
    cam = presets.simple_camera(W, H)
    opts = TraceOptions(max_depth=3, backend="pallas")
    split = pk._containable_split(scene, derive_camera(cam), opts)
    assert split is not None and split[1] < scene.count

    mesh = make_mesh((2,), ("rows",))
    step_h = make_sharded_step_fn(
        W, H, mesh, spp=1, opts=opts, static_scene=scene,
        static_camera=cam,
    )
    step_0 = make_sharded_step_fn(W, H, mesh, spp=1, opts=opts)
    sa = shard_render_state(init_render_state(W, H, key), mesh)
    sb = shard_render_state(init_render_state(W, H, key), mesh)
    for _ in range(2):
        sa, _ = step_h(sa, scene, cam, DebugParams.none())
        sb, _ = step_0(sb, scene, cam, DebugParams.none())
    np.testing.assert_array_equal(np.asarray(sa.accum), np.asarray(sb.accum))


def test_sharded_pallas_drops_debug(setup, key):
    """enable_debug is a single-chip interactive feature: the sharded
    band helpers never populate the cursor/selection uniforms, so the
    sharded render must drop the flag (identical to debug-off) rather
    than paint garbage markers."""
    import dataclasses

    from raytracer_tpu.parallel.sharding import render_image_sharded_pallas

    scene, cam = setup
    opts = TraceOptions(max_depth=4)
    mesh = make_mesh((4,), ("rows",))
    off = render_image_sharded_pallas(scene, cam, W, H, 2, key, mesh, opts)
    on = render_image_sharded_pallas(
        scene, cam, W, H, 2, key, mesh,
        dataclasses.replace(opts, enable_debug=True),
    )
    assert np.array_equal(np.asarray(off), np.asarray(on))


def test_sharded_stratified_progressive_matches_single_chip(setup, key):
    """Stratified progressive over a pure-rows mesh = single-chip stratified
    progressive bitwise (fixed session key, frame-advanced sample offsets,
    same row-offset RNG streams) — the Pallas path; and the jnp-backend
    sharded stratified step runs and converges sanely."""
    from raytracer_tpu.progressive.step import make_step_fn

    scene, cam = setup
    opts = TraceOptions(max_depth=3, backend="pallas", sampler="stratified")
    mesh = make_mesh((4,), ("rows",))
    step_m = make_sharded_step_fn(W, H, mesh, spp=1, opts=opts)
    state_m = shard_render_state(init_render_state(W, H, key), mesh)
    step_1 = make_step_fn(W, H, spp=1, opts=opts)
    state_1 = init_render_state(W, H, key)
    for _ in range(2):
        state_m, _ = step_m(state_m, scene, cam, DebugParams.none())
        state_1, _ = step_1(state_1, scene, cam, DebugParams.none())
    assert np.array_equal(np.asarray(state_m.accum), np.asarray(state_1.accum))

    # jnp backend: frames must differ (offset advances) and stay finite
    opts_j = TraceOptions(max_depth=3, backend="jnp", sampler="stratified")
    step_j = make_sharded_step_fn(W, H, mesh, spp=2, opts=opts_j,
                                  should_average=False)
    state_j = shard_render_state(init_render_state(W, H, key), mesh)
    state_j, _ = step_j(state_j, scene, cam, DebugParams.none())
    f0 = np.asarray(state_j.accum).copy()
    state_j, _ = step_j(state_j, scene, cam, DebugParams.none())
    f1 = np.asarray(state_j.accum)
    assert not np.array_equal(f0, f1)
    assert np.isfinite(f1).all() and (f1 >= 0).all() and (f1 <= 1).all()


@pytest.mark.parametrize("config", ["demo", "cover"])
def test_sharded_rows_bitwise_single_device(config, key):
    """Every pixel is computed from absolute coordinates, so a rows-only
    mesh reproduces the single-device Pallas render bitwise, segments
    included (chip_smoke --multi checks the same on four cards)."""
    from raytracer_tpu.parallel.sharding import render_image_sharded_pallas
    from raytracer_tpu.render import pallas_kernel as pk

    scene, cam, *_ = presets.get_config(config, W, H)
    opts = TraceOptions(max_depth=6, russian_roulette_depth=3)
    img, st = render_image_sharded_pallas(
        scene, cam, W, H, 2, key, make_mesh((4,), ("rows",)), opts,
        return_stats=True,
    )
    single, st1 = pk.render_image_pallas(
        scene, derive_camera(cam), W, H, 2, key, opts, return_stats=True
    )
    np.testing.assert_array_equal(np.asarray(img), np.asarray(single))
    assert float(st["segments"]) == float(st1["segments"])
