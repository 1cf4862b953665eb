"""Engine tests: the frame-loop semantics of src/lib.rs:61-107 — pause
gating, spp boost, accumulation reset on camera change, resize debounce,
save, fps telemetry — headless."""

import numpy as np

from raytracer_tpu.app.engine import Engine
from raytracer_tpu.interact.appstate import (
    AppState,
    adjusted_screen_dimensions,
    cameras_equal,
)
from raytracer_tpu.scene import presets

W, H = 48, 27


def make_engine(**kw):
    scene = presets.two_sphere_scene()
    cam = presets.simple_camera(W, H)
    defaults = dict(width=W, height=H, spp=1, max_depth=3, backend="jnp")
    defaults.update(kw)
    return Engine(scene, cam, **defaults)


def test_paused_renders_only_first_frame():
    """Paused: only frame 0 renders (the quality still), then nothing
    (src/lib.rs:77-82)."""
    e = make_engine()
    assert e.app.is_paused
    assert e.tick(16.0) is True  # first frame renders even paused
    assert e.app.render_count == 1
    assert e.tick(32.0) is False
    assert e.tick(48.0) is False
    assert e.app.render_count == 1


def test_paused_spp_boost():
    """spp floors at 25 while paused (src/webgl.rs:342-347)."""
    e = make_engine()
    assert e.app.effective_spp() == 25
    e.set_paused(False)
    assert e.app.effective_spp() == 1


def test_unpaused_renders_continuously():
    e = make_engine()
    e.set_paused(False)
    for i in range(3):
        assert e.tick(16.0 * (i + 1)) is True
    assert e.app.render_count == 3


def test_camera_change_resets_accumulation():
    e = make_engine()
    e.set_paused(False)
    e.run(3)
    assert e.app.render_count == 3
    e.handle_wheel(+1.0)  # fov zoom → update_pipeline change → reset
    assert int(e.render_state.render_count) == 0
    e.tick(1000.0)
    assert e.app.render_count == 1


def test_wasd_moves_and_resets():
    e = make_engine()
    e.set_paused(False)
    e.run(2)
    e.handle_key("w", True)
    before = np.asarray(e.camera.origin).copy()
    e.tick(2000.0)
    after = np.asarray(e.camera.origin)
    assert not np.array_equal(before, after)
    e.handle_key("w", False)
    assert e.app.keydown_map.all_false()


def test_escape_pauses():
    e = make_engine()
    e.set_paused(False)
    e.handle_key("escape", True)
    assert e.app.is_paused


def test_save_produces_png():
    e = make_engine()
    e.request_save()
    e.tick(16.0)
    assert len(e._saved_images) == 1
    assert e._saved_images[0][:8] == b"\x89PNG\r\n\x1a\n"
    assert not e.app.should_save  # one-shot (src/dom.rs:127-128)


def test_save_while_paused_renders():
    e = make_engine()
    e.tick(16.0)  # frame 0
    assert e.tick(32.0) is False  # paused, no render
    e.request_save()
    assert e.tick(48.0) is True  # save forces a render (src/lib.rs:78)
    assert len(e._saved_images) == 1


def test_resize_debounce_and_cap():
    e = make_engine()
    e.set_paused(False)
    e.tick(16.0)
    e.handle_resize(4000, 2000, now_ms=100.0)
    e.tick(200.0)  # within 500ms debounce → not applied
    assert e.app.width == W
    e.tick(700.0)  # past debounce
    assert e.app.width == 1280  # MAX_CANVAS_SIZE cap (src/dom.rs:13)
    assert e.app.height == 640
    assert e.render_state.accum.shape == (640, 1280, 3)


def test_adjusted_screen_dimensions_landscape_portrait():
    assert adjusted_screen_dimensions(2560, 1440) == (1280, 720)
    assert adjusted_screen_dimensions(800, 600) == (800, 600)
    # portrait branch: reference caps by raw WIDTH (quirk, src/dom.rs:286)
    w, h = adjusted_screen_dimensions(600, 900)
    assert (w, h) == (400, 600)


def test_fps_window_and_throttle():
    app = AppState(width=4, height=4)
    for i in range(60):
        app.update_moving_fps(now_ms=i * 10.0, dt_ms=10.0)
    assert abs(app.prev_fps.mean() - 100.0) < 1e-6
    assert app.average_fps(now_ms=1000.0) == 100.0
    assert app.average_fps(now_ms=1100.0) is None  # 250ms throttle
    assert app.average_fps(now_ms=1300.0) == 100.0


def test_framebuffer_matches_state():
    e = make_engine()
    e.tick(16.0)
    fb = e.framebuffer()
    assert fb.shape == (H, W, 3)
    np.testing.assert_array_equal(fb, np.asarray(e.render_state.accum))


def test_reset_restores_scene_and_camera():
    """Reset = State::default() (src/dom.rs:42-46): an edited scene and a
    moved camera both come back to construction-time defaults and
    accumulation restarts."""
    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    eng = Engine(scene, cam, 32, 16, max_depth=2)
    eng.tick(0.0)
    # move the camera and swap in a different scene
    eng.handle_mouse_move(40.0, 25.0)
    other, *_ = presets.get_config("three_sphere", 32, 16)
    eng.scene = other
    eng.tick(16.0)

    eng.reset()
    assert eng.scene is scene
    assert cameras_equal(eng.camera, cam)
    assert eng.app.render_count == 0
    assert float(eng.render_state.render_count) == 0.0


def test_resize_updates_camera_aspect():
    """The reference's update_pipeline re-derives aspect_ratio from the
    resized canvas (src/state.rs:323, 364-398); without it every
    post-resize frame is anamorphically distorted."""
    e = make_engine()
    e.set_paused(False)
    e.tick(0.0)
    e.handle_resize(200.0, 200.0, now_ms=16.0)
    # debounce: resize applies 500 ms after the request
    e.tick(600.0)
    assert e.app.width == e.app.height == 200
    assert float(e.camera.aspect_ratio) == 1.0
    # and the engine still renders at the new shape
    assert e.tick(616.0)
    assert e.framebuffer().shape == (200, 200, 3)


def test_request_save_with_path(tmp_path):
    """'x' in the viewer requests a save that runs AFTER the next render
    (src/dom.rs:115-124) at the paused >=25-spp floor."""
    import os

    e = make_engine()
    e.set_paused(True)
    out = str(tmp_path / "save.png")
    e.request_save(out)
    assert e.tick(16.0)  # paused but should_save forces the render
    assert os.path.exists(out)
    assert e._save_path is None  # one-shot


def test_debug_toggle_resets_accumulation():
    # the overlay is traced into the frame, so toggling must restart
    # accumulation (otherwise it blends in at 1/(render_count+1) weight)
    e = make_engine()
    e.set_paused(False)
    e.run(3)
    assert e.app.render_count == 3
    e.set_debugging(True)
    assert e.app.enable_debugging
    assert int(e.render_state.render_count) == 0
    assert e.app.render_count == 0
    assert e.app.should_render
    e.run(2)
    n = e.app.render_count
    e.set_debugging(True)  # no-op: same value must not reset
    assert e.app.render_count == n
    e.set_debugging(False)
    assert e.app.render_count == 0


def test_step_cache_is_lru_bounded():
    """_step_cache must not grow without bound across resizes:
    it evicts least-recently-used beyond _STEP_CACHE_MAX, and a hit
    refreshes recency. Uses _step_fn directly (no compile: make_step_fn is
    lazy until called)."""
    e = make_engine()
    cap = Engine._STEP_CACHE_MAX
    for i in range(cap + 4):
        e.app.width = W + i  # fake resize: new static key
        e._step_fn(1)
    assert len(e._step_cache) == cap
    oldest_live = next(iter(e._step_cache))
    e.app.width = oldest_live[0]
    e._step_fn(1)  # hit → moves to most-recent
    assert next(iter(e._step_cache)) != oldest_live
    assert len(e._step_cache) == cap
