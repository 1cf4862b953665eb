"""The interactive engine: a headless rebuild of the reference's frame loop.

Maps 1:1 onto the rAF closure of src/lib.rs:61-107 —

    tick(now):                          # rAF callback
      update_position (fly-cam)         # src/state.rs:411-441
      autofocus / picking               # src/state.rs:453-471
      should_render gate                # src/lib.rs:77-82
      resize debounce                   # src/lib.rs:85-90
      update_render_globals + fps       # src/state.rs:443-450, 400-409
      device step (trace + accumulate)  # uniforms+draw+draw → ONE jitted step
      save_image if flagged             # src/dom.rs:126-143
      fps indicator                     # src/dom.rs:145-158

— but with all per-frame math on-device and zero host round-trips in steady
state. Input events go through the same command-queue pattern the reference
uses (handlers mutate host state; the next tick consumes it).

The reference re-renders the whole scene twice per frame when averaging
(src/webgl.rs:196-204); this engine traces once. Resolution changes re-jit
(the analog of reallocating the ping-pong textures, src/state.rs:379-397);
camera/scene changes never do.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import numpy as np

from raytracer_tpu.camera import controller
from raytracer_tpu.camera.camera import CameraConfig
from raytracer_tpu.interact.appstate import AppState, cameras_equal
from raytracer_tpu.interact.picking import update_cursor_state
from raytracer_tpu.progressive.state import (
    RenderState,
    init_render_state,
    reset_accumulation,
)
from raytracer_tpu.progressive.step import make_step_fn
from raytracer_tpu.render.options import DebugParams, TraceOptions
from raytracer_tpu.scene.spheres import NO_SELECTED_OBJECT_ID, Scene


class Engine:
    """Owns the device pytrees + host AppState and advances one frame per
    :meth:`tick`."""

    def __init__(
        self,
        scene: Scene,
        camera: CameraConfig,
        width: int,
        height: int,
        spp: int = 1,
        max_depth: int = 8,
        backend: str = "auto",
        seed: int = 0,
        enable_debugging: bool = False,
        exhaust_black: bool = False,
        russian_roulette_depth: int = 0,
        sampler: str = "random",
    ):
        self.scene = scene
        self.camera = camera
        # construction-time defaults for Reset (src/dom.rs:42-46 restores
        # State::default() — scene AND camera, src/state.rs:96-315)
        self._default_scene = scene
        self._default_camera = camera
        self.app = AppState(
            width=width,
            height=height,
            samples_per_pixel=spp,
            max_depth=max_depth,
            enable_debugging=enable_debugging,
        )
        self.backend = backend
        self.exhaust_black = exhaust_black
        self.russian_roulette_depth = russian_roulette_depth
        self.sampler = sampler
        self._seed = seed
        self.render_state: RenderState = init_render_state(
            width, height, jax.random.PRNGKey(seed)
        )
        self._step_cache: dict = {}
        self._saved_images: list = []
        self.on_save: Optional[Callable[[np.ndarray], None]] = None
        self._segments_dev = None  # device scalar: no per-frame host sync
        # host-side fold of the device counter: every _SEG_FOLD_FRAMES the
        # device scalar is drained into this float (one cheap sync), so a
        # device fault loses at most the un-folded tail instead of zeroing
        # the whole running total
        self._segments_host = 0.0
        self._segments_unfolded = 0
        self._save_path: Optional[str] = None

    _SEG_FOLD_FRAMES = 64
    #: LRU bound on compiled step functions. Each (w, h, spp, depth, flags)
    #: combination holds a compiled XLA executable; an interactive session
    #: with many resizes would otherwise grow without bound.
    #: 8 covers pause/unpause (spp floor swap), a debug toggle, and a few
    #: live window sizes without ever re-compiling in steady state.
    _STEP_CACHE_MAX = 8

    @property
    def total_segments(self) -> float:
        """Traced ray-bounce segments so far (one blocking device→host
        read per access — accumulation itself stays on device)."""
        if self._segments_dev is None:
            return self._segments_host
        return self._segments_host + float(self._segments_dev)

    # --- step-function management (recompile only on static changes) -----

    def _step_fn(self, spp: int):
        key = (self.app.width, self.app.height, spp, self.app.max_depth,
               self.app.should_average, self.app.enable_debugging,
               self.app.last_frame_weight, self.app.max_render_count)
        if key in self._step_cache:
            # LRU refresh: dicts iterate in insertion order, so re-insert
            # on hit and evict the stalest entry on overflow
            self._step_cache[key] = self._step_cache.pop(key)
        else:
            opts = TraceOptions(
                max_depth=self.app.max_depth,
                enable_debug=self.app.enable_debugging,
                exhaust_black=self.exhaust_black,
                backend=self.backend,
                russian_roulette_depth=self.russian_roulette_depth,
                sampler=self.sampler,
            )
            self._step_cache[key] = make_step_fn(
                self.app.width,
                self.app.height,
                spp=spp,
                opts=opts,
                should_average=self.app.should_average,
                last_frame_weight=self.app.last_frame_weight,
                max_render_count=self.app.max_render_count,
            )
            while len(self._step_cache) > self._STEP_CACHE_MAX:
                self._step_cache.pop(next(iter(self._step_cache)))
        return self._step_cache[key]

    def _debug_params(self) -> DebugParams:
        import jax.numpy as jnp

        return DebugParams(
            cursor_point=jnp.asarray(self.app.cursor_point, jnp.float32),
            selected_object=jnp.asarray(self.app.selected_object, jnp.int32),
        )

    # --- input events (src/dom.rs handlers) ------------------------------

    def handle_wheel(self, delta_y_sign: float) -> None:
        self._apply_camera(controller.zoom(self.camera, delta_y_sign))

    def handle_mouse_move(self, dx: float, dy: float) -> None:
        cam = controller.mouse_look(
            self.camera, dx, dy, self.app.look_sensitivity
        )
        self._apply_camera(cam, update_cursor=True)

    def handle_key(self, name: str, down: bool) -> None:
        if name == "escape" and down:
            self.set_paused(True)
            return
        if hasattr(self.app.keydown_map, name):
            setattr(self.app.keydown_map, name, down)

    def handle_resize(self, raw_w: float, raw_h: float, now_ms=None) -> None:
        self.app.request_resize(now_ms if now_ms is not None else _now_ms())
        self._pending_resize = (raw_w, raw_h)

    def request_save(self, path: Optional[str] = None) -> None:
        """handle_save_image (src/dom.rs:118-124): flag a save that runs
        immediately AFTER the next render — 'so that the canvas isn't
        blank' — with the paused ≥25-spp quality floor applied."""
        self.app.should_render = True
        self.app.should_save = True
        self._save_path = path

    def reset(self) -> None:
        """handle_reset (src/dom.rs:42-46): restore ``State::default()`` —
        the construction-time scene and camera (src/state.rs:96-315) —
        then restart accumulation. The default camera picks up the
        CURRENT render dims' aspect, as the reference's default State
        derives its pipeline from the current window (src/state.rs:323)."""
        import jax.numpy as jnp

        self.scene = self._default_scene
        self.camera = self._default_camera.replace(
            aspect_ratio=jnp.asarray(
                self.app.width / self.app.height, jnp.float32
            )
        )
        self.app.selected_object = NO_SELECTED_OBJECT_ID
        self.app.cursor_point = (0.0, 0.0, 0.0)
        self.render_state = reset_accumulation(self.render_state)
        self.app.render_count = 0
        self.app.should_render = True

    def set_paused(self, paused: bool) -> None:
        self.app.is_paused = paused
        if not paused:
            self.app.should_render = True

    def set_debugging(self, enabled: bool) -> None:
        """Toggle the in-kernel debug overlay (cursor marker + selection
        outline, static/shader.frag:306-318). The overlay is part of the
        traced frame, so accumulation restarts — otherwise the marker
        would blend in at 1/(render_count+1) weight and ghost after
        toggling off."""
        if enabled == self.app.enable_debugging:
            return
        self.app.enable_debugging = enabled
        self.render_state = reset_accumulation(self.render_state)
        self.app.render_count = 0
        self.app.should_render = True

    # --- camera mutation with change-detection ---------------------------

    def _apply_camera(self, new_cam: CameraConfig, update_cursor=False) -> None:
        if update_cursor or self.app.enable_debugging:
            new_cam, cursor_point, selected = update_cursor_state(
                self.scene, new_cam
            )
            self.app.cursor_point = tuple(np.asarray(cursor_point))
            self.app.selected_object = int(selected)
        if not cameras_equal(new_cam, self.camera):
            # update_pipeline's diff-detect (src/state.rs:343-346)
            self.camera = new_cam
            self.render_state = reset_accumulation(self.render_state)
            self.app.render_count = 0
            self.app.should_render = True

    # --- the frame loop ----------------------------------------------------

    def tick(self, now_ms: Optional[float] = None) -> bool:
        """One frame. Returns True if a render was issued."""
        now = now_ms if now_ms is not None else _now_ms()
        dt = now - self.app.prev_now if self.app.prev_now else 16.0

        # fly-cam (src/lib.rs:73 → src/state.rs:411-441)
        if not self.app.keydown_map.all_false():
            cam = controller.update_position(self.camera, self.app.keydown_map, dt)
            self._apply_camera(cam, update_cursor=True)

        should_render = self.app.compute_should_render()

        # resize debounce (src/lib.rs:85-90)
        if self.app.resize_due(now) and getattr(self, "_pending_resize", None):
            raw_w, raw_h = self._pending_resize
            self._pending_resize = None
            w, h = self.app.apply_resize(raw_w, raw_h, now)
            # re-derive the camera viewport for the new dims — the
            # reference's update_pipeline recomputes aspect_ratio from the
            # resized canvas (src/state.rs:323, 364-398); without this
            # every post-resize frame is anamorphically distorted
            import jax.numpy as jnp

            self.camera = self.camera.replace(
                aspect_ratio=jnp.asarray(w / h, jnp.float32)
            )
            self.render_state = init_render_state(
                w, h, self.render_state.key
            ).replace(frame=self.render_state.frame)
            self.app.render_count = 0
            self.app.should_render = True

        if not should_render:
            self.app.prev_now = now
            return False

        self.app.update_render_globals()
        self.app.update_moving_fps(now, dt)

        step = self._step_fn(self.app.effective_spp())
        try:
            self.render_state, aux = step(
                self.render_state, self.scene, self.camera,
                self._debug_params(),
            )
            # device-side accumulation: no per-frame host round trip
            # (total_segments syncs only when read)
            seg = aux["segments"]
            self._segments_dev = (
                seg if self._segments_dev is None
                else self._segments_dev + seg
            )
            self._segments_unfolded += 1
            if self._segments_unfolded >= self._SEG_FOLD_FRAMES:
                # drain to host so a later device fault can't zero the
                # running total; the viewer already syncs per frame for
                # display, so this read is effectively free
                self._segments_host += float(self._segments_dev)
                self._segments_dev = None
                self._segments_unfolded = 0
        except Exception as e:
            from raytracer_tpu.utils.resilience import is_device_fault

            if not is_device_fault(e):
                raise
            # device fault (worker crash/restart): the accumulation buffer
            # died with the worker — the GL-context-loss analog. Recover by
            # rebuilding device state and restarting accumulation; the next
            # tick re-renders. (src/webgl.rs has no equivalent; the browser
            # would reload the page.)
            import logging

            logging.getLogger(__name__).warning(
                "device fault during frame step (%s); resetting device "
                "state and restarting accumulation", str(e)[:120],
            )
            self._step_cache.clear()
            # the device scalar died with the worker; the host fold keeps
            # everything up to the last drain
            self._segments_dev = None
            self._segments_unfolded = 0
            # the rebuild itself issues device ops — if the worker is
            # still restarting they fault too, so run it under the same
            # sleep-and-retry policy as whole-render recovery
            from raytracer_tpu.utils.resilience import retry_on_device_fault

            self.render_state = retry_on_device_fault(
                lambda: init_render_state(
                    self.app.width, self.app.height,
                    jax.random.PRNGKey(self._seed),
                )
            )()
            self.app.render_count = 0
            self.app.should_render = True
            return False

        if self.app.should_save:
            self.app.should_save = False
            path, self._save_path = self._save_path, None
            self.save_image(path)
        return True

    # --- output ------------------------------------------------------------

    def framebuffer(self) -> np.ndarray:
        """Current accumulated image (H, W, 3) f32, GL row order."""
        return np.asarray(self.render_state.accum)

    def save_image(self, path: Optional[str] = None):
        """PNG export of the current framebuffer (src/dom.rs:126-143)."""
        from raytracer_tpu.app import io

        img = self.framebuffer()
        if path is not None:
            io.save_png(path, img)
            return path
        data = io.encode_png(img)
        self._saved_images.append(data)
        if self.on_save:
            self.on_save(img)
        return data

    def run(self, n_frames: int, frame_time_ms: float = 16.0) -> None:
        """Drive n frames with a synthetic clock (headless)."""
        start = self.app.prev_now or 0.0
        for i in range(n_frames):
            self.tick(start + (i + 1) * frame_time_ms)

    def fps(self) -> float:
        return float(self.app.prev_fps.mean())


def _now_ms() -> float:
    return time.monotonic() * 1000.0
