"""raytracer_tpu — a progressive path-tracing framework in JAX.

A ground-up rebuild of austintheriot/ray-tracer-webgl (Rust/WASM host +
WebGL2 fragment-shader path tracer) as an idiomatic JAX/XLA/Pallas framework:

- One source of truth for the physics (JAX), replacing the reference's
  duplicated Rust (src/glsl.rs) + GLSL (static/shader.frag) implementations.
- Pure-functional pytree state replacing ``Arc<Mutex<State>>`` (src/lib.rs:23-25).
- Counter-based deterministic ``jax.random`` replacing the time-seeded
  hash-chain PRNG (static/shader.frag:11-36) — renders are bitwise reproducible.
- On-device accumulation buffer updated by a jitted ``step`` with buffer
  donation, replacing the ping-pong FBO pair + double render
  (src/webgl.rs:180-205).
- A Pallas kernel (compiled through Triton for the GPU) as the
  performance path for the per-pixel ray-bounce loop
  (static/shader.frag:297-339).
"""

from raytracer_tpu.core import vec, sampling
from raytracer_tpu.core.ray import Ray
from raytracer_tpu.scene.materials import DIFFUSE, METAL, GLASS, Material
from raytracer_tpu.scene.spheres import Scene, make_scene
from raytracer_tpu.scene import presets
from raytracer_tpu.camera.camera import CameraConfig, DerivedCamera, derive_camera
from raytracer_tpu.camera import controller
from raytracer_tpu.render.api import render_image, TraceOptions
from raytracer_tpu.progressive.state import RenderState, init_render_state
from raytracer_tpu.progressive.step import make_step_fn, accumulate

__version__ = "0.1.0"

__all__ = [
    "vec",
    "sampling",
    "Ray",
    "DIFFUSE",
    "METAL",
    "GLASS",
    "Material",
    "Scene",
    "make_scene",
    "presets",
    "CameraConfig",
    "DerivedCamera",
    "derive_camera",
    "controller",
    "render_image",
    "TraceOptions",
    "RenderState",
    "init_render_state",
    "make_step_fn",
    "accumulate",
]
