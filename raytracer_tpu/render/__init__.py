"""Render layer: the path-tracing kernels.

Two interchangeable implementations behind one signature
(``trace → (H, W, 3) linear color``):

- :mod:`raytracer_tpu.render.tracer` — the reference implementation in plain
  batched jnp (runs anywhere, including the CPU test backend),
- :mod:`raytracer_tpu.render.pallas_kernel` — the Pallas-Triton kernel, the
  performance path on the GPU.

Both rebuild static/shader.frag:106-383 (camera ray-gen → hit_world →
scatter → sky, with spp averaging and gamma). The jnp tracer runs it in
wavefront style, every stage over the whole ray batch with live-lane
masks; the kernel keeps one thread per pixel, as the fragment shader
does, and regenerates a finished path in place.
"""

from raytracer_tpu.render.api import render_image, TraceOptions

__all__ = ["render_image", "TraceOptions"]
