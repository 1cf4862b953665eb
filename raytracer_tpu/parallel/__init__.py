"""Multi-device scaling via jax.sharding + shard_map over a device mesh.

The reference is single-GPU with zero collectives (SURVEY §5): its only
parallelism is the rasterizer fanning the fragment shader over pixels. The
scaling story here is explicit:

- pixels are embarrassingly parallel → shard the pixel grid's row axis over
  a ``rows`` mesh axis with NO collectives during tracing,
- samples-per-pixel shard over an ``spp`` mesh axis with ONE ``psum`` per
  frame (the linear-color mean),
- the accumulation buffer stays sharded over rows across frames, so
  progressive mode is also collective-free along rows.
"""

from raytracer_tpu.parallel.sharding import (
    make_mesh,
    render_image_sharded,
    render_image_sharded_pallas,
    make_sharded_step_fn,
)

__all__ = [
    "make_mesh",
    "render_image_sharded",
    "render_image_sharded_pallas",
    "make_sharded_step_fn",
]
