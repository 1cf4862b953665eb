"""Ray pytree: batched origin + direction arrays (rebuilds src/ray.rs:3-11).

A ``Ray`` holds ``(..., 3)`` arrays, so one instance represents an entire
wavefront of rays — the whole pixel grid at once.
"""

from __future__ import annotations

from raytracer_tpu.core import pytree
import jax.numpy as jnp


@pytree.dataclass
class Ray:
    origin: jnp.ndarray  # (..., 3)
    direction: jnp.ndarray  # (..., 3) — NOT normalized (matches shader.frag:348)

    def at(self, t):
        """Point along the ray: origin + t * direction (src/ray.rs:9-11)."""
        return self.origin + jnp.asarray(t)[..., None] * self.direction
