"""Core math layer: vec3 helpers, rays, and sampling primitives.

Replacement for the reference's Rust ``src/math.rs`` (Vec3 with 24
operator-overload impls) and ``src/ray.rs``: instead of a scalar Vec3 class we
operate on ``(..., 3)`` jnp arrays so every op is batched over all rays/pixels
at once.
"""
