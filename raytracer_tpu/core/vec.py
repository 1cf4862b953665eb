"""Vectorized vec3 math over ``(..., 3)`` arrays.

Rebuilds the reference's scalar Vec3 math (src/math.rs:17-382) and the GLSL
built-ins used by the kernel (reflect/refract/mix) as batched jnp ops. All
functions broadcast over leading dimensions, so "one Vec3" and "a million
rays" share the same code path — the answer to the reference's
dual Rust/GLSL implementations (src/glsl.rs:1-2).
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def vec3(x, y, z, dtype=jnp.float32):
    """Build a (3,) vector (or stacked (..., 3) from broadcastable parts)."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)],
        axis=-1,
    )


def dot(a, b):
    """Batched dot product over the last axis (src/math.rs:56-58)."""
    return jnp.sum(a * b, axis=-1)


def length_squared(v):
    """|v|^2 (src/math.rs:52-54, static/shader.frag:110-112)."""
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v, eps: float = 0.0):
    """v / |v| (src/math.rs:68-73). ``eps`` guards 0-length vectors."""
    return v / jnp.maximum(length(v), eps)[..., None] if eps else v / length(v)[..., None]


def cross(a, b):
    """Cross product over the last axis (src/math.rs:60-66)."""
    return jnp.cross(a, b)


def reflect(v, n):
    """GLSL ``reflect``: v - 2*dot(v,n)*n (used at static/shader.frag:237, 273)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(unit_v, n, eta_ratio):
    """Snell refraction of a *unit* incident vector (static/shader.frag:275).

    Matches GLSL ``refract`` / RTiOW ch. 10: perpendicular + parallel
    decomposition. ``eta_ratio`` broadcasts over leading dims. The sqrt
    argument is clamped at 0 — callers only take this branch when refraction
    is possible (shader.frag:262, 272), so the clamp never changes a used
    value; it only keeps gradients/NaNs off the unused lane of the select.
    """
    eta = jnp.asarray(eta_ratio)[..., None]
    cos_theta = jnp.minimum(dot(-unit_v, n), 1.0)[..., None]
    r_out_perp = eta * (unit_v + cos_theta * n)
    k = jnp.maximum(0.0, 1.0 - length_squared(r_out_perp))
    r_out_parallel = -jnp.sqrt(k)[..., None] * n
    return r_out_perp + r_out_parallel


def mix(a, b, t):
    """GLSL ``mix``: linear blend (static/shader.frag:292)."""
    t = jnp.asarray(t)
    if t.ndim and t.shape[-1] != 1 and a.ndim and t.ndim < a.ndim:
        t = t[..., None]
    return a * (1.0 - t) + b * t


def near_zero(v, threshold: float = 1e-8):
    """True where every component's magnitude is < threshold.

    This is the *canonical RTiOW* form (uses abs). The reference carries a
    signed-comparison bug in both its implementations (no ``abs`` —
    src/math.rs:111-114, static/shader.frag:198-201); neither is ever called
    on the hot path (the shader's guard is commented out,
    static/shader.frag:222-225), so we provide the correct form and
    :func:`near_zero_signed` for the quirk.
    """
    return jnp.all(jnp.abs(v) < threshold, axis=-1)


def near_zero_signed(v, threshold: float = 1e-5):
    """The reference's signed (abs-less) near-zero test (shader.frag:198-201)."""
    return jnp.all(v < threshold, axis=-1)


def degrees_to_radians(deg):
    """src/math.rs:376-378."""
    return deg * (math.pi / 180.0)
