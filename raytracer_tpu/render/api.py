"""Unified render entry point: one signature, two backends.

``render_image(scene, camera_config, ...)`` dispatches to the plain-jnp
tracer or the Pallas-Triton kernel. 'auto' picks the kernel on the GPU
and the jnp tracer on the CPU (where Pallas only runs interpreted, which
is for kernel tests, not rendering).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from raytracer_tpu.camera.camera import CameraConfig, derive_camera
from raytracer_tpu.render.options import DebugParams, TraceOptions
from raytracer_tpu.render.tracer import render_image_jnp
from raytracer_tpu.scene.spheres import Scene

#: what 'auto' resolves to per platform. The GPU entry is fixed from the
#: kernel-vs-XLA measurement on the card recorded in PERF.md.
AUTO_BACKEND = {"gpu": "pallas", "cpu": "jnp"}


def resolve_backend(backend: str) -> str:
    """Resolve 'auto' to a concrete backend for the default platform.
    Shared by the offline entry point, the progressive step and the
    viewer/engine so every 'auto' user gets the same choice."""
    if backend != "auto":
        return backend
    platform = jax.default_backend()
    if platform not in AUTO_BACKEND:
        raise ValueError(f"no render backend for platform {platform!r}")
    return AUTO_BACKEND[platform]


@functools.lru_cache(maxsize=32)
def _jitted_jnp(width: int, height: int, spp: int, opts: TraceOptions,
                with_debug: bool):
    """One jitted jnp render per static configuration."""

    def fn(scene, dcam, key, debug):
        return render_image_jnp(
            scene, dcam, width, height, spp, key, opts,
            debug if with_debug else None, return_stats=True,
        )

    return jax.jit(fn)


def render_image(
    scene: Scene,
    camera: CameraConfig,
    width: int,
    height: int,
    spp: int,
    key,
    opts: TraceOptions | None = None,
    debug: DebugParams | None = None,
    return_stats: bool = False,
):
    """Render ``spp`` samples/pixel. Returns (H, W, 3) f32 in [0,1],
    row 0 at the image bottom (GL orientation; io flips on export)."""
    if spp < 1:
        # both backends finalize with a 1/spp scale — fail clearly
        raise ValueError(f"spp must be >= 1, got {spp}")
    opts = opts or TraceOptions()
    dcam = derive_camera(camera)
    backend = resolve_backend(opts.backend)
    if backend == "pallas":
        from raytracer_tpu.render.pallas_kernel import render_image_pallas

        out = render_image_pallas(
            scene, dcam, width, height, spp, key, opts, debug,
            return_stats=return_stats,
        )
    elif backend == "jnp":
        fn = _jitted_jnp(width, height, spp,
                         dataclasses.replace(opts, backend="jnp"),
                         debug is not None)
        image, stats = fn(scene, dcam, key,
                          debug if debug is not None else DebugParams.none())
        out = (image, stats) if return_stats else image
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return jax.block_until_ready(out)
