"""Static trace options + the device-side debug parameter pytree."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from raytracer_tpu.core import pytree
from raytracer_tpu.scene.spheres import NO_SELECTED_OBJECT_ID

# Kernel constants (static/shader.frag:4-6).
MIN_T = 0.001
MAX_T = 1e5


@dataclasses.dataclass(frozen=True)
class TraceOptions:
    """Static (compile-time) tracing options.

    ``exhaust_black`` / ``near_zero_guard`` select between canonical-RTiOW
    physics and two documented reference quirks:

    - the reference returns the *accumulated throughput* when the bounce
      budget is exhausted instead of black (static/shader.frag:338, vs. the
      book's ``return color(0,0,0)``). Default False = reference behavior.
    - the book re-aims near-zero Lambertian scatter directions at the normal;
      the reference has this guard commented out (static/shader.frag:222-225).
      Default False = reference behavior.
    """

    max_depth: int = 8
    exhaust_black: bool = False
    near_zero_guard: bool = False
    gamma: bool = True
    enable_debug: bool = False
    backend: str = "auto"  # 'auto' | 'jnp' | 'pallas'
    #: 0 disables. If > 0, from that bounce onward rays terminate with
    #: probability 1 - max(throughput) and survivors are reweighted by
    #: 1/p — unbiased Russian roulette (beyond the reference/book-1; cuts
    #: the deep glass tail that dominates high-depth renders)
    russian_roulette_depth: int = 0
    #: adaptive sampling (0 disables — the default; the fixed-spp render
    #: is the parity/benchmark path). When > 0, the Pallas render stops
    #: sampling a pixel once its 95% confidence interval on mean
    #: luminance is within ``adaptive_tolerance`` (relative, +0.02
    #: absolute floor) — decided between spp chunks from the per-pixel
    #: (n, Σlum, Σlum²) sums the kernel emits; a converged pixel gets a
    #: zero sample budget for the next chunk. Per-pixel sample counts
    #: vary; the image is the per-pixel mean (the sequential stopping
    #: rule is the standard mildly-biased production-renderer trade).
    #: Beyond the reference (which has no adaptive mode).
    adaptive_tolerance: float = 0.0
    #: samples per adaptive chunk (0 = pallas_kernel.ADAPTIVE_AUTO_CHUNK).
    #: Chunk size is the per-pixel overshoot floor — a pixel can't stop
    #: mid-chunk — traded against one launch and one decision per chunk.
    adaptive_chunk_spp: int = 0
    #: camera-sample sequencer: 'random' (independent uniform draws — the
    #: parity/benchmark default) or 'stratified' (per-pixel 4-D R2
    #: low-discrepancy points for the sub-pixel jitter + lens-disk draws,
    #: with a random Cranley-Patterson rotation per pixel —
    #: core/sampling.py). Marginal distributions are identical, so the
    #: estimator stays unbiased and the physics is untouched; the joint
    #: spread across a pixel's samples is what improves, cutting AA/DoF
    #: variance. Progressive steps hold the session key fixed and advance
    #: the absolute sample index by spp per frame, so an accumulation
    #: session walks each pixel's R2 sequence in order (every prefix
    #: low-discrepancy). Progressive steps strip ``adaptive_tolerance``
    #: (an offline mode — per-frame adaptive renders would be mis-weighted
    #: by the running average) but keep the sampler. The FIRST bounce's
    #: diffuse direction and glass roll are stratified too (R2_ALPHAS_B0 —
    #: the dominant path-space dims, measured 1.4-2.4x MSE cut on diffuse
    #: scenes); deeper bounces stay random. Beyond the reference.
    sampler: str = "random"
    #: static scene analysis for the Pallas scan: spheres that provably
    #: cannot contain a ray origin (not glass, no other sphere's surface
    #: inside them, camera outside) skip the far-root fallback of the
    #: quadratic — the reference's near→far logic (shader.frag:157-165)
    #: only ever selects a far root when the ray starts inside the sphere.
    #: Applies to concrete (non-traced) scenes on the offline path.
    split_scan: bool = True

    def __post_init__(self):
        if self.max_depth < 1:
            # depth 0 would break the Pallas kernel's per-bounce RNG
            # counter layout (bounce draws would alias the next sample's
            # camera block) and diverge from the jnp tracer's flat-white
            raise ValueError(f"max_depth must be >= 1, got {self.max_depth}")
        if self.sampler not in ("random", "stratified"):
            raise ValueError(
                f"sampler must be 'random' or 'stratified', got "
                f"{self.sampler!r}"
            )


@pytree.dataclass
class DebugParams:
    """Device-side debug inputs (the u_cursor_point / u_selected_object
    uniforms, static/shader.frag:101-102)."""

    cursor_point: jnp.ndarray  # (3,)
    selected_object: jnp.ndarray  # () int32

    @classmethod
    def none(cls) -> "DebugParams":
        return cls(
            cursor_point=jnp.zeros((3,), jnp.float32),
            selected_object=jnp.asarray(NO_SELECTED_OBJECT_ID, jnp.int32),
        )
