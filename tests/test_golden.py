"""Golden-image regression tests.

The reference has no rendering correctness tests at all (SURVEY §4); here
every BASELINE scene is pinned against a stored render. Possible only
because our RNG is counter-based and deterministic — the reference's
time-seeded RNG could never be golden-tested.

Goldens: 64×36, 32 spp, depth 8, key 42, jnp tracer on CPU. Exact equality
is expected on the same stack; a small tolerance absorbs cross-version XLA
changes in transcendental codegen.
"""

import os

import jax
import numpy as np
import pytest

from raytracer_tpu.camera.camera import derive_camera
from raytracer_tpu.render.options import TraceOptions
from raytracer_tpu.render.tracer import render_image_jnp
from raytracer_tpu.scene import presets

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CONFIGS = ["two_sphere", "three_sphere", "demo", "dof"]


@pytest.mark.parametrize("name", CONFIGS)
def test_golden(name):
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64x36_spp32_d8.npy"))
    scene, cam, *_ = presets.get_config(name, 64, 36)
    img = np.asarray(
        render_image_jnp(
            scene,
            derive_camera(cam),
            64,
            36,
            32,
            jax.random.PRNGKey(42),
            TraceOptions(max_depth=8),
        )
    )
    np.testing.assert_allclose(img, golden, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["two_sphere", "demo"])
def test_pallas_statistically_matches_golden(name):
    """The pallas kernel (different RNG stream) converges to the same image:
    at 32 spp the mean absolute difference is pure noise, bounded tightly."""
    from raytracer_tpu.render.pallas_kernel import render_image_pallas

    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64x36_spp32_d8.npy"))
    scene, cam, *_ = presets.get_config(name, 64, 36)
    img = np.asarray(
        render_image_pallas(
            scene,
            derive_camera(cam),
            64,
            36,
            32,
            jax.random.PRNGKey(7),
            TraceOptions(max_depth=8),
        )
    )
    assert np.abs(img - golden).mean() < 0.02


def test_fullframe_ground_truth_integrity():
    """The committed full-frame jnp rr0 ground truth (the reference image
    BENCH_CONVERGENCE=golden and future regression rounds compare
    against, written by scripts/capture_convergence.py) must stay a
    plausible cover render: right shape/dtype, gamma-space range, no NaN
    channels, and the recorded global statistics (a corrupted or
    accidentally re-captured file fails here before it silently weakens
    the golden-gated checks)."""
    z = np.load(os.path.join(
        GOLDEN_DIR, "cover_jnp_rr0_500spp_f16.npz"
    ))
    img = z["image"]
    assert img.shape == (800, 1200, 3) and img.dtype == np.float16
    assert int(np.isnan(img).sum()) == 0
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    # captured stats (the capture session): mean luminance of the
    # cover scene's gamma image; generous band — catches wrong-scene /
    # wrong-space / truncated captures, not MC noise
    assert 0.55 < float(img.mean()) < 0.80, float(img.mean())
