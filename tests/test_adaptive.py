"""Adaptive per-pixel convergence (interpret mode): quality vs the
fixed-spp render, early termination actually saving samples, and
determinism — a capability beyond the reference."""

import dataclasses

import jax
import numpy as np
import pytest

from raytracer_tpu.camera.camera import derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions
from raytracer_tpu.scene import presets

W, H = 128, 32


@pytest.fixture
def forced_chunks(monkeypatch):
    # multi-chunk schedules at test sizes, and pixels allowed to converge
    # at test spp (production MIN_N is 64)
    monkeypatch.setattr(pk, "ADAPTIVE_AUTO_CHUNK", 3)
    monkeypatch.setattr(pk, "ADAPTIVE_MIN_N", 4)


def _render(opts, spp=27, key=None):
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    dcam = derive_camera(cam)
    key = key if key is not None else jax.random.PRNGKey(0)
    return pk.render_image_pallas(
        scene, dcam, W, H, spp, key, opts, return_stats=True
    )


def test_adaptive_converges_and_saves_samples(forced_chunks):
    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    img_a, stats = _render(opts)
    img_a = np.asarray(img_a)
    assert img_a.shape == (H, W, 3)
    assert np.isfinite(img_a).all()
    mean_spp = float(stats["mean_spp"])
    # early termination really happened, but nothing under-sampled the
    # first chunks
    assert 3.0 <= mean_spp < 27.0, mean_spp
    # quality: matches the fixed-27-spp render within MC noise + tol
    img_f = np.asarray(
        _render(TraceOptions(max_depth=4))[0]
    )
    assert np.abs(img_a - img_f).mean() < 0.04


def test_adaptive_deterministic(forced_chunks):
    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    a, sa = _render(opts)
    b, sb = _render(opts)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(sa["segments"]) == float(sb["segments"])


def test_adaptive_tighter_tolerance_more_samples(forced_chunks):
    loose = float(_render(
        TraceOptions(max_depth=4, adaptive_tolerance=0.2)
    )[1]["mean_spp"])
    tight = float(_render(
        TraceOptions(max_depth=4, adaptive_tolerance=0.01)
    )[1]["mean_spp"])
    assert tight >= loose


def test_adaptive_strips_on_single_chunk():
    # default chunk: spp fits no two chunks -> fixed-spp path, no
    # mean_spp in stats, identical to tolerance-0 render
    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    img_a, stats = _render(opts, spp=4)
    assert "mean_spp" not in stats
    img_f, _ = _render(TraceOptions(max_depth=4), spp=4)
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_f))


def test_adaptive_stratified(forced_chunks):
    # the offline adaptive path composes with the stratified sampler:
    # each pixel consumes a PREFIX of its R2 sequence (every prefix is
    # low-discrepancy), so early termination needs no special handling
    opts = TraceOptions(
        max_depth=4, adaptive_tolerance=0.05, sampler="stratified"
    )
    img_a, stats = _render(opts)
    img_a = np.asarray(img_a)
    assert np.isfinite(img_a).all()
    assert 3.0 <= float(stats["mean_spp"]) < 27.0
    # deterministic
    img_b, stats_b = _render(opts)
    np.testing.assert_array_equal(img_a, np.asarray(img_b))
    # quality vs the fixed-spp STRATIFIED render (same sampler, so the
    # residual is the early-termination noise only)
    img_f = np.asarray(
        _render(TraceOptions(max_depth=4, sampler="stratified"))[0]
    )
    assert np.abs(img_a - img_f).mean() < 0.04


def test_chunk_mean_ci_sees_stratification():
    # the between-chunk-mean estimator: pixels whose PER-SAMPLE variance
    # is large (so the 1.96·sqrt(var/n) CI fails the tolerance) still
    # converge when their chunk means are tight — the stratified-sampler
    # case the per-sample variance cannot see. n_c < 3 can't form a
    # t-CI, so the same tight chunk stats with 2 chunks must NOT stop.
    import jax.numpy as jnp

    P = 1024
    n = jnp.full((P,), float(pk.ADAPTIVE_MIN_N))
    mean = 0.5
    # per-sample variance 0.25 -> ci_sample = 1.96*sqrt(.25/64) = 0.1225
    # vs tol*(mean+floor) = 0.05*(0.52) = 0.026: NOT converged
    acc = jnp.stack([
        n * mean, n * mean, n * mean,          # rgb sums
        n,                                     # n
        n * mean,                              # lum sum
        n * (mean * mean + 0.25),              # lum^2 sum
    ])

    def n_converged(chunk_stats):
        return int(pk._converged(acc, 0.05, chunk_stats).sum())

    assert n_converged(None) == 0  # sample-CI alone: all unconverged
    # 8 chunks whose means are essentially identical -> s2 ~ 0 -> stop
    tight = jnp.stack([
        jnp.full((P,), 8.0),
        jnp.full((P,), 8.0 * mean),
        jnp.full((P,), 8.0 * mean * mean + 1e-9),
    ])
    assert n_converged(tight) == P
    # same tightness but only 2 chunks: no t-CI, stays unconverged
    two = jnp.stack([
        jnp.full((P,), 2.0),
        jnp.full((P,), 2.0 * mean),
        jnp.full((P,), 2.0 * mean * mean + 1e-9),
    ])
    assert n_converged(two) == 0


def test_adaptive_sharded_spp_axis_strips(key):
    # an spp shard stopping a pixel early would desync the disjoint
    # sample ranges, so spp-sharded renders strip the tolerance
    from raytracer_tpu.parallel.sharding import (
        make_mesh,
        render_image_sharded_pallas,
    )

    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    a = render_image_sharded_pallas(
        scene, cam, W, H, 4, key, make_mesh((2, 2)),
        TraceOptions(max_depth=3, adaptive_tolerance=0.05),
    )
    b = render_image_sharded_pallas(
        scene, cam, W, H, 4, key, make_mesh((2, 2)),
        TraceOptions(max_depth=3),
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adaptive_sharded_rows_matches_single_chip(forced_chunks, key):
    # rows-only meshes run the adaptive drivers shard-locally; with the
    # same (forced) chunk schedule, per-pixel stop decisions and
    # accumulation order match the single-chip adaptive render exactly
    from raytracer_tpu.parallel.sharding import (
        make_mesh,
        render_image_sharded_pallas,
    )

    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    img_s, stats_s = render_image_sharded_pallas(
        scene, cam, W, H, 27, key, make_mesh((2,), ("rows",)), opts,
        return_stats=True,
    )
    img_1, stats_1 = _render(opts, spp=27, key=key)
    assert float(stats_s["mean_spp"]) < 27.0  # early stopping engaged
    assert float(stats_s["mean_spp"]) == pytest.approx(
        float(stats_1["mean_spp"]), abs=1e-3
    )
    assert float(stats_s["segments"]) == float(stats_1["segments"])
    np.testing.assert_array_equal(np.asarray(img_s), np.asarray(img_1))


def test_adaptive_sharded_single_chunk_strips(key):
    # single-chunk budgets can't gate later chunks: the rows-mesh render
    # must fall back to fixed-spp exactly (same gate as single-device)
    from raytracer_tpu.parallel.sharding import (
        make_mesh,
        render_image_sharded_pallas,
    )

    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    mesh = make_mesh((2,), ("rows",))
    a = render_image_sharded_pallas(
        scene, cam, W, H, 2, key, mesh,
        TraceOptions(max_depth=3, adaptive_tolerance=0.05),
    )
    b = render_image_sharded_pallas(
        scene, cam, W, H, 2, key, mesh, TraceOptions(max_depth=3),
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adaptive_sharded_rows_deterministic(forced_chunks, key):
    from raytracer_tpu.parallel.sharding import (
        make_mesh,
        render_image_sharded_pallas,
    )

    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    mesh = make_mesh((4,), ("rows",))
    a = render_image_sharded_pallas(scene, cam, W, H, 27, key, mesh, opts)
    b = render_image_sharded_pallas(scene, cam, W, H, 27, key, mesh, opts)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adaptive_spp_map(forced_chunks):
    # the sample-density heatmap: per-pixel effective sample counts,
    # consistent with the scalar mean and actually non-uniform once
    # early termination engages
    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    img, stats = _render(opts)
    m = np.asarray(stats["spp_map"])
    assert m.shape == (H, W)
    np.testing.assert_array_equal(m, np.round(m))  # whole sample counts
    assert m.min() >= 1.0 and m.max() <= 27.0
    assert float(stats["mean_spp"]) == pytest.approx(m.mean(), rel=1e-6)
    assert m.min() < m.max()  # some pixels stopped before others


def test_adaptive_sharded_spp_map_matches_single_chip(forced_chunks, key):
    # the heatmap rides the rows mesh exactly like the image: per-band
    # maps concatenate to the single-chip map bitwise
    from raytracer_tpu.parallel.sharding import (
        make_mesh,
        render_image_sharded_pallas,
    )

    opts = TraceOptions(max_depth=4, adaptive_tolerance=0.05)
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    _, stats_s = render_image_sharded_pallas(
        scene, cam, W, H, 27, key, make_mesh((2,), ("rows",)), opts,
        return_stats=True,
    )
    _, stats_1 = _render(opts, spp=27, key=key)
    np.testing.assert_array_equal(
        np.asarray(stats_s["spp_map"]), np.asarray(stats_1["spp_map"])
    )


def test_adaptive_chunk_override(forced_chunks):
    # adaptive_chunk_spp overrides the auto chunk size; a chunk so large
    # that fewer than two fit runs the fixed-spp render instead
    img, stats = _render(
        TraceOptions(max_depth=4, adaptive_tolerance=0.05,
                     adaptive_chunk_spp=2)
    )
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert 2.0 <= float(stats["mean_spp"]) < 27.0
    img2, stats2 = _render(
        TraceOptions(max_depth=4, adaptive_tolerance=0.05,
                     adaptive_chunk_spp=999)
    )
    assert "mean_spp" not in stats2
    img_f, _ = _render(TraceOptions(max_depth=4))
    np.testing.assert_array_equal(np.asarray(img2), np.asarray(img_f))


@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_adaptive_budget_plane_unsorted(sampler):
    """The per-pixel budget plane stays in image order (no re-packing):
    each pixel takes exactly its own budget, budget-0 pixels stay black
    and add no luminance, and a pixel with the full budget equals the
    fixed-spp launch bitwise."""
    import jax.numpy as jnp

    scene, cam, *_ = presets.get_config("two_sphere", 64, 16)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=4, sampler=sampler)
    scene, uuid, g_full = pk._apply_split(scene, None)
    p = 64 * 16
    budget = (np.arange(p) % 3) * 2  # 0, 2, 4, 0, 2, 4, ...
    seed = pk._seed_from_key(jax.random.PRNGKey(6))
    band = dict(width=64, height=16, band_h=16, spp=4, opts=opts,
                g_full=g_full)
    sums, stats, _ = pk.trace_band(scene, uuid, dcam, None, seed, 0, 0,
                                   budget=jnp.asarray(budget), **band)
    fixed, _, _ = pk.trace_band(scene, uuid, dcam, None, seed, 0, 0, **band)
    sums, stats, fixed = (np.asarray(a) for a in (sums, stats, fixed))
    np.testing.assert_array_equal(sums[3], budget)
    assert np.all(sums[:3, budget == 0] == 0.0)
    assert np.all(stats[:, budget == 0] == 0.0)
    full = budget == 4
    np.testing.assert_array_equal(sums[:, full], fixed[:, full])
