"""Pallas kernel tests (interpret mode on CPU): agreement with the jnp
reference tracer, determinism, launch/block invariance, padding, the
in-kernel RNG, option plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera.camera import derive_camera
from raytracer_tpu.render import pallas_kernel as pk
from raytracer_tpu.render.options import TraceOptions
from raytracer_tpu.render.tracer import render_image_jnp
from raytracer_tpu.scene import presets

W, H = 128, 64


def render_both(config, spp=8, depth=6, w=W, h=H):
    scene, cam, *_ = presets.get_config(config, w, h)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(0)
    opts = TraceOptions(max_depth=depth)
    img_p, stats = pk.render_image_pallas(
        scene, dcam, w, h, spp, key, opts, return_stats=True
    )
    img_j = render_image_jnp(scene, dcam, w, h, spp, key, opts)
    return np.asarray(img_p), np.asarray(img_j), stats


@pytest.mark.parametrize("config", ["two_sphere", "three_sphere", "demo"])
def test_matches_jnp_tracer(config):
    """Same scene, independent RNG streams: images agree to noise level."""
    img_p, img_j, _ = render_both(config)
    diff = np.abs(img_p - img_j).mean()
    assert diff < 0.03, (config, diff)


def test_dof_lens_blur():
    """Defocus blur renders and matches the jnp tracer statistically."""
    scene, cam, *_ = presets.get_config("dof", W, H)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=6)
    img_p = np.asarray(
        pk.render_image_pallas(scene, dcam, W, H, 8, jax.random.PRNGKey(0), opts)
    )
    img_j = np.asarray(
        render_image_jnp(scene, dcam, W, H, 8, jax.random.PRNGKey(0), opts)
    )
    assert np.abs(img_p - img_j).mean() < 0.04


def test_deterministic():
    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=4)
    a = pk.render_image_pallas(scene, dcam, W, H, 4, jax.random.PRNGKey(5), opts)
    b = pk.render_image_pallas(scene, dcam, W, H, 4, jax.random.PRNGKey(5), opts)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c = pk.render_image_pallas(scene, dcam, W, H, 4, jax.random.PRNGKey(6), opts)
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def _linear_launch(scene, dcam, w, h, spp, key, opts, sample_offset=0,
                   block=pk.DEFAULT_BLOCK):
    """Linear per-pixel sums of one kernel launch, (H, W, 3), plus the
    exact segment pair."""
    scene, uuid, g_full = pk._apply_split(
        scene, pk._containable_split(scene, dcam, opts)
    )
    sums, _, segs = pk.trace_band(
        scene, uuid, dcam, None, pk._seed_from_key(key), sample_offset, 0,
        width=w, height=h, band_h=h, spp=spp, opts=opts, g_full=g_full,
        block=block,
    )
    return np.asarray(pk._band_image(sums[:3], w, h)), pk._seg_pair(segs)


def _seg_int(pair):
    hi, lo = (int(v) for v in np.asarray(pair))
    return hi * 4096 + lo


def test_chunking_invariance():
    """Splitting spp across launches (absolute sample offsets) must not
    change the per-pixel sample decomposition: 3+3+2 launches sum to the
    one-launch linear image up to f32 summation order, with exactly the
    same segments."""
    scene, cam, *_ = presets.get_config("two_sphere", 64, 32)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=4, gamma=False)
    key = jax.random.PRNGKey(0)
    whole, seg_w = _linear_launch(scene, dcam, 64, 32, 8, key, opts)
    parts = [_linear_launch(scene, dcam, 64, 32, n, key, opts, off)
             for off, n in ((0, 3), (3, 3), (6, 2))]
    split = sum(p[0] for p in parts)
    np.testing.assert_allclose(whole, split, rtol=1e-5, atol=1e-6)
    assert _seg_int(seg_w) == sum(_seg_int(p[1]) for p in parts)


def test_nonaligned_resolution():
    """Width*height not a multiple of the tile size: padding lanes crop."""
    scene, cam, *_ = presets.get_config("two_sphere", 100, 53)
    dcam = derive_camera(cam)
    img = pk.render_image_pallas(
        scene, dcam, 100, 53, 2, jax.random.PRNGKey(0),
        TraceOptions(max_depth=4),
    )
    a = np.asarray(img)
    assert a.shape == (53, 100, 3)
    assert np.isfinite(a).all()


def test_exhaust_black_option():
    scene, cam, *_ = presets.get_config("two_sphere", 64, 32)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(0)
    ref = pk.render_image_pallas(
        scene, dcam, 64, 32, 2, key, TraceOptions(max_depth=1)
    )
    blk = pk.render_image_pallas(
        scene, dcam, 64, 32, 2, key, TraceOptions(max_depth=1, exhaust_black=True)
    )
    # bottom half hits the spheres and exhausts at depth 1: black vs throughput
    assert np.asarray(blk).mean() < np.asarray(ref).mean()


def test_gamma_off():
    scene, cam, *_ = presets.get_config("two_sphere", 64, 32)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(0)
    g = np.asarray(
        pk.render_image_pallas(scene, dcam, 64, 32, 4, key, TraceOptions(max_depth=4))
    )
    lin = np.asarray(
        pk.render_image_pallas(
            scene, dcam, 64, 32, 4, key, TraceOptions(max_depth=4, gamma=False)
        )
    )
    np.testing.assert_allclose(g, np.sqrt(np.maximum(lin, 0)), rtol=1e-4, atol=1e-5)


def test_debug_render_smoke():
    from raytracer_tpu.render.options import DebugParams

    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=2, enable_debug=True)
    img = pk.render_image_pallas(
        scene, dcam, 32, 16, 1, jax.random.PRNGKey(0), opts,
        debug=DebugParams.none(),
    )
    assert np.asarray(img).shape == (16, 32, 3)


def test_segments_accounting():
    """Segment counts equal live-lane sums: sky-only rays trace exactly one
    segment each."""
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    scene = make_scene([((0, -1000, 0), 900.0, Material.diffuse((1, 1, 1)))])
    cam, *_ = (presets.simple_camera(64, 32),)
    # camera looks at -z horizon; sphere far below: most rays go straight to sky
    dcam = derive_camera(cam.replace(pitch=jnp.asarray(45.0, jnp.float32)))
    _, stats = pk.render_image_pallas(
        scene, dcam, 64, 32, 1, jax.random.PRNGKey(0),
        TraceOptions(max_depth=8), return_stats=True,
    )
    assert float(stats["segments"]) == 64 * 32  # one segment per ray


def test_containable_split_analysis():
    """Static far-root analysis: glass, camera-inside, and overlap all
    mark spheres containable; isolated diffuse spheres are near-only."""
    import numpy as np

    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    # enough isolated (near-only) spheres that the split is non-trivial:
    # count 11 → s_pad 16, containables fit the 8-slot full-logic prefix
    scene = make_scene([
        ((0, -1000, 0), 1000.0, Material.diffuse((0.5, 0.5, 0.5))),  # ground
        ((0, 1, 0), 1.0, Material.glass(1.5)),                # glass
        ((0, 1, 0), -0.45, Material.glass(1.5)),              # hollow inner
        ((4, 3, 0), 1.0, Material.metal((0.7, 0.6, 0.5), 0.0)),  # isolated
        ((8, 5, 0), 1.0, Material.diffuse((0.4, 0.2, 0.1))),     # isolated
        ((8, 5.5, 0), 1.0, Material.diffuse((0.4, 0.2, 0.1))),   # overlaps ^
        ((-8, 5, 0), 1.0, Material.metal((0.7, 0.7, 0.7), 0.1)),
        ((-8, 9, 0), 1.0, Material.diffuse((0.1, 0.4, 0.2))),
        ((12, 9, 4), 1.0, Material.diffuse((0.2, 0.1, 0.4))),
        ((12, 9, -4), 1.0, Material.metal((0.5, 0.5, 0.6), 0.0)),
        ((-12, 9, 4), 1.0, Material.diffuse((0.3, 0.3, 0.1))),
    ])
    cam, *_ = (presets.simple_camera(64, 32),)
    dcam = derive_camera(cam)
    flags = pk._containable_flags(scene, dcam, TraceOptions())
    assert flags[1] and flags[2]        # glass
    assert flags[4] and flags[5]        # overlapping pair
    assert not flags[3]                 # isolated metal: near-only
    assert not flags[6:].any()          # isolated extras: near-only
    perm, g_full = pk._containable_split(scene, dcam, TraceOptions())
    assert g_full == int(flags.sum()) and g_full < scene.count
    # all containable spheres land in the full-logic prefix (perm None =
    # scene already laid out containable-first)
    if perm is None:
        perm = np.arange(scene.count)
    prefix = set(np.asarray(perm)[:g_full].tolist())
    assert {i for i in range(scene.count) if flags[i]} <= prefix
    # analysis is disabled by the option
    assert pk._containable_split(
        scene, dcam, TraceOptions(split_scan=False)
    ) is None


def test_split_scan_bitwise_equals_full():
    """The near-only scan suffix must not change the image on scenes whose
    far roots are provably irrelevant (per-sphere arithmetic is slot-
    independent, so even the containable permutation is value-neutral)."""
    import dataclasses

    for config in ("demo", "cover"):
        scene, cam, *_ = presets.get_config(config, 128, 32)
        dcam = derive_camera(cam)
        opts = TraceOptions(max_depth=6)
        key = jax.random.PRNGKey(3)
        a = np.asarray(pk.render_image_pallas(
            scene, dcam, 128, 32, 4, key, opts))
        b = np.asarray(pk.render_image_pallas(
            scene, dcam, 128, 32, 4, key,
            dataclasses.replace(opts, split_scan=False)))
        assert np.array_equal(a, b), (config, np.abs(a - b).max())


def test_split_scan_camera_inside_sphere():
    """A camera inside a big non-glass shell sees its far root (backface)
    — the camera-inside rule must keep that sphere on full logic."""
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    # camera at origin INSIDE a diffuse shell: every ray must hit it
    scene = make_scene([((0, 0, 0), 50.0, Material.diffuse((0.8, 0.1, 0.1)))])
    cam, *_ = (presets.simple_camera(64, 32),)
    dcam = derive_camera(cam)
    flags = pk._containable_flags(scene, dcam, TraceOptions())
    assert flags[0]  # the shell is containable
    # every slot needs full logic ⇒ the split is a no-op and says so
    assert pk._containable_split(scene, dcam, TraceOptions()) is None
    img, stats = pk.render_image_pallas(
        scene, dcam, 64, 32, 2, jax.random.PRNGKey(0),
        TraceOptions(max_depth=3), return_stats=True,
    )
    a = np.asarray(img)
    # everything hits the red-tinted shell interior: no sky blue anywhere
    assert float(stats["segments"]) > 64 * 32 * 2  # at least one bounce each
    assert a[..., 0].mean() > a[..., 2].mean() * 0.9


def test_chunk_schedule_invariants():
    """The adaptive launch schedule: sizes sum to spp, the first chunk is
    in [chunk, 2·chunk), the rest are equal (one lax.scan); fewer than two
    chunks means no schedule (the render runs fixed-spp)."""
    for spp, chunk in [(500, 16), (27, 3), (100, 7), (10, 3), (32, 16),
                       (33, 16), (10000, 16)]:
        sizes = pk.adaptive_schedule(spp, chunk)
        assert sum(sizes) == spp, (spp, chunk, sizes)
        assert chunk <= sizes[0] < 2 * chunk
        assert set(sizes[1:]) == {chunk}
    for spp, chunk in [(1, 16), (15, 16), (31, 16), (5, 3)]:
        assert pk.adaptive_schedule(spp, chunk) is None


def test_containable_camera_margin_scales_with_distance():
    """Lens-ray origins carry f32 roundoff ~eps*|origin|: a sphere the
    camera sits just outside must be containable when the gap is below
    that scale-relative bound (edge case: far-from-origin
    cameras with aperture)."""
    import dataclasses

    from raytracer_tpu.camera.camera import CameraConfig
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    # camera at |origin| ~ 2000 sitting 3e-3 outside a diffuse sphere:
    # within eps32-scale roundoff of lens-sample origins, far above the
    # old fixed 1e-4 margin. Needs >8 spheres so the analysis runs.
    cam_pos = jnp.asarray((2000.0, 0.0, 0.0), jnp.float32)
    spheres = [((2001.0, 0.0, 0.0), 0.997, Material.diffuse((0.5, 0.5, 0.5)))]
    for i in range(9):
        spheres.append(
            ((i * 50.0, 500.0, 500.0), 1.0, Material.diffuse((0.3, 0.3, 0.3)))
        )
    scene = make_scene(spheres)
    cam, *_ = (presets.simple_camera(64, 32),)
    cam = dataclasses.replace(cam, origin=cam_pos, aperture=0.1)
    dcam = derive_camera(cam)
    flags = pk._containable_flags(scene, dcam, TraceOptions())
    assert flags[0]          # gap 3e-3 < 1e-5*(2000+1) + lens + 1e-4
    assert not flags[1:].any()


def test_zero_radius_sphere_does_not_poison_gather():
    """A degenerate zero-radius slot (e.g. an interactive radius edit
    passing through 0) must not corrupt the image: its table row keeps a
    finite 1/r, and a lane can never win it with a positive t."""
    from raytracer_tpu.scene.materials import Material
    from raytracer_tpu.scene.spheres import make_scene

    scene = make_scene([
        ((0, -1000, 0), 1000.0, Material.diffuse((0.5, 0.5, 0.5))),
        ((0, 1, 0), 1.0, Material.diffuse((0.7, 0.3, 0.3))),
        ((3, 1, 0), 0.0, Material.metal((0.9, 0.9, 0.9), 0.0)),  # degenerate
    ])
    cam, *_ = (presets.simple_camera(64, 32),)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=4)
    img = np.asarray(pk.render_image_pallas(
        scene, dcam, 64, 32, 4, jax.random.PRNGKey(0), opts))
    assert np.isfinite(img).all()
    # and it matches the jnp tracer (which simply never hits r=0)
    ref = np.asarray(render_image_jnp(
        scene, dcam, 64, 32, 4, jax.random.PRNGKey(0), opts))
    assert np.abs(img - ref).mean() < 0.05


def test_max_depth_zero_rejected():
    with pytest.raises(ValueError):
        TraceOptions(max_depth=0)


def test_debug_overlay_in_kernel():
    """enable_debug runs IN the kernel (no jnp fallback): the cursor
    marker paints solid blue, the selection outline solid red, and the
    overlay matches the jnp tracer's debug branch statistically
    (shader.frag:306-318)."""
    from raytracer_tpu.render.options import DebugParams

    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(3)
    opts = TraceOptions(max_depth=4, enable_debug=True)
    # cursor ON the small sphere's front surface (center (0,0,-1) r=0.5
    # -> nearest surface point (0,0,-0.5)); sphere 0 selected
    debug = DebugParams(
        cursor_point=jnp.asarray([0.0, 0.0, -0.5], jnp.float32),
        selected_object=jnp.asarray(0, jnp.int32),
    )
    img_p = np.asarray(pk.render_image_pallas(
        scene, dcam, W, H, 8, key, opts, debug
    ))
    img_j = np.asarray(render_image_jnp(
        scene, dcam, W, H, 8, key, opts, debug
    ))
    assert np.abs(img_p - img_j).mean() < 0.03
    # the marker region is solid blue in BOTH renders (RNG-independent
    # in the interior: every sample of those pixels hits near the cursor)
    blue = (img_p[..., 2] > 0.95) & (img_p[..., 0] < 0.05)
    blue_j = (img_j[..., 2] > 0.95) & (img_j[..., 0] < 0.05)
    assert blue.sum() > 0
    assert abs(int(blue.sum()) - int(blue_j.sum())) <= max(
        8, 0.2 * blue_j.sum()
    )
    # outline: selecting the ground sphere reddens its grazing band
    # (the silhouette is sub-pixel, so jittered samples mix red with
    # surface color — test red-DOMINANCE, not solid red, in both)
    debug_sel = DebugParams(
        cursor_point=jnp.asarray([100.0, 100.0, 100.0], jnp.float32),
        selected_object=jnp.asarray(1, jnp.int32),
    )
    img_s = np.asarray(pk.render_image_pallas(
        scene, dcam, W, H, 8, key, opts, debug_sel
    ))
    img_sj = np.asarray(render_image_jnp(
        scene, dcam, W, H, 8, key, opts, debug_sel
    ))
    red = img_s[..., 0] - np.maximum(img_s[..., 1], img_s[..., 2])
    red_j = img_sj[..., 0] - np.maximum(img_sj[..., 1], img_sj[..., 2])
    assert (red > 0.2).sum() > 0 and (red_j > 0.2).sum() > 0
    assert np.abs(img_s - img_sj).mean() < 0.03


def test_debug_none_matches_plain_render():
    """enable_debug with no cursor/selection must not perturb the image
    (same RNG counters, overlay masks all-false)."""
    from raytracer_tpu.render.options import DebugParams

    scene, cam, *_ = presets.get_config("two_sphere", W, H)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(0)
    plain = np.asarray(pk.render_image_pallas(
        scene, dcam, W, H, 4, key, TraceOptions(max_depth=4)
    ))
    dbg = np.asarray(pk.render_image_pallas(
        scene, dcam, W, H, 4, key,
        TraceOptions(max_depth=4, enable_debug=True), DebugParams.none(),
    ))
    np.testing.assert_array_equal(plain, dbg)


def test_high_spp_parity_tight():
    """Tightened physics-drift net: at 96 spp the
    independent tracers agree to ~3x the 8-spp noise bound. Measured
    0.0086 mean|Δ| on this config; 0.012 leaves noise headroom while
    still catching percent-level physics drift the loose 8-spp bound
    (0.03) would miss."""
    scene, cam, *_ = presets.get_config("three_sphere", 64, 32)
    dcam = derive_camera(cam)
    opts = TraceOptions(max_depth=8)
    p = np.asarray(pk.render_image_pallas(
        scene, dcam, 64, 32, 96, jax.random.PRNGKey(0), opts
    ))
    j = np.asarray(render_image_jnp(
        scene, dcam, 64, 32, 96, jax.random.PRNGKey(0), opts
    ))
    assert np.abs(p - j).mean() < 0.012


def test_stratified_matches_jnp_and_chunk_invariant():
    """TraceOptions.sampler='stratified' on the Pallas kernel: statistical
    parity with the jnp tracer's stratified path (independent CP-rotation
    streams, so equality is to noise level), and bitwise-stable under spp
    chunking — the R2 index is the ABSOLUTE sample number and the rotation
    counters (-4..-1) are chunk-independent."""
    scene, cam, *_ = presets.get_config("demo", W, H)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(0)
    opts = TraceOptions(max_depth=6, sampler="stratified")
    img_p = np.asarray(pk.render_image_pallas(scene, dcam, W, H, 8, key, opts))
    img_j = np.asarray(render_image_jnp(scene, dcam, W, H, 8, key, opts))
    assert np.abs(img_p - img_j).mean() < 0.03

    o4 = TraceOptions(max_depth=4, sampler="stratified", gamma=False)
    whole, _ = _linear_launch(scene, dcam, 64, 32, 8, key, o4)
    split = sum(_linear_launch(scene, dcam, 64, 32, n, key, o4, off)[0]
                for off, n in ((0, 3), (3, 3), (6, 2)))
    np.testing.assert_allclose(whole, split, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sampler", ["random", "stratified"])
@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_block_bitwise_invariance(block, sampler):
    """One lane per pixel and RNG keyed on absolute pixel coordinates: the
    linear image and the exact segment count are bitwise independent of
    the block size, i.e. of how the grid is split. The reference is the
    whole 64x32 image in a single 2048-lane block."""
    scene, cam, *_ = presets.get_config("demo", 64, 32)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(4)
    opts = TraceOptions(max_depth=6, russian_roulette_depth=3,
                        sampler=sampler, gamma=False)
    ref, seg_ref = _linear_launch(scene, dcam, 64, 32, 3, key, opts,
                                  block=2048)
    img, seg = _linear_launch(scene, dcam, 64, 32, 3, key, opts, block=block)
    np.testing.assert_array_equal(img, ref)
    assert _seg_int(seg) == _seg_int(seg_ref)


@pytest.mark.parametrize("w,h", [(1, 1), (3, 5), (17, 9), (100, 53)])
def test_padding_non_power_of_two(w, h):
    """Pixel counts that no block divides: padding lanes are never alive,
    so they trace nothing and are cropped, and the pixels are the same at
    another block size."""
    scene, cam, *_ = presets.get_config("three_sphere", w, h)
    dcam = derive_camera(cam)
    key = jax.random.PRNGKey(1)
    opts = TraceOptions(max_depth=4)
    img, stats = pk.render_image_pallas(scene, dcam, w, h, 2, key, opts,
                                        return_stats=True, block=32)
    img = np.asarray(img)
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    # every sample traces its camera segment, at most max_depth of them
    assert w * h * 2 <= float(stats["segments"]) <= w * h * 2 * 4
    img64 = pk.render_image_pallas(scene, dcam, w, h, 2, key, opts, block=64)
    np.testing.assert_array_equal(img, np.asarray(img64))


def _np_lowbias32(x):
    x = np.asarray(x, np.uint64)
    m = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & m
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & m
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


@pytest.mark.parametrize("case", ["lowbias32", "hash32", "u01"])
def test_rng_matches_numpy_uint32_reference(case):
    """The in-kernel RNG is plain uint32 arithmetic (wrapping multiplies,
    logical shifts): it must match a numpy reference bit for bit."""
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x = x.astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    if case == "lowbias32":
        got, want = pk._lowbias32(jnp.asarray(x)), _np_lowbias32(x)
    elif case == "hash32":
        ctr = (np.arange(4096, dtype=np.uint64) * 7919).astype(np.uint32)
        got = pk._hash32(jnp.asarray(x), jnp.asarray(ctr), 5)
        c = ((ctr.astype(np.uint64) + 5) * 0x9E3779B9) & 0xFFFFFFFF
        want = _np_lowbias32(x ^ c.astype(np.uint32))
    else:
        got = pk._to_u01(jnp.asarray(x))
        want = (x >> 8).astype(np.float32) * np.float32(2.0**-24)
        assert float(got.max()) < 1.0 and float(got.min()) >= 0.0
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("counts", [
    [0, 1, 4095, 4096, 4097],
    [2**31 - 1] * 7,
    list(range(0, 10**7, 9973)),
])
def test_segment_pair_exact(counts):
    """Per-block int32 segment counts sum into an exact [hi, lo] pair —
    no f32 rounding until the one final conversion."""
    pair = np.asarray(pk._seg_pair(jnp.asarray(counts, jnp.int32)))
    assert int(pair[0]) * 4096 + int(pair[1]) == sum(counts)
    assert float(pk._seg_value(jnp.asarray(pair))) == pytest.approx(
        float(sum(counts)), rel=1e-7
    )

