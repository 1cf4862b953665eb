"""End-to-end check of the renderer on one GPU, through its entry points.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded path only

Phases (each prints one line; any failure raises and exits non-zero):

1. device  — platform, device kind and count, the card's name and power
   limit; fails unless the platform is 'gpu'.
2. cover   — the headline render: ``render_image`` (backend 'auto') on the
   cover at 1200x800, 500 spp, depth 50, Russian roulette from bounce 5;
   wall, exact segments, Mrays/s, and mean|Δ| against the committed
   plain-reference ground truth (tests/goldens/).
3. progressive — the demo scene at 1280x720, 1 spp/frame, depth 8, through
   ``make_step_fn`` with donation, synced once per batch: fps, and the
   accumulated linear image against a jnp render of the same spp.
4. kernel vs jnp — the Pallas kernel against ``render_image_jnp`` on
   two_sphere, three_sphere, dof and demo at their preset sizes, and the
   same key rendered twice must be bitwise equal.
5. compiled — the lowered render holds the Triton custom call and no
   interpreter loop.

``--multi`` runs only the sharded path and what it is compared with: the
demo and cover on a rows mesh (4,) bitwise against one card, the same on a
(2, 2) rows x spp mesh within f32 summation tolerance, and one sharded
progressive step bitwise against the one-card step.

The last line of stdout is the JSON result; everything else comes before.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: cover vs the jnp rr0 ground truth at 500 spp: two independent
#: Monte-Carlo estimates (different RNGs) plus the extra variance Russian
#: roulette adds on deep paths — a per-pixel noise floor of a few 1e-3
#: in mean|Δ|; a physics error (a wrong material, a missed sphere) moves
#: it by 1e-2 or more
GOLDEN_MAD_BOUND = 0.01
#: kernel vs jnp at KERNEL_VS_JNP_SPP spp: two independent estimates of
#: the same image, each with per-pixel noise ~sigma/sqrt(spp)
KERNEL_VS_JNP_SPP = 64
KERNEL_VS_JNP_BOUND = 0.02
#: progressive (128 linear 1-spp frames, the reference's blend weights)
#: vs a 128-spp jnp render: independent estimates of the same mean
PROGRESSIVE_FRAMES = 128
PROGRESSIVE_BOUND = 0.02
#: a (2, 2) rows x spp mesh adds the two spp halves' linear sums with one
#: psum instead of accumulating 500 samples in one order: f32 rounding of
#: a 500-term sum, ~500 * 2^-24 relative, far below this max |Δ|
MULTI_SPP_ATOL = 1e-4
#: the Triton custom call in the lowered render
TRITON_CALL = "__gpu$xla.gpu.triton"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the sharded path on four cards")
    return p.parse_args(argv)


def result_line(devices) -> str:
    """The final stdout line: ok plus the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _say(phase: str, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {parts}", flush=True)


def _check(ok: bool, what) -> None:
    """Fail the phase (an explicit raise, kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _mad(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    _say("device", platform=d.platform, kind=repr(d.device_kind),
         count=len(devs))
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {d.platform}")
    if len(devs) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, found {len(devs)}")
    return devs


def phase_cover():
    import jax
    import numpy as np

    from raytracer_tpu.render.api import render_image
    from raytracer_tpu.render.options import TraceOptions
    from raytracer_tpu.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config("cover")
    opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    img, _ = render_image(scene, cam, w, h, spp, key, opts,
                          return_stats=True)
    first = time.perf_counter() - t0
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        img, stats = render_image(scene, cam, w, h, spp, key, opts,
                                  return_stats=True)
        img = np.asarray(img)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    segs = float(stats["segments"])
    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(
        here, "tests", "goldens", "cover_jnp_rr0_500spp_f16.npz"
    ))["image"]
    mad = _mad(img, golden)
    _say("cover", size=f"{w}x{h}", spp=spp, depth=depth, rr=5,
         first_call_s=f"{first:.3f}", wall_s=f"{wall:.4f}",
         segments=f"{segs:.0f}", mrays_per_s=f"{segs / wall / 1e6:.1f}",
         golden_mad=f"{mad:.5f}", bound=GOLDEN_MAD_BOUND,
         finite=bool(np.isfinite(img).all()))
    _check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()),
           "cover image shape / finite")
    _check(mad < GOLDEN_MAD_BOUND, f"cover golden mean|Δ| {mad}")


def phase_progressive():
    import jax
    import numpy as np

    from raytracer_tpu.camera.camera import derive_camera
    from raytracer_tpu.progressive.state import init_render_state
    from raytracer_tpu.progressive.step import make_step_fn
    from raytracer_tpu.render.options import DebugParams, TraceOptions
    from raytracer_tpu.render.tracer import render_image_jnp
    from raytracer_tpu.scene import presets

    scene, cam, w, h, _, depth = presets.get_config("demo", 1280, 720)
    debug = DebugParams.none()
    key = jax.random.PRNGKey(3)

    def session(opts, batch=32):
        """PROGRESSIVE_FRAMES warm frames; returns (state, s/frame)."""
        step = make_step_fn(w, h, spp=1, opts=opts)
        state = init_render_state(w, h, key)
        for _ in range(4):  # compile + warm
            state, aux = step(state, scene, cam, debug)
        float(aux["segments"])
        state = init_render_state(w, h, key)
        t0 = time.perf_counter()
        for _ in range(PROGRESSIVE_FRAMES // batch):
            for _ in range(batch):
                state, aux = step(state, scene, cam, debug)
            float(aux["segments"])  # one sync per batch
        return state, (time.perf_counter() - t0) / PROGRESSIVE_FRAMES

    state, dt = session(TraceOptions(max_depth=depth))
    # correctness on linear frames: the accumulated mean of 1-spp frames
    # vs a jnp render at the same total spp
    opts_lin = TraceOptions(max_depth=depth, gamma=False)
    lin, _ = session(opts_lin)
    ref = jax.jit(lambda s, d, k: render_image_jnp(
        s, d, w, h, PROGRESSIVE_FRAMES, k, opts_lin
    ))(scene, derive_camera(cam), jax.random.PRNGKey(11))
    acc = np.asarray(lin.accum)
    mad = _mad(acc, ref)
    _say("progressive", scene="demo", size=f"{w}x{h}", spp_per_frame=1,
         depth=depth, frames=PROGRESSIVE_FRAMES,
         ms_per_frame=f"{dt * 1e3:.3f}", fps=f"{1.0 / dt:.1f}",
         linear_mad_vs_jnp=f"{mad:.5f}", bound=PROGRESSIVE_BOUND)
    _check(bool(np.isfinite(np.asarray(state.accum)).all()),
           "progressive accum finite")
    _check(mad < PROGRESSIVE_BOUND, f"progressive mean|Δ| {mad}")


def check_kernel_vs_jnp(config: str, width=None, height=None,
                        spp: int = KERNEL_VS_JNP_SPP):
    """(mean|Δ| kernel vs jnp, bitwise rerun, first-call s) at one size.

    Lowbias32 counters vs threefry keys: independent estimates, so the
    comparison is statistical. No matrix products remain on the path, so
    TF32 does not enter either side."""
    import jax
    import numpy as np

    from raytracer_tpu.render.api import render_image
    from raytracer_tpu.render.options import TraceOptions
    from raytracer_tpu.scene import presets

    scene, cam, w, h, _, depth = presets.get_config(config, width, height)
    key = jax.random.PRNGKey(1)
    opts = TraceOptions(max_depth=depth, backend="pallas")
    t0 = time.perf_counter()
    a = np.asarray(render_image(scene, cam, w, h, spp, key, opts))
    first = time.perf_counter() - t0
    b = np.asarray(render_image(scene, cam, w, h, spp, key, opts))
    ref = render_image(scene, cam, w, h, spp, key,
                       TraceOptions(max_depth=depth, backend="jnp"))
    return _mad(a, ref), bool(np.array_equal(a, b)), first, (w, h, depth)


def phase_kernel_vs_jnp():
    for config in ("two_sphere", "three_sphere", "dof", "demo"):
        mad, same, first, (w, h, depth) = check_kernel_vs_jnp(config)
        _say("kernel_vs_jnp", config=config, size=f"{w}x{h}",
             spp=KERNEL_VS_JNP_SPP, depth=depth, mad=f"{mad:.5f}",
             bound=KERNEL_VS_JNP_BOUND, bitwise_rerun=same,
             first_call_s=f"{first:.2f}")
        _check(same, f"{config}: two renders of one key differ")
        _check(mad < KERNEL_VS_JNP_BOUND, f"{config} mean|Δ| {mad}")


def lowered_render_text(width: int = 64, height: int = 32) -> str:
    """StableHLO of the jitted fixed-spp kernel render (cover scene)."""
    import jax

    from raytracer_tpu.camera.camera import derive_camera
    from raytracer_tpu.render import pallas_kernel as pk
    from raytracer_tpu.render.options import TraceOptions
    from raytracer_tpu.scene import presets

    scene, cam, *_ = presets.get_config("cover", width, height)
    scene, uuid, g_full = pk._apply_split(scene, None)
    return pk._render_fixed.lower(
        scene, uuid, derive_camera(cam), None, jax.random.PRNGKey(0), 0,
        width=width, height=height, spp=1,
        opts=TraceOptions(max_depth=4, russian_roulette_depth=2),
        g_full=g_full, block=pk.DEFAULT_BLOCK,
    ).as_text()


def phase_compiled():
    txt = lowered_render_text()
    has_call = TRITON_CALL in txt
    interp = "stablehlo.while" in txt
    _say("compiled", triton_custom_call=has_call, interpreter_loop=interp)
    _check(has_call and not interp, "compiled Triton kernel")


#: (config, width, height, spp) of the --multi renders; None = preset size
MULTI_RENDERS = (("demo", None, None, 64), ("cover", None, None, 500))


def phase_multi(renders=MULTI_RENDERS, step_size=(None, None)):
    import jax
    import numpy as np

    from raytracer_tpu.camera.camera import derive_camera
    from raytracer_tpu.parallel.sharding import (
        make_mesh,
        make_sharded_step_fn,
        render_image_sharded_pallas,
        shard_render_state,
    )
    from raytracer_tpu.progressive.state import init_render_state
    from raytracer_tpu.progressive.step import make_step_fn
    from raytracer_tpu.render import pallas_kernel as pk
    from raytracer_tpu.render.options import DebugParams, TraceOptions
    from raytracer_tpu.scene import presets

    key = jax.random.PRNGKey(0)
    for config, width, height, spp in renders:
        scene, cam, w, h, _, depth = presets.get_config(config, width,
                                                        height)
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
        one, st1 = pk.render_image_pallas(scene, derive_camera(cam), w, h,
                                          spp, key, opts, return_stats=True)
        one = np.asarray(one)
        for shape, names in (((4,), ("rows",)), ((2, 2), ("rows", "spp"))):
            mesh = make_mesh(shape, names)
            render = lambda: render_image_sharded_pallas(  # noqa: E731
                scene, cam, w, h, spp, key, mesh, opts, return_stats=True)
            render()  # compile
            t0 = time.perf_counter()
            img, st = render()
            img = np.asarray(img)
            wall = time.perf_counter() - t0
            diff = float(np.abs(img - one).max())
            _say("multi", config=config, size=f"{w}x{h}", spp=spp,
                 mesh=dict(mesh.shape), wall_s=f"{wall:.4f}",
                 max_abs_diff=diff, bitwise=bool(np.array_equal(img, one)),
                 segments_equal=float(st["segments"]) == float(
                     st1["segments"]))
            _check(float(st["segments"]) == float(st1["segments"]),
                   f"{config} {shape} segments")
            if shape == (4,):
                _check(np.array_equal(img, one), f"{config} rows bitwise")
            else:
                _check(diff <= MULTI_SPP_ATOL, f"{config} {shape} {diff}")

    scene, cam, w, h, _, depth = presets.get_config("demo", *step_size)
    opts = TraceOptions(max_depth=depth, backend="pallas")
    mesh = make_mesh((4,), ("rows",))
    step_m = make_sharded_step_fn(w, h, mesh, spp=1, opts=opts)
    s_m, aux_m = step_m(shard_render_state(init_render_state(w, h, key),
                                           mesh),
                        scene, cam, DebugParams.none())
    s_1, aux_1 = make_step_fn(w, h, spp=1, opts=opts)(
        init_render_state(w, h, key), scene, cam, DebugParams.none())
    same = bool(np.array_equal(np.asarray(s_m.accum), np.asarray(s_1.accum)))
    _say("multi_progressive", size=f"{w}x{h}", mesh=dict(mesh.shape),
         bitwise=same,
         segments_equal=float(aux_m["segments"]) == float(
             aux_1["segments"]))
    _check(same and float(aux_m["segments"]) == float(aux_1["segments"]),
           "sharded progressive step")


def main(argv=None) -> int:
    args = parse_args(argv)
    n_cards = 4 if args.multi else 1
    import jax  # noqa: F401 — fail here, before any phase, without JAX

    from raytracer_tpu.utils.jaxcache import enable_persistent_cache

    devs = phase_device(n_cards)
    enable_persistent_cache()
    card = card_line()
    _say("card", name_power_limit=repr(card))
    if args.multi:
        phase_multi()
    else:
        phase_cover()
        phase_progressive()
        phase_kernel_vs_jnp()
        phase_compiled()
    print(card, flush=True)
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
