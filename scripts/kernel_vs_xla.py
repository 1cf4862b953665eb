"""Time the Pallas kernel against what XLA makes of the plain jnp tracer,
on one GPU, at the same settings for both:

- the cover at 1200x800, depth 50, Russian roulette from bounce 5, at
  ``--spp`` samples (default 16, so the jnp side finishes quickly);
- the progressive demo at 1280x720, 1 spp/frame, depth 8 (steady-state
  step time, one sync per batch of frames);
- with ``--blocks``, the kernel's cover time per BLOCK / num_warps.

    python scripts/kernel_vs_xla.py [--spp 16] [--blocks]

Prints one line per measurement, each with the card's name and power
limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _best(fn, n):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--blocks", action="store_true")
    args = ap.parse_args()
    import jax

    from raytracer_tpu.camera.camera import derive_camera
    from raytracer_tpu.progressive.state import init_render_state
    from raytracer_tpu.progressive.step import make_step_fn
    from raytracer_tpu.render import pallas_kernel as pk
    from raytracer_tpu.render.api import render_image
    from raytracer_tpu.render.options import DebugParams, TraceOptions
    from raytracer_tpu.scene import presets
    from raytracer_tpu.utils.jaxcache import enable_persistent_cache

    if jax.devices()[0].platform != "gpu":
        print("no GPU", file=sys.stderr)
        return 2
    enable_persistent_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    key = jax.random.PRNGKey(0)

    scene, cam, w, h, _, depth = presets.get_config("cover")
    for backend in ("pallas", "jnp"):
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5,
                            backend=backend)
        wall, (_, st) = _best(lambda: render_image(
            scene, cam, w, h, args.spp, key, opts, return_stats=True),
            3 if backend == "pallas" else 1)
        segs = float(st["segments"])
        print(f"cover {w}x{h} spp={args.spp} d{depth} rr5 backend={backend}"
              f" wall_s={wall:.4f} segments={segs:.0f} "
              f"mrays_per_s={segs / wall / 1e6:.1f} card={card!r}",
              flush=True)

    scene_d, cam_d, wd, hd, _, depth_d = presets.get_config("demo")
    debug = DebugParams.none()
    for backend in ("pallas", "jnp"):
        step = make_step_fn(wd, hd, spp=1, opts=TraceOptions(
            max_depth=depth_d, backend=backend))
        state = init_render_state(wd, hd, key)
        for _ in range(4):
            state, aux = step(state, scene_d, cam_d, debug)
        float(aux["segments"])
        frames = 64
        t0 = time.perf_counter()
        for _ in range(frames):
            state, aux = step(state, scene_d, cam_d, debug)
        float(aux["segments"])
        dt = (time.perf_counter() - t0) / frames
        print(f"progressive demo {wd}x{hd} 1spp d{depth_d} backend={backend}"
              f" ms_per_frame={dt * 1e3:.3f} fps={1 / dt:.1f} card={card!r}",
              flush=True)

    if args.blocks:
        opts = TraceOptions(max_depth=depth, russian_roulette_depth=5)
        dcam = derive_camera(cam)
        sc, uuid, g_full = pk._apply_split(
            scene, pk._containable_split(scene, dcam, opts))
        for block, warps in ((32, 1), (64, 2), (64, 1), (128, 4), (256, 8)):
            f = jax.jit(lambda: pk.trace_band(
                sc, uuid, dcam, None, pk._seed_from_key(key), 0, 0,
                width=w, height=h, band_h=h, spp=args.spp, opts=opts,
                g_full=g_full, block=block, num_warps=warps))
            wall, out = _best(f, 3)
            segs = float(pk._seg_value(pk._seg_pair(out[2])))
            print(f"block={block} num_warps={warps} cover spp={args.spp} "
                  f"wall_s={wall:.4f} mrays_per_s={segs / wall / 1e6:.1f} "
                  f"card={card!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
