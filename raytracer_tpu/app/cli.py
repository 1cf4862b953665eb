"""Offline CLI renderer: scene preset → PNG.

The batch-mode analog of the reference's interactive-only app (which could
only export via the browser's Save Image button, src/dom.rs:118-143). Usage:

    python -m raytracer_tpu.app.cli --config cover --spp 500 --out cover.png
    python -m raytracer_tpu.app.cli --config demo --width 640 --height 360 \
        --progressive-frames 64 --out demo.png
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import numpy as np

from raytracer_tpu.progressive.state import init_render_state
from raytracer_tpu.progressive.step import make_step_fn, run_frames
from raytracer_tpu.render.api import render_image
from raytracer_tpu.render.options import TraceOptions
from raytracer_tpu.scene import presets
from raytracer_tpu.utils.profiling import mrays_per_sec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu", description="RTiOW path tracer"
    )
    p.add_argument("--config", default="demo", choices=sorted(presets.BASELINE_CONFIGS))
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="render.png")
    p.add_argument(
        "--backend", default="auto", choices=["auto", "jnp", "pallas"]
    )
    p.add_argument(
        "--progressive-frames",
        type=int,
        default=0,
        help="accumulate N progressive frames (of --spp samples each) instead of one batch render",
    )
    p.add_argument(
        "--aov",
        default=None,
        choices=["normal", "depth", "uuid", "front"],
        help="render a debug AOV instead of the beauty pass",
    )
    p.add_argument(
        "--russian-roulette",
        type=int,
        default=0,
        metavar="DEPTH",
        help="unbiased Russian-roulette termination from this bounce on "
        "(0 = off; faster deep renders, slightly more variance)",
    )
    p.add_argument(
        "--adaptive",
        type=float,
        default=0.0,
        metavar="TOL",
        help="adaptive sampling: stop sampling a pixel once its 95%% CI "
        "on mean luminance is within TOL (relative); 0 = fixed spp",
    )
    p.add_argument(
        "--spp-map",
        default=None,
        metavar="PATH",
        help="with --adaptive: also save the per-pixel sample-density "
        "heatmap (effective spp, normalized to its max) as a grayscale "
        "PNG — shows where the adaptive sampler spent its budget",
    )
    p.add_argument(
        "--sampler",
        default="random",
        choices=("random", "stratified"),
        help="camera-sample sequencer: 'stratified' uses per-pixel "
        "low-discrepancy jitter/lens points (same distributions, lower "
        "variance; progressive sessions walk each pixel's sequence "
        "across frames). --adaptive is offline-only: progressive mode "
        "strips the tolerance for EITHER sampler and renders fixed spp",
    )
    p.add_argument(
        "--book-physics",
        action="store_true",
        help="canonical RTiOW physics (black on depth exhaustion + near-zero "
        "guard) instead of reference quirks",
    )
    return p


def main(argv=None) -> int:
    from raytracer_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    scene, cam, w, h, spp, depth = presets.get_config(
        args.config, args.width, args.height
    )
    # 'is not None': an explicit --spp 0 should error (render_image /
    # make_step_fn raise ValueError), not silently fall back to the preset
    spp = args.spp if args.spp is not None else spp
    depth = args.max_depth if args.max_depth is not None else depth
    opts = TraceOptions(
        max_depth=depth,
        backend=args.backend,
        exhaust_black=args.book_physics,
        near_zero_guard=args.book_physics,
        russian_roulette_depth=args.russian_roulette,
        adaptive_tolerance=args.adaptive,
        sampler=args.sampler,
    )
    key = jax.random.PRNGKey(args.seed)

    if args.adaptive > 0.0:
        from raytracer_tpu.render.api import resolve_backend

        if resolve_backend(args.backend) != "pallas" or args.progressive_frames > 0:
            # only the Pallas batch render samples adaptively; anything
            # else runs fixed spp
            print(
                "warning: --adaptive requires the Pallas batch backend; "
                "rendering fixed spp",
                file=sys.stderr,
            )

    if args.aov:
        from raytracer_tpu.render.debug import render_aov

        t0 = time.perf_counter()
        image = render_aov(scene, cam, w, h, args.aov, key)
        elapsed = time.perf_counter() - t0
        from raytracer_tpu.app import io

        io.save_png(args.out, image)
        print(f"{args.config} AOV={args.aov}: {w}x{h} -> {args.out} ({elapsed:.3f}s)")
        return 0

    t0 = time.perf_counter()
    if args.progressive_frames > 0:
        if args.spp_map:
            print(
                "warning: --spp-map needs an adaptive batch render; "
                "progressive mode renders fixed spp per frame — skipped",
                file=sys.stderr,
            )
        # scene and camera are fixed for the whole accumulation: hand the
        # factory concrete hints so the Pallas split-scan analysis runs
        step = make_step_fn(w, h, spp=spp, opts=opts,
                            static_scene=scene, static_camera=cam)
        state = init_render_state(w, h, key)
        state, segments = run_frames(step, state, scene, cam, args.progressive_frames)
        image = state.accum
    else:
        image, stats = render_image(
            scene, cam, w, h, spp, key, opts, return_stats=True
        )
        image = np.asarray(image)
        segments = float(stats["segments"])
        if "mean_spp" in stats:
            print(f"adaptive: mean effective spp "
                  f"{float(stats['mean_spp']):.1f} of {spp}")
        if args.spp_map:
            if "spp_map" in stats:
                from raytracer_tpu.app import io

                m = np.asarray(stats["spp_map"], dtype=np.float32)
                heat = m / max(float(m.max()), 1.0)
                io.save_png(
                    args.spp_map, np.repeat(heat[..., None], 3, axis=-1)
                )
                print(f"spp map -> {args.spp_map} "
                      f"(min {m.min():.0f}, max {m.max():.0f} spp)")
            else:
                print(
                    "warning: --spp-map needs an adaptive render "
                    "(--adaptive TOL on the Pallas batch backend); skipped",
                    file=sys.stderr,
                )
    elapsed = time.perf_counter() - t0

    from raytracer_tpu.app import io

    io.save_png(args.out, image)
    print(
        f"{args.config}: {w}x{h} spp={spp} depth={depth} "
        f"backend={args.backend} -> {args.out}\n"
        f"wall={elapsed:.3f}s rays={segments/1e6:.1f}M "
        f"({mrays_per_sec(segments, elapsed):.1f} Mrays/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
