"""Benchmark harness: the BASELINE.md headline metric on one GPU.

Renders the RTiOW final cover scene (~480 spheres) at 1200x800, 500 spp,
depth 50 and reports Mrays/s (a "ray" = one live ray-bounce segment, counted
exactly on device). Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N/500, ...}

vs_baseline is against the 500 Mrays/s target from BASELINE.json. The line
names the device it ran on; a run whose default device is not a GPU prints
an error line and exits 2 instead of timing it.

Env knobs: BENCH_CONFIG ('cover' default; 'all' for the full matrix;
'progressive' for BASELINE config 4 — steady-state 1-spp frames at 1080p),
BENCH_SPP, BENCH_BACKEND, BENCH_REPEATS, BENCH_RR (Russian-roulette start
bounce; default 5, 0 = pure reference physics). When RR is on, an rr0
companion run is always reported (stderr + rr0_* JSON fields;
BENCH_SKIP_RR0=1 to skip). BENCH_CONVERGENCE=golden compares one fresh
full-frame render against the committed jnp rr0 ground truth
(tests/goldens/). An adaptive-sampling companion runs by default at
tol=0.2; BENCH_ADAPTIVE sets the tolerance (0 disables),
BENCH_ADAPTIVE_CHUNK the chunk size and BENCH_ADAPTIVE_SAMPLER (default
stratified) its sampler; its mad reference is a fixed-spp render of the
SAME sampler. BENCH_SAMPLER=stratified switches the headline's camera
draws to the R2 low-discrepancy sampler.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

BASELINE_MRAYS = 500.0
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "goldens", "cover_jnp_rr0_500spp_f16.npz")


def device_info() -> dict:
    """The device this process times, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _timed(fn, key, repeats):
    """Warm once, then best-of-``repeats`` wall; returns (wall, result of
    the SAME repeat — RR makes segment counts key-dependent)."""
    import jax

    fn(key)
    best, out = None, None
    for i in range(repeats):
        t0 = time.perf_counter()
        res = fn(jax.random.fold_in(key, i))
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, out = dt, res
    return best, out


def _render_fn(scene, cam, w, h, spp, opts):
    import numpy as np

    from raytracer_tpu.render.api import render_image

    def run(k):
        img, stats = render_image(scene, cam, w, h, spp, k, opts,
                                  return_stats=True)
        return np.asarray(img), stats

    return run


def _bench_one(config, backend, repeats):
    import jax

    from raytracer_tpu.render.options import TraceOptions
    from raytracer_tpu.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config(config)
    opts = TraceOptions(max_depth=depth, backend=backend,
                        russian_roulette_depth=int(
                            os.environ.get("BENCH_RR", "5")))
    wall, (_, stats) = _timed(_render_fn(scene, cam, w, h, spp, opts),
                              jax.random.PRNGKey(0), repeats)
    return w, h, spp, depth, wall, float(stats["segments"])


def _bench_progressive(config="demo", width=1920, height=1080,
                       frames=256, batch=32):
    """BASELINE config 4: realtime progressive 1 spp/frame at 1080p.
    Steady-state jitted step with buffer donation (the reference's primary
    use case, static/shader.frag:387-404 + src/state.rs:127-135 defaults).
    Frames are timed in batches with one scalar sync per batch — the
    viewer's consumption pattern. Returns the result dict."""
    import jax

    from raytracer_tpu.progressive.state import init_render_state
    from raytracer_tpu.progressive.step import make_step_fn
    from raytracer_tpu.render.options import DebugParams, TraceOptions
    from raytracer_tpu.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config(config, width, height)
    backend = os.environ.get("BENCH_BACKEND", "auto")
    step = make_step_fn(w, h, spp=1, opts=TraceOptions(max_depth=8),
                        backend=backend)
    state = init_render_state(w, h, jax.random.PRNGKey(0))
    debug = DebugParams.none()
    for _ in range(5):  # warm: compile + steady accumulation
        state, aux = step(state, scene, cam, debug)
    float(aux["segments"])
    best, segs_frame, done = None, 0.0, 0
    while done < frames:
        n = min(batch, frames - done)
        t0 = time.perf_counter()
        for _ in range(n):
            state, aux = step(state, scene, cam, debug)
        segs = float(aux["segments"])  # one sync per batch
        dt = (time.perf_counter() - t0) / n
        done += n
        if best is None or dt < best:
            best, segs_frame = dt, segs
    return {
        "metric": f"progressive_{config}_{w}x{h}_1spp_d8 fps",
        "value": round(1.0 / best, 1),
        "unit": "fps",
        "vs_baseline": None,  # the reference publishes no number; see
        # BASELINE.md ("interactive rates" on a desktop GPU at <=1280px)
        "ms_per_frame": round(best * 1e3, 2),
        "frames": frames,
        "segments_per_frame": segs_frame,
        "backend": backend,
    }


def _bench_cover(config, backend, repeats) -> dict:
    import jax
    import numpy as np

    from raytracer_tpu.render.options import TraceOptions
    from raytracer_tpu.scene import presets

    scene, cam, w, h, spp, depth = presets.get_config(config)
    spp = int(os.environ.get("BENCH_SPP", spp))
    # unbiased Russian roulette from bounce 5 (BENCH_RR=0 to disable)
    rr = int(os.environ.get("BENCH_RR", "5"))
    opts = TraceOptions(
        max_depth=depth, backend=backend, russian_roulette_depth=rr,
        sampler=os.environ.get("BENCH_SAMPLER", "random"),
    )
    key = jax.random.PRNGKey(0)
    wall, (_, stats) = _timed(_render_fn(scene, cam, w, h, spp, opts), key,
                              repeats)
    segments = float(stats["segments"])
    mrays = segments / wall / 1e6
    result = {
        "metric": (f"{config}_{w}x{h}_spp{spp}_depth{depth}"
                   + (f"_rr{rr}" if rr else "") + " Mrays/sec/chip"),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "wall_s": round(wall, 3),
        "segments": segments,
        "backend": backend,
    }

    if rr and not os.environ.get("BENCH_SKIP_RR0"):
        # the same render under pure reference physics (no Russian
        # roulette), so the headline's RR benefit is always reported
        opts0 = dataclasses.replace(opts, russian_roulette_depth=0)
        wall0, (_, st0) = _timed(_render_fn(scene, cam, w, h, spp, opts0),
                                 key, 1)
        result["rr0_mrays"] = round(float(st0["segments"]) / wall0 / 1e6, 2)
        result["rr0_wall_s"] = round(wall0, 3)
        print(f"rr0 (pure reference physics): {result['rr0_mrays']} "
              f"Mrays/s wall={wall0:.3f}s", file=sys.stderr)

    # adaptive-sampling companion (never the headline): per-pixel early
    # termination at the given 95%-CI tolerance; reports wall, effective
    # mean spp and mean|Δ| vs a fixed-spp render of the same sampler
    tol = float(os.environ.get("BENCH_ADAPTIVE", "0.2"))
    best_img = None
    if tol > 0.0:
        sampler_a = os.environ.get("BENCH_ADAPTIVE_SAMPLER", "stratified")
        opts_ref = dataclasses.replace(opts, sampler=sampler_a)
        opts_a = dataclasses.replace(
            opts_ref, adaptive_tolerance=tol,
            adaptive_chunk_spp=int(os.environ.get("BENCH_ADAPTIVE_CHUNK",
                                                  "0")),
        )
        img_fixed, _ = _render_fn(scene, cam, w, h, spp, opts_ref)(key)
        wall_a, (best_img, st_a) = _timed(
            _render_fn(scene, cam, w, h, spp, opts_a), key, repeats
        )
        mspp = float(st_a.get("mean_spp", spp))
        mad_a = float(np.abs(best_img - img_fixed).mean())
        result.update(adaptive_tol=tol, adaptive_sampler=sampler_a,
                      adaptive_wall_s=round(wall_a, 3),
                      adaptive_mean_spp=round(mspp, 1),
                      adaptive_mad_vs_fixed=round(mad_a, 6))
        print(f"adaptive(tol={tol}, {sampler_a}): wall={wall_a:.3f}s "
              f"mean_spp={mspp:.1f}/{spp} mean|Δ| vs fixed = {mad_a:.2e}",
              file=sys.stderr)

    conv_mode = os.environ.get("BENCH_CONVERGENCE")
    if conv_mode == "golden":
        if config != "cover" or spp != 500:
            raise ValueError(f"golden is cover@500spp, bench is "
                             f"{config}@{spp}spp")
        # FULL-FRAME physics regression against the committed jnp rr0
        # ground truth: expected mean|Δ| is the rr5-vs-rr0 difference
        # plus Monte-Carlo noise
        golden = np.load(GOLDEN)["image"].astype(np.float64)
        img_p, _ = _render_fn(scene, cam, w, h, spp, opts)(key)
        mad = float(np.abs(np.asarray(img_p, np.float64) - golden).mean())
        result["convergence_mad_vs_golden"] = round(mad, 6)
        print(f"convergence: rr{rr} vs stored jnp(rr0) golden @ {spp} spp "
              f"mean|Δ|={mad:.2e}", file=sys.stderr)
        if best_img is not None:
            mad_ag = float(np.abs(best_img.astype(np.float64)
                                  - golden).mean())
            result["adaptive_golden_mad"] = round(mad_ag, 6)
    return result


def main() -> int:
    config = os.environ.get("BENCH_CONFIG", "cover")
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    backend = os.environ.get("BENCH_BACKEND", "auto")

    from raytracer_tpu.utils.jaxcache import enable_persistent_cache

    dev = device_info()
    if dev["platform"] != "gpu":
        print(json.dumps({"metric": f"{config}", "value": 0.0,
                          "error": f"no GPU to time (device {dev})",
                          "device": dev}))
        return 2
    enable_persistent_cache()

    if config == "progressive":
        result = _bench_progressive()
    else:
        if config == "all":
            # the BASELINE matrix: per-config lines to stderr, headline
            # last; any failure fails the run
            for name in ("two_sphere", "three_sphere", "dof"):
                w, h, spp, depth, wall, segs = _bench_one(name, backend,
                                                          repeats)
                print(f"{name}: {w}x{h} spp{spp} d{depth} wall={wall:.3f}s "
                      f"-> {segs / wall / 1e6:.1f} Mrays/s", file=sys.stderr)
            r = _bench_progressive()
            print(f"progressive: 1920x1080 1spp d8 {r['ms_per_frame']:.1f} "
                  f"ms/frame -> {r['value']:.1f} fps", file=sys.stderr)
            config = "cover"
        result = _bench_cover(config, backend, repeats)
    result["device"] = dev
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
