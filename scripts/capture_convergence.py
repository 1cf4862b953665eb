"""Full-frame convergence ground truth for the cover scene.

Renders the cover at FULL 1200x800, 500 spp both ways:
  - the Pallas kernel (rr5 — the bench headline physics)
  - the independent jnp tracer (rr0 — pure reference physics)
prints mean|delta| as one JSON line, and saves the jnp image as the
float16 golden tests/goldens/cover_jnp_rr0_500spp_f16.npz that
chip_smoke.py and ``BENCH_CONVERGENCE=golden`` compare against.

    python scripts/capture_convergence.py     # on one GPU
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import time

import jax
import numpy as np

from raytracer_tpu.utils.jaxcache import enable_persistent_cache

enable_persistent_cache()

from raytracer_tpu.render.api import render_image  # noqa: E402
from raytracer_tpu.render.options import TraceOptions  # noqa: E402
from raytracer_tpu.scene import presets  # noqa: E402

ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def main():
    scene, cam, w, h, spp, depth = presets.get_config("cover")
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    img_p = np.asarray(render_image(
        scene, cam, w, h, spp, key,
        TraceOptions(max_depth=depth, russian_roulette_depth=5,
                     backend="pallas"),
    ))
    wall_p = time.perf_counter() - t0
    print(f"pallas rr5 {w}x{h} {spp}spp: {wall_p:.1f}s", flush=True)

    t0 = time.perf_counter()
    img_j = np.asarray(render_image(
        scene, cam, w, h, spp, jax.random.fold_in(key, 1000),
        TraceOptions(max_depth=depth, backend="jnp"),
    ))
    wall_j = time.perf_counter() - t0
    print(f"jnp rr0 {w}x{h} {spp}spp: {wall_j:.1f}s", flush=True)

    diff = np.abs(img_p.astype(np.float64) - img_j.astype(np.float64))
    n_nan = int(np.isnan(diff).sum())
    mad = float(np.nanmean(diff))
    p99 = float(np.nanpercentile(diff, 99))
    result = {
        "config": f"cover_{w}x{h}_spp{spp}_depth{depth}",
        "pallas": "rr5 kernel",
        "reference": "independent jnp tracer, rr0",
        "mean_abs_diff": round(mad, 6),
        "p99_abs_diff": round(p99, 6),
        "nan_px_channels": n_nan,
        "pallas_wall_s": round(wall_p, 2),
        "jnp_wall_s": round(wall_j, 2),
    }
    np.savez_compressed(
        _os.path.join(ROOT, "tests", "goldens",
                      "cover_jnp_rr0_500spp_f16.npz"),
        image=img_j.astype(np.float16),
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
