"""Acceleration structure: sphere clusters with bounding spheres.

The reference tests every ray against all 15 sphere slots every bounce
(static/shader.frag:182-193) — fine at 15, hopeless at ~500. Instead of a
pointer-chasing tree this builds a flat two-level scheme.

Spheres are grouped into fixed-size clusters with conservative bounding
spheres; all cluster geometry is static host-prepared data — the device
never builds or traverses pointers.

Nothing in the render path walks these partitions yet: they are the
host-side half of a per-ray cluster walk (ROADMAP S5), in which each
thread tests only the clusters its own ray enters.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracer_tpu.core import pytree

from raytracer_tpu.scene.spheres import Scene

DEFAULT_GROUP = 16


@pytree.dataclass
class ClusteredScene:
    """A Scene reordered into clusters, plus cluster bounding spheres.

    ``scene.count == n_clusters * group`` (padded with inactive slots).
    ``bounds`` is (K, 4): center xyz + radius; radius < 0 marks an empty
    (padding) cluster that can never be hit. ``uuid`` maps reordered slot →
    original sphere index (for picking parity).
    """

    scene: Scene
    bounds: jnp.ndarray  # (K, 4) f32
    uuid: jnp.ndarray  # (K*group,) i32

    @property
    def group(self) -> int:
        return self.scene.count // self.bounds.shape[0]


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit xyz quantized coords into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def build_clustered(scene: Scene, group: int = DEFAULT_GROUP) -> ClusteredScene:
    """Host-side cluster build (requires a concrete, non-traced scene)."""
    centers = np.asarray(scene.center, dtype=np.float64)
    radii = np.asarray(scene.radius, dtype=np.float64)
    active = np.asarray(scene.active) > 0.0
    n = centers.shape[0]

    # Morton order over active sphere centers (inactive slots go last).
    lo = centers[active].min(axis=0) if active.any() else np.zeros(3)
    hi = centers[active].max(axis=0) if active.any() else np.ones(3)
    span = np.maximum(hi - lo, 1e-9)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
    codes = _morton3(q)
    codes[~active] = np.uint64(0xFFFFFFFFFFFF)  # inactive last
    order = np.argsort(codes, kind="stable")

    k = max(1, -(-n // group))
    padded = k * group

    def take(arr, fill=0.0):
        a = np.asarray(arr)[order]
        if padded > n:
            pad_shape = (padded - n,) + a.shape[1:]
            a = np.concatenate([a, np.full(pad_shape, fill, a.dtype)], axis=0)
        return a

    new_scene = Scene(
        center=jnp.asarray(take(scene.center), jnp.float32),
        radius=jnp.asarray(take(scene.radius, 1.0), jnp.float32),
        material_type=jnp.asarray(take(scene.material_type), jnp.int32),
        albedo=jnp.asarray(take(scene.albedo), jnp.float32),
        fuzz=jnp.asarray(take(scene.fuzz), jnp.float32),
        refraction_index=jnp.asarray(take(scene.refraction_index, 1.0), jnp.float32),
        active=jnp.asarray(take(scene.active), jnp.float32),
    )
    uuid = np.concatenate([order, np.full(padded - n, -1)]).astype(np.int32)

    c_sorted = np.asarray(new_scene.center, np.float64)
    r_sorted = np.abs(np.asarray(new_scene.radius, np.float64))
    a_sorted = np.asarray(new_scene.active) > 0.0
    bounds = np.zeros((k, 4), np.float32)
    for ci in range(k):
        sl = slice(ci * group, (ci + 1) * group)
        act = a_sorted[sl]
        if not act.any():
            bounds[ci] = (0.0, 0.0, 0.0, -1.0)  # never hit
            continue
        pts = c_sorted[sl][act]
        rs = r_sorted[sl][act]
        center = pts.mean(axis=0)
        radius = float(np.max(np.linalg.norm(pts - center, axis=1) + rs))
        bounds[ci] = (*center.astype(np.float32), np.float32(radius * 1.0001))

    return ClusteredScene(
        scene=new_scene, bounds=jnp.asarray(bounds), uuid=jnp.asarray(uuid)
    )


@pytree.dataclass
class GridClusteredScene:
    """Ground-separated partition: big spheres split into an
    always-tested "global" set; small spheres grouped by 2-D grid cell over
    (x, z) with tight bounding spheres (or by kd bisection, _kd_chunks).

    Counted on the RTiOW cover scene (host-side, from the geometry): a
    primary ray's segment intersects only ~4.8 of 144 cell bounds (vs 9.1
    of 16 Morton bounds).
    """

    scene: Scene  # global spheres first, then cell clusters, padded per-cell
    bounds: jnp.ndarray  # (K, 4) cell bounding spheres
    n_global: int = pytree.field(pytree_node=False)
    group: int = pytree.field(pytree_node=False)
    uuid: jnp.ndarray  # slot -> original index (-1 padding)
    #: (K, 6) per-cluster member AABBs [lo xyz, hi xyz] — the alternative
    #: broad-phase bound to the bounding spheres. The cover's
    #: small spheres form a thin slab over the ground, so the AABB
    #: (~cell x ~1.4 x cell) is far tighter than the bounding sphere
    #: (radius ~ half the cell diagonal + member radius) for the
    #: near-horizontal rays that dominate the segment population.
    boxes: jnp.ndarray = None


def _kd_chunks(idx, centers, radii, group):
    """Balanced recursive median bisection of sphere indices into
    ceil(n/group) leaves of <= group members each.

    Full leaves mean fewer clusters for the same spheres: the cover's
    4.0-cell grid lands at K=36 clusters 9-16/16 full, while this split
    packs the same 484 spheres into K=32 leaves of 15-16. Splits are by
    the longest axis of
    the member-AABB at the median, child sizes chosen in multiples of
    `group` so no leaf overflows and the leaf count is minimal."""
    idx = np.asarray(idx, np.int64)
    n = len(idx)
    if n <= group:
        return [list(idx)]
    lo = (centers[idx] - np.abs(radii[idx])[:, None]).min(axis=0)
    hi = (centers[idx] + np.abs(radii[idx])[:, None]).max(axis=0)
    axis = int(np.argmax(hi - lo))
    # left gets half the leaves; member count split proportionally so
    # every leaf ends up ~n/leaves full (no ragged remainder leaf),
    # clamped so neither side overflows its leaves' group capacity
    leaves = -(-n // group)
    l_left = leaves // 2
    n_left = int(round(n * l_left / leaves))
    n_left = max(n - (leaves - l_left) * group,
                 min(l_left * group, n_left))
    order = idx[np.argsort(centers[idx, axis], kind="stable")]
    return (_kd_chunks(order[:n_left], centers, radii, group)
            + _kd_chunks(order[n_left:], centers, radii, group))


def build_grid_clustered(
    scene: Scene,
    cell_size: float = 2.0,
    big_radius: float = 0.5,
    group: int = 8,
    partition: str = "grid",
) -> GridClusteredScene:
    """Host-side build of the ground-separated partition: 'grid' (2-D
    cells over (x, z)) or 'kd' (balanced median bisection, _kd_chunks)."""
    centers = np.asarray(scene.center, np.float64)
    radii = np.asarray(scene.radius, np.float64)
    active = np.asarray(scene.active) > 0.0
    big = (np.abs(radii) > big_radius) & active
    small = active & ~big

    order = list(np.where(big)[0])
    n_global = len(order)

    if partition == "kd":
        chunks = ([] if not small.any()
                  else _kd_chunks(np.where(small)[0], centers, radii,
                                  group))
    else:
        cells: dict = {}
        for i in np.where(small)[0]:
            key = (
                int(np.floor(centers[i, 0] / cell_size)),
                int(np.floor(centers[i, 2] / cell_size)),
            )
            cells.setdefault(key, []).append(int(i))

        chunks = []
        for members in cells.values():
            # split oversize cells into chunks of `group`
            for c0 in range(0, len(members), group):
                chunks.append(members[c0 : c0 + group])

    bounds = []
    boxes = []
    slots = []  # original index or -1 per padded slot
    for chunk in chunks:
        pts = centers[chunk]
        rs = np.abs(radii[chunk])
        ctr = pts.mean(axis=0)
        rad = float(np.max(np.linalg.norm(pts - ctr, axis=1) + rs))
        bounds.append((*ctr.astype(np.float32), np.float32(rad * 1.0001)))
        lo = (pts - rs[:, None]).min(axis=0)
        hi = (pts + rs[:, None]).max(axis=0)
        # widen by an absolute+relative margin (the sphere bound's
        # 1.0001 analog) so f32 rounding can't shave a member surface
        lo = lo - (1e-4 + 1e-4 * np.abs(lo))
        hi = hi + (1e-4 + 1e-4 * np.abs(hi))
        boxes.append((*lo.astype(np.float32), *hi.astype(np.float32)))
        slots.extend(list(chunk) + [-1] * (group - len(chunk)))

    uuid = np.array(order + slots, dtype=np.int32)
    total = len(uuid)

    def take(src, fill=0.0):
        a = np.asarray(src)
        out_shape = (total,) + a.shape[1:]
        out = np.full(out_shape, fill, a.dtype)
        live = uuid >= 0
        out[live] = a[uuid[live]]
        return out

    new_scene = Scene(
        center=jnp.asarray(take(scene.center), jnp.float32),
        radius=jnp.asarray(take(scene.radius, 1.0), jnp.float32),
        material_type=jnp.asarray(take(scene.material_type), jnp.int32),
        albedo=jnp.asarray(take(scene.albedo), jnp.float32),
        fuzz=jnp.asarray(take(scene.fuzz), jnp.float32),
        refraction_index=jnp.asarray(
            take(scene.refraction_index, 1.0), jnp.float32
        ),
        active=jnp.asarray((uuid >= 0).astype(np.float32)),
    )
    return GridClusteredScene(
        scene=new_scene,
        bounds=jnp.asarray(np.array(bounds, np.float32)),
        n_global=n_global,
        group=group,
        uuid=jnp.asarray(uuid),
        boxes=jnp.asarray(np.array(boxes, np.float32).reshape(-1, 6)),
    )
