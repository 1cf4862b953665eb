"""Cluster acceleration structure tests: bounds correctness and
permutation integrity of the host-side partitions."""

import numpy as np

from raytracer_tpu.scene import presets
from raytracer_tpu.scene.accel import build_clustered


def test_clusters_cover_all_spheres():
    scene = presets.cover_scene()
    cl = build_clustered(scene, group=16)
    k = cl.bounds.shape[0]
    assert cl.scene.count == k * 16
    # every active sphere appears exactly once in the permutation
    uuid = np.asarray(cl.uuid)
    live = uuid[uuid >= 0]
    assert sorted(live.tolist()) == list(range(scene.count))
    # active count preserved
    assert int(np.asarray(cl.scene.active).sum()) == scene.count


def test_bounds_contain_members():
    scene = presets.cover_scene()
    cl = build_clustered(scene, group=16)
    c = np.asarray(cl.scene.center)
    r = np.abs(np.asarray(cl.scene.radius))
    act = np.asarray(cl.scene.active) > 0
    b = np.asarray(cl.bounds)
    for ci in range(b.shape[0]):
        if b[ci, 3] < 0:
            continue
        sl = slice(ci * 16, (ci + 1) * 16)
        for j in range(sl.start, sl.stop):
            if not act[j]:
                continue
            d = np.linalg.norm(c[j] - b[ci, :3]) + r[j]
            assert d <= b[ci, 3] * 1.001, (ci, j, d, b[ci, 3])


def test_small_scene_single_cluster():
    scene = presets.demo_scene()
    cl = build_clustered(scene, group=16)
    assert cl.bounds.shape[0] == 1
    # the demo scene's moon (radius 100) inflates the bound — still valid
    assert float(cl.bounds[0, 3]) > 100.0




def test_grid_clustered_partition():
    """Round-2 partition: globals + tight grid-cell clusters cover every
    sphere exactly once and bounds contain their members."""
    from raytracer_tpu.scene.accel import build_grid_clustered

    scene = presets.cover_scene()
    g = build_grid_clustered(scene)
    uuid = np.asarray(g.uuid)
    live = uuid[uuid >= 0]
    assert sorted(live.tolist()) == list(range(scene.count))
    assert g.n_global >= 1  # the ground sphere at least
    # bounds contain members
    c = np.asarray(g.scene.center)
    r = np.abs(np.asarray(g.scene.radius))
    b = np.asarray(g.bounds)
    for ci in range(b.shape[0]):
        lo = g.n_global + ci * g.group
        for j in range(lo, lo + g.group):
            if uuid[j] < 0:
                continue
            d = np.linalg.norm(c[j] - b[ci, :3]) + r[j]
            assert d <= b[ci, 3] * 1.001
    # bounds are tight (mean radius ~1 for 2-unit cells of 0.2-spheres)
    assert float(b[:, 3].mean()) < 1.6
