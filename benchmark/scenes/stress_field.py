# A frozen copy of renderer_tpu_torch/assets/proxy.py `make_stress_field` and
# renderer_tpu_torch/assets/demo_scenes.py `stress_field_scene` at commit
# 5822f29. Part of the benchmark's yardstick; do not edit.
"""The stress field: `n_meshes` ripple patches of `tris_per_mesh`
triangles tiled over a square field, one opaque untextured material."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.geometry import _patch_geometry
from benchmark.scenes.scene import SceneDesc


def make(params: dict, rng: np.random.Generator) -> SceneDesc:
    n_meshes, extent, seed = params["n_meshes"], params["extent"], params["geometry_seed"]
    # round DOWN to a square-grid-exact count (2·g²), as the original does
    g = max(int(np.sqrt(max(params["tris_per_mesh"] // 2, 1))), 1)
    tris_per_mesh = 2 * g * g
    side = int(np.ceil(np.sqrt(n_meshes)))
    cell = extent / side
    meshes = []
    for i in range(n_meshes):
        gx, gz = i % side, i // side
        lo = (gx * cell - extent / 2, 0.0, gz * cell - extent / 2)
        hi = (lo[0] + cell, 2.0, lo[2] + cell)
        meshes.append(_patch_geometry((g + 1) * (g + 1), tris_per_mesh * 3, lo, hi,
                                      seed + i))
    materials = [("stress-field", {"base_color_factor": (0.7, 0.7, 0.75, 1.0)}, None)]
    draws = [(i, 0, np.eye(4, dtype=np.float32)) for i in range(n_meshes)]
    return SceneDesc(meshes, [], materials, draws)
