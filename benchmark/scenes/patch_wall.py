# The layout and materials are a frozen copy of
# renderer_tpu_torch/assets/demo_scenes.py `patch_wall_scene`,
# `_patch_materials`, `_patches` and `checker_texture` at commit 5822f29, with
# the checker's colours and per-cell alpha drawn from the seed (the sizes,
# the cell pattern and the share of each alpha value are the same for every
# seed). Part of the benchmark's yardstick; do not edit.
"""The patch wall: `n_patches` procedural patches of 2·grid² triangles in
three staggered walls of 8×2 panels, materials cycling textured-opaque,
alpha-to-coverage and blended."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.geometry import _patch_geometry, quat_from_axis_angle, trs
from benchmark.scenes.scene import SceneDesc

#: the checker cells' alpha values, an equal share each (under the masked
#: material's factor 0.9 and cutoff 0.4: covered on every sample, on two
#: of four, and failing the cutoff)
CELL_ALPHA = (255, 160, 64)


def checker(rng: np.random.Generator, side: int = 64, cell: int = 8):
    """A side × side sRGB checker with a full mip chain (each level every
    other texel of the last): two colours from `rng`, and each cell's alpha
    one of CELL_ALPHA, an equal share each, in an order from `rng`."""
    c0, c1 = rng.integers(0, 256, (2, 3))
    n = side // cell
    alpha = np.resize(np.array(CELL_ALPHA, np.uint8), n * n)
    alpha = rng.permutation(alpha).reshape(n, n)
    yy, xx = np.mgrid[0:side, 0:side]
    odd = ((xx // cell + yy // cell) % 2).astype(bool)
    base = np.empty((side, side, 4), np.uint8)
    base[..., :3] = np.where(odd[..., None], c1, c0)
    base[..., 3] = alpha[yy // cell, xx // cell]
    mips, m = [base], base
    while m.shape[0] > 1:
        m = m[::2, ::2]
        mips.append(m)
    return mips


def make(params: dict, rng: np.random.Generator) -> SceneDesc:
    n, grid = params["n_patches"], params["grid"]
    meshes = [_patch_geometry((grid + 1) ** 2, 6 * grid * grid, [-0.8, -0.5, -0.2],
                              [0.8, 0.5, 0.2], seed=100 + i) for i in range(n)]
    textures = [(checker(rng), "srgb")]
    materials = [
        ("tex-opaque", {}, 0),
        ("masked", {"alpha_cutoff": 0.4, "base_color_factor": (1, 1, 1, 0.9),
                    "alpha_mode": "mask"}, 0),
        ("blended", {"base_color_factor": (0.2, 0.9, 0.4, 0.45), "alpha_mode": "blend"},
         None),
    ]
    yaw = quat_from_axis_angle([0, 1, 0], np.pi)
    draws = []
    for i in range(n):
        wall, slot = divmod(i, 16)
        row, col = divmod(slot, 8)
        tr = trs(translation=np.array([(col - 3.5) * 1.1 + 0.45 * wall,
                                       0.9 + (row - 0.5) * 0.9, -0.7 * wall], np.float32),
                 rotation=yaw)
        draws.append((i, i % 3, tr))
    return SceneDesc(meshes, textures, materials, draws)
