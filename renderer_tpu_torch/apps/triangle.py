"""Triangle hello-world — parity with the reference's minimal smoke test
(reference: examples/triangle/src/main.rs:68-161): two copies of one hardcoded
triangle (the second scaled by (2, 0.5, 1)), one green material
(base_color_factor (0.2, 0.8, 0.2, 1)), rendered in debug mode 3 (normals)
with the default camera, on the card unless `device="cpu"` is passed.

    python -m renderer_tpu_torch.apps.triangle [out.png] [debug_mode] [device]
"""

from __future__ import annotations

import sys

import numpy as np

import renderer_tpu_torch as rt
from renderer_tpu_torch.assets import png
from renderer_tpu_torch.core import math3d


def build_triangle_assets():
    """Returns (registry, meshes, material) for the triangle demo."""
    builder = rt.VertexLibraryBuilder()
    positions = np.array([[-0.5, 0.5, 0.8], [0.5, 0.5, 0.8], [-0.1, -0.5, 0.8]], np.float32)
    uvs = np.array([[0.0, 1.0], [1.0, 1.0], [0.5, 0.0]], np.float32)
    normals = np.eye(3, dtype=np.float32)  # X, Y, Z (main.rs:73)
    tangents = np.array([[0, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0]], np.float32)
    indices = np.array([0, 1, 2], np.uint32)
    mesh1 = builder.add_mesh(positions, uvs, normals, tangents, indices)
    mesh2 = builder.add_mesh(positions, uvs, normals, tangents, indices)
    builder.build()

    registry = rt.MaterialRegistry()
    material = registry.create_material(
        "triangle material",
        rt.PbrMaterialParameters(base_color_factor=(0.2, 0.8, 0.2, 1.0)),
    )
    return registry, (mesh1, mesh2), material


def build_scene(meshes, material) -> rt.Scene:
    scene = rt.Scene()
    scene.queue_mesh(meshes[0], material, None, math3d.IDENTITY)
    scene.queue_mesh(meshes[1], material, None, math3d.trs(scale=np.array([2.0, 0.5, 1.0])))
    return scene


def main(out_path: str = "triangle.png", debug_mode: int = 3,
         device="cuda") -> np.ndarray:
    registry, meshes, material = build_triangle_assets()
    renderer = rt.Renderer(registry, rt.RenderConfig(width=800, height=600),
                           device=device)
    img = renderer.render_frame(build_scene(meshes, material),
                                debug_mode=int(debug_mode))
    png.write_png(out_path, img)
    print(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]})")
    return img


if __name__ == "__main__":
    main(*sys.argv[1:4])
