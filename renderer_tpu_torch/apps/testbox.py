"""Testbox demo — the reference mount's asset with real geometry bytes
(`examples/sandbox/src/testbox/testbox.glb`: embedded buffers + a PNG
texture): every index, position, tangent and texel flows from the asset's
own bytes through vertex stage → raster → shade.

Two scenes:
- `build_single`: one testbox, fixed camera;
- `build_field`: an instanced grid of testboxes at Sponza-like triangle
  count (~276k triangles from 90 instances × 3,072).

    python -m renderer_tpu_torch.apps.testbox [out.png] [debug_mode] [device]
"""

from __future__ import annotations

import sys

import numpy as np

import renderer_tpu_torch as rt
from renderer_tpu_torch.apps.sandbox import ASSET_ROOT
from renderer_tpu_torch.assets import png
from renderer_tpu_torch.assets.gltf_loader import load_gltf
from renderer_tpu_torch.core import math3d

TESTBOX = ASSET_ROOT / "testbox/testbox.glb"


def load_testbox(path=TESTBOX, device="cuda"):
    """Returns (registry, library, gltf) for the testbox asset."""
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    gltf = load_gltf(path, builder, registry, device=device)
    library = builder.build()
    return registry, library, gltf


def _aim(scene: rt.Scene, eye, target) -> None:
    pos, orient = math3d.look_at(
        np.asarray(eye, np.float32), np.asarray(target, np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
    )
    scene.camera.position, scene.camera.orientation = pos, orient


def build_single(gltf) -> rt.Scene:
    """One testbox, deterministic camera. The box spans ~[-0.84, 0.84]^3."""
    scene = rt.Scene(world_space=rt.GLTF)
    _aim(scene, [0.95, 0.7, 1.3], [0.0, 0.0, 0.0])
    gltf.queue(scene, math3d.IDENTITY)
    return scene


def build_field(gltf, nx: int = 9, nz: int = 10) -> rt.Scene:
    """nx x nz grid of testboxes (default 90 instances = 276,480 real
    triangles)."""
    scene = rt.Scene(world_space=rt.GLTF)
    ex = 2.2 * (nx - 1) / 2
    ez = 2.2 * (nz - 1) / 2
    _aim(scene, [ex * 1.4, max(ex, ez) * 1.1, ez * 2.4], [0.0, 0.0, 0.0])
    for ix in range(nx):
        for iz in range(nz):
            tr = math3d.trs(translation=np.array(
                [ix * 2.2 - ex, 0.0, iz * 2.2 - ez], np.float32))
            if not gltf.queue(scene, tr):
                raise RuntimeError("draw budget exhausted")
    return scene


def main(out_path: str = "testbox.png", debug_mode: int = 0,
         device="cuda") -> np.ndarray:
    registry, _library, gltf = load_testbox(device=device)
    renderer = rt.Renderer(registry, rt.RenderConfig(width=800, height=608),
                           device=device)
    img = renderer.render_frame(build_single(gltf), debug_mode=int(debug_mode))
    png.write_png(out_path, img)
    print(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]})")
    return img


if __name__ == "__main__":
    main(*sys.argv[1:4])
