"""The port's twin of tests/test_near_clip.py: its CPU path held to the same
oracles and invariants.

Clipless near-plane handling: triangles crossing w = 0 must render their
visible portion (homogeneous rasterization; the reference gets this from
Vulkan's fixed-function clipper)."""

import numpy as np

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import math3d

W, H = 128, 96


def test_floor_crossing_camera_plane():
    # A large floor quad passing under and *behind* the camera. The camera
    # looks along +Z (VULKAN world, identity orientation) from y=-1 (up is
    # -Y): the floor at y=+0.5 spans z in [-10, 10] → crosses the eye plane.
    builder = rt.VertexLibraryBuilder()
    positions = np.array(
        [[-10, 0.5, -10], [10, 0.5, -10], [-10, 0.5, 10], [10, 0.5, 10]],
        np.float32,
    )
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    normals = np.tile([0, -1, 0.0], (4, 1)).astype(np.float32)
    tangents = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
    # winding such that the up-facing (-Y) side faces the camera
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint32)
    mesh = builder.add_mesh(positions, uvs, normals, tangents, indices)
    builder.build()

    registry = rt.MaterialRegistry()
    mat = registry.create_material(
        "floor", rt.PbrMaterialParameters(base_color_factor=(1, 0, 1, 1))
    )
    scene = rt.Scene()
    scene.camera.position = np.array([0, -1.0, 0], np.float32)
    scene.camera.far = None  # infinite far, like the flying-camera demo
    ok = scene.queue_mesh(mesh, mat, None, math3d.IDENTITY)
    assert ok

    renderer = cpu_renderer(registry, rt.RenderConfig(width=W, height=H))
    img = renderer.render_frame(scene, debug_mode=1)
    covered = img.sum(axis=-1) > 0

    # Floor fills the bottom of the frame; its far edge (z=10, 1.5 below the
    # camera) projects to NDC y = (1.5/10)·(1/tan 37°) → the expected first
    # covered row.
    assert covered[H - 4].mean() > 0.9, "bottom rows must be covered"
    assert covered[4].mean() < 0.1, "sky rows must be empty"
    sy = 1.0 / np.tan(np.radians(37.0))
    expected_row = ((1.5 / 10.0) * sy * 0.5 + 0.5) * H
    horizon = np.argmax(covered.mean(axis=1) > 0.5)
    assert abs(horizon - expected_row) < 3, (
        f"horizon at {horizon}, expected ≈{expected_row:.1f}"
    )
    # winding check: the floor is front-facing (magenta, not culled)
    assert img[H - 4, W // 2, 0] > 100


def test_fully_behind_camera_culled():
    builder = rt.VertexLibraryBuilder()
    positions = np.array([[-1, 0, -5], [1, 0, -5], [0, -1, -5]], np.float32)
    uvs = np.zeros((3, 2), np.float32)
    normals = np.tile([0, 0, -1.0], (3, 1)).astype(np.float32)
    tangents = np.tile([1, 0, 0, 1.0], (3, 1)).astype(np.float32)
    mesh = builder.add_mesh(positions, uvs, normals, tangents,
                            np.array([0, 1, 2], np.uint32))
    builder.build()
    registry = rt.MaterialRegistry()
    mat = registry.create_material("m", rt.PbrMaterialParameters())
    scene = rt.Scene()
    scene.queue_mesh(mesh, mat, None, math3d.IDENTITY)
    renderer = cpu_renderer(registry, rt.RenderConfig(width=W, height=H))
    img = renderer.render_frame(scene, debug_mode=1)
    assert (img == 0).all()
