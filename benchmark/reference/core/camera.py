# Frozen copy of renderer_tpu_torch/core/camera.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Camera, reverse-Z projection, and coordinate systems.

Parity: renderer/src/renderer/scene/camera.rs:6-63 and
renderer/src/renderer/scene/coordinate_system.rs:10-31. Depth is always
reversed (1 = near, 0 = far); vertical FOV is fixed at 74 degrees; the far
plane is optional (None = infinite). Clip space is Vulkan's: +X right,
+Y down, +Z forward, depth in [0, 1].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.core import math3d

FOV_Y_RADIANS = np.radians(74.0)


@dataclass(frozen=True)
class CoordinateSystem:
    """A world-space axis convention; see coordinate_system.rs:10-16."""

    up: tuple[float, float, float]
    right: tuple[float, float, float]
    forward: tuple[float, float, float]

    def create_transform_to(self, target: "CoordinateSystem") -> np.ndarray:
        """Change-of-basis 4x4 from this space to `target`
        (coordinate_system.rs:20-31)."""

        def basis(cs: "CoordinateSystem") -> np.ndarray:
            m = np.eye(4, dtype=np.float64)
            m[:3, 0] = cs.right
            m[:3, 1] = cs.up
            m[:3, 2] = cs.forward
            return m

        return (basis(target) @ np.linalg.inv(basis(self))).astype(np.float32)


VULKAN = CoordinateSystem(up=(0, -1, 0), right=(1, 0, 0), forward=(0, 0, 1))
QUAKE = CoordinateSystem(up=(0, 0, 1), right=(0, -1, 0), forward=(1, 0, 0))
GLTF = CoordinateSystem(up=(0, 1, 0), right=(-1, 0, 0), forward=(0, 0, 1))


def _proj(fov: float, aspect_ratio: float, m22: float, m23: float, m32: float) -> np.ndarray:
    """camera.rs:35-39 (glam column-major cols → rows here)."""
    sy = 1.0 / np.tan(fov / 2.0)
    sx = sy / aspect_ratio
    return np.array(
        [
            [sx, 0, 0, 0],
            [0, sy, 0, 0],
            [0, 0, m22, m32],
            [0, 0, m23, 0],
        ],
        dtype=np.float32,
    )


def projection_reverse_z(fov: float, aspect_ratio: float, near: float, far: float) -> np.ndarray:
    """Finite-far reverse-Z projection (camera.rs:23-27): depth(z) = n(f-z)/((f-n)z)."""
    flip_z = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 1], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip_z @ _proj(fov, aspect_ratio, far / (far - near), 1.0, -(far * near) / (far - near))


def projection_reverse_z_inf_far(fov: float, aspect_ratio: float, near: float) -> np.ndarray:
    """Infinite-far reverse-Z projection (camera.rs:30-32): depth(z) = n/z."""
    return _proj(fov, aspect_ratio, 0.0, 1.0, near)


def create_proj(width: float, height: float, near: float, far: float | None) -> np.ndarray:
    aspect = width / height
    if far is not None:
        return projection_reverse_z(FOV_Y_RADIANS, aspect, near, far)
    return projection_reverse_z_inf_far(FOV_Y_RADIANS, aspect, near)


_PROJ_CACHE: dict = {}
_PROJ_CACHE_MAX = 64  # bounded: an app animating near/far must not grow
# the module-global dict by one 4x4 per frame forever


def _cached_projection(width: float, height: float, near: float,
                       far: float | None,
                       world_space: CoordinateSystem) -> np.ndarray:
    """create_proj(...) @ world→Vulkan basis change — constant per camera
    configuration, cached: rebuilding it per frame costs ~40 µs of numpy
    overhead (incl. a LAPACK inverse) in the per-frame host prologue."""
    key = (width, height, near, far, world_space)
    m = _PROJ_CACHE.get(key)
    if m is None:
        vk_from_world = world_space.create_transform_to(VULKAN)
        m = create_proj(width, height, near, far) @ vk_from_world
        while len(_PROJ_CACHE) >= _PROJ_CACHE_MAX:
            _PROJ_CACHE.pop(next(iter(_PROJ_CACHE)))
        _PROJ_CACHE[key] = m
    return m


@dataclass
class Camera:
    """camera.rs:41-53. `orientation` is a UNIT [x,y,z,w] quaternion mapping
    camera-local Vulkan axes to world axes (the analytic view inverse in
    proj_view assumes Rᵀ = R⁻¹); `far=None` = infinite projection."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    orientation: np.ndarray = field(default_factory=math3d.quat_identity)
    near: float = 0.1
    far: float | None = 100.0

    def proj_view(
        self, width: float, height: float, world_space: CoordinateSystem = VULKAN
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (projection, view) 4x4s; camera.rs:55-62. The full
        vertex transform is projection @ view @ model.

        Hot path (called per frame): the projection side is cached and the
        view matrix is the ANALYTIC inverse of the rotation+translation
        pose — view = [Rᵀ | −Rᵀp] (pure scalar math; the general
        `affine_inverse` runs a LAPACK solve, ~45 µs of the prologue)."""
        q = self.orientation
        x, y, z, w = float(q[0]), float(q[1]), float(q[2]), float(q[3])
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        wx, wy, wz = w * x, w * y, w * z
        # rows of Rᵀ = columns of R (quat_to_mat3 layout)
        r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy)
        r10, r11, r12 = 2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx)
        r20, r21, r22 = 2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy)
        px, py, pz = (float(self.position[0]), float(self.position[1]),
                      float(self.position[2]))
        view = np.array([
            [r00, r01, r02, -(r00 * px + r01 * py + r02 * pz)],
            [r10, r11, r12, -(r10 * px + r11 * py + r12 * pz)],
            [r20, r21, r22, -(r20 * px + r21 * py + r22 * pz)],
            [0.0, 0.0, 0.0, 1.0],
        ], dtype=np.float32)
        projection = _cached_projection(
            float(width), float(height), float(self.near),
            None if self.far is None else float(self.far), world_space,
        )
        return projection, view
