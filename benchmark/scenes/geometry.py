# Frozen copies, at commit 5822f29, of renderer_tpu_torch/assets/proxy.py
# `_patch_geometry` and of renderer_tpu_torch/core/math3d.py `quat_to_mat3`,
# `quat_from_axis_angle`, `trs`, `look_at` and `_mat3_to_quat_scalar`. Part of
# the benchmark's yardstick (its scene generators); do not edit.
"""Procedural patch geometry and the host math the scene generators use."""

from __future__ import annotations

import math

import numpy as np


def _patch_geometry(vertex_count: int, index_count: int, aabb_min, aabb_max, seed: int):
    """A deformed grid patch with exactly vertex_count vertices and
    index_count indices, filling the AABB. Grid topology keeps the triangle
    stream spatially coherent like a real mesh."""
    rng = np.random.default_rng(seed)
    tri_count = index_count // 3
    # grid of (gw+1)x(gh+1) vertices gives 2*gw*gh triangles
    gw = max(int(np.sqrt(max(tri_count // 2, 1))), 1)
    gh = max(tri_count // (2 * gw), 1)
    while (gw + 1) * (gh + 1) > vertex_count and gh > 1:
        gh -= 1
    nx, ny = gw + 1, gh + 1

    u = np.linspace(0, 1, nx, dtype=np.float32)
    v = np.linspace(0, 1, ny, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)  # [ny,nx]
    lo = np.asarray(aabb_min, np.float32)
    hi = np.asarray(aabb_max, np.float32)
    size = hi - lo
    # Fold the patch through the box along its two largest extents; ripple
    # the third axis so the surface is non-planar.
    order = np.argsort(-size)
    a, b, c = order[0], order[1], order[2]
    phase = rng.uniform(0, 2 * np.pi, 3)
    pos = np.zeros((ny, nx, 3), np.float32)
    pos[..., a] = lo[a] + uu * size[a]
    pos[..., b] = lo[b] + vv * size[b]
    ripple = 0.5 + 0.5 * np.sin(2 * np.pi * (2 * uu + 3 * vv) + phase[0])
    pos[..., c] = lo[c] + ripple * size[c]

    # analytic normal of the ripple surface (approximate via gradients)
    dz_du = np.gradient(pos[..., c], axis=1)
    dz_dv = np.gradient(pos[..., c], axis=0)
    du = np.zeros_like(pos)
    du[..., a] = size[a] / max(nx - 1, 1)
    du[..., c] = dz_du
    dv = np.zeros_like(pos)
    dv[..., b] = size[b] / max(ny - 1, 1)
    dv[..., c] = dz_dv
    n = np.cross(du.reshape(-1, 3), dv.reshape(-1, 3))
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)

    t = du.reshape(-1, 3)
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-9)
    tangents = np.concatenate([t, np.full((t.shape[0], 1), 1.0, np.float32)], axis=1)

    positions = pos.reshape(-1, 3)
    uvs = np.stack([uu * 4.0, vv * 4.0], axis=-1).reshape(-1, 2).astype(np.float32)

    # pad vertices up to the exact accessor count (duplicates of vertex 0)
    pad = vertex_count - positions.shape[0]
    if pad > 0:
        positions = np.vstack([positions, np.repeat(positions[:1], pad, 0)])
        n = np.vstack([n, np.repeat(n[:1], pad, 0)])
        tangents = np.vstack([tangents, np.repeat(tangents[:1], pad, 0)])
        uvs = np.vstack([uvs, np.repeat(uvs[:1], pad, 0)])

    # grid triangulation, then pad/trim to the exact index count
    i0 = np.arange(gh)[:, None] * nx + np.arange(gw)[None, :]
    quads = np.stack(
        [i0, i0 + nx, i0 + 1, i0 + 1, i0 + nx, i0 + nx + 1], axis=-1
    ).reshape(-1, 3)
    indices = quads.reshape(-1)[:index_count].astype(np.uint32)
    if indices.size < index_count:
        padding = np.zeros(index_count - indices.size, np.uint32)
        indices = np.concatenate([indices, padding])
    return positions.astype(np.float32), uvs, n.astype(np.float32), tangents.astype(np.float32), indices


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from an [x, y, z, w] quaternion."""
    x, y, z, w = (float(c) for c in q)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ],
        dtype=np.float32,
    )


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    ax, ay, az = float(axis[0]), float(axis[1]), float(axis[2])
    inv = 1.0 / (math.sqrt(ax * ax + ay * ay + az * az) or 1.0)
    half = 0.5 * float(angle)
    s = math.sin(half) * inv
    return np.array([ax * s, ay * s, az * s, math.cos(half)],
                    dtype=np.float32)


def trs(
    translation: np.ndarray | None = None,
    rotation: np.ndarray | None = None,
    scale: np.ndarray | None = None,
) -> np.ndarray:
    """4x4 from translation [3], rotation quat [4], scale [3] (T * R * S)."""
    m = np.eye(4, dtype=np.float32)
    r = quat_to_mat3(rotation) if rotation is not None else np.eye(3, dtype=np.float32)
    if scale is not None:
        r = r * np.asarray(scale, dtype=np.float32)[None, :]
    m[:3, :3] = r
    if translation is not None:
        m[:3, 3] = np.asarray(translation, dtype=np.float32)
    return m


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Returns (position, orientation quat) for a camera looking from eye at
    target, for a coordinate system whose forward/up match the arguments'
    space. The orientation maps camera-local VULKAN axes (+X right, -Y up,
    +Z forward) into world axes.

    Scalar-math hot path: this runs once per frame in the demo loops, and
    the numpy-per-op version cost ~55 µs of pure interpreter overhead on
    3-vectors."""
    ex, ey, ez = float(eye[0]), float(eye[1]), float(eye[2])
    fx, fy, fz = float(target[0]) - ex, float(target[1]) - ey, float(target[2]) - ez
    inv = 1.0 / math.sqrt(fx * fx + fy * fy + fz * fz)
    fx, fy, fz = fx * inv, fy * inv, fz * inv
    ux, uy, uz = float(up[0]), float(up[1]), float(up[2])
    inv = 1.0 / math.sqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux * inv, uy * inv, uz * inv
    rx, ry, rz = fy * uz - fz * uy, fz * ux - fx * uz, fx * uy - fy * ux
    inv = 1.0 / math.sqrt(rx * rx + ry * ry + rz * rz)
    rx, ry, rz = rx * inv, ry * inv, rz * inv
    tx, ty, tz = ry * fz - rz * fy, rz * fx - rx * fz, rx * fy - ry * fx
    # Camera basis in world space, as columns: right, -up (Vulkan +Y is
    # down), forward.
    basis = ((rx, -tx, fx), (ry, -ty, fy), (rz, -tz, fz))
    return (
        np.array([ex, ey, ez], np.float32),
        np.array(_mat3_to_quat_scalar(basis), np.float32),
    )


def _mat3_to_quat_scalar(m) -> tuple:
    """Scalar-math mat3_to_quat (Shepperd's branches on a 3x3 of floats):
    the per-frame camera path must cost µs, not tens."""
    t = m[0][0] + m[1][1] + m[2][2]
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return ((m[2][1] - m[1][2]) / s, (m[0][2] - m[2][0]) / s,
                (m[1][0] - m[0][1]) / s, 0.25 * s)
    if m[0][0] > m[1][1] and m[0][0] > m[2][2]:
        s = math.sqrt(1.0 + m[0][0] - m[1][1] - m[2][2]) * 2
        return (0.25 * s, (m[0][1] + m[1][0]) / s,
                (m[0][2] + m[2][0]) / s, (m[2][1] - m[1][2]) / s)
    if m[1][1] > m[2][2]:
        s = math.sqrt(1.0 + m[1][1] - m[0][0] - m[2][2]) * 2
        return ((m[0][1] + m[1][0]) / s, 0.25 * s,
                (m[1][2] + m[2][1]) / s, (m[0][2] - m[2][0]) / s)
    s = math.sqrt(1.0 + m[2][2] - m[0][0] - m[1][1]) * 2
    return ((m[0][2] + m[2][0]) / s, (m[1][2] + m[2][1]) / s,
            0.25 * s, (m[1][0] - m[0][1]) / s)
