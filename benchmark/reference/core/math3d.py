# Frozen copy of renderer_tpu_torch/core/math3d.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Host-side 3D math (numpy): quaternions, affine transforms, matrix helpers.

These run on the host during scene building and animation evaluation — the
per-frame cost is microseconds (matching the reference's ~20 µs CPU budget,
reference: README.md:85-86). Device-side math lives in raster/ as jnp ops.

Conventions: matrices are numpy float32 [4,4] acting on column vectors
(clip = M @ [x, y, z, 1]^T); quaternions are [x, y, z, w] (glam order, since
glTF stores them that way).
"""

from __future__ import annotations

import numpy as np

IDENTITY = np.eye(4, dtype=np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v if n == 0.0 else v / n


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


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


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float32,
    )


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    import math

    ax, ay, az = float(axis[0]), float(axis[1]), float(axis[2])
    inv = 1.0 / (math.sqrt(ax * ax + ay * ay + az * az) or 1.0)
    half = 0.5 * float(angle)
    s = math.sin(half) * inv
    return np.array([ax * s, ay * s, az * s, math.cos(half)],
                    dtype=np.float32)


def quat_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Shortest-path spherical interpolation (matches glam's Quat::slerp,
    used by the reference's animation sampler, gltf/src/gltf_json.rs:263-286)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    dot = float(np.dot(a, b))
    if dot < 0.0:
        b = -b
        dot = -dot
    if dot > 0.9995:
        out = a + t * (b - a)
        return (out / np.linalg.norm(out)).astype(np.float32)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return ((np.sin((1.0 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b).astype(np.float32)


def lerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    return (np.asarray(a, np.float32) * (1.0 - t) + np.asarray(b, np.float32) * t).astype(np.float32)


def quat_slerp_batch(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Batched quat_slerp ([N,4], [N,4], [N] → [N,4]) — same branches
    (shortest path, nlerp above dot 0.9995) evaluated with np.where."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    t = np.asarray(t, np.float64)[:, None]
    dot = np.sum(a * b, axis=-1, keepdims=True)
    b = np.where(dot < 0.0, -b, b)
    dot = np.abs(dot)
    # nlerp branch
    near = a + t * (b - a)
    near_n = near / np.maximum(np.linalg.norm(near, axis=-1, keepdims=True), 1e-30)
    # slerp branch (guard theta for the near branch's dot ≈ 1)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.where(np.abs(np.sin(theta)) > 1e-30, np.sin(theta), 1.0)
    far = (np.sin((1.0 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b
    return np.where(dot > 0.9995, near_n, far).astype(np.float32)


def quat_to_mat3_batch(q: np.ndarray) -> np.ndarray:
    """Batched quat_to_mat3: [N,4] → [N,3,3]."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty((q.shape[0], 3, 3), np.float32)
    m[:, 0, 0] = 1 - 2 * (yy + zz)
    m[:, 0, 1] = 2 * (xy - wz)
    m[:, 0, 2] = 2 * (xz + wy)
    m[:, 1, 0] = 2 * (xy + wz)
    m[:, 1, 1] = 1 - 2 * (xx + zz)
    m[:, 1, 2] = 2 * (yz - wx)
    m[:, 2, 0] = 2 * (xz - wy)
    m[:, 2, 1] = 2 * (yz + wx)
    m[:, 2, 2] = 1 - 2 * (xx + yy)
    return m


def trs_batch(translation: np.ndarray, rotation: np.ndarray,
              scale: np.ndarray) -> np.ndarray:
    """Batched trs: [N,3], [N,4] quat, [N,3] → [N,4,4] (T * R * S, column
    scaling like the scalar version)."""
    n = translation.shape[0]
    m = np.zeros((n, 4, 4), np.float32)
    m[:, :3, :3] = quat_to_mat3_batch(rotation) * np.asarray(
        scale, np.float32
    )[:, None, :]
    m[:, :3, 3] = translation
    m[:, 3, 3] = 1.0
    return m


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


def rotation_translation(rotation: np.ndarray, translation: np.ndarray) -> np.ndarray:
    return trs(translation=translation, rotation=rotation)


def affine_inverse(m: np.ndarray) -> np.ndarray:
    """Inverse of an affine 4x4 (last row [0,0,0,1])."""
    r_inv = np.linalg.inv(m[:3, :3].astype(np.float64))
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = r_inv
    out[:3, 3] = -r_inv @ m[:3, 3].astype(np.float64)
    return out.astype(np.float32)


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the upper 3x3, used to transform normals.

    Parity: the reference interleaves this with the model matrix in the
    per-instance vertex stream (renderer/src/renderer.rs:219-235,
    pipeline_parameters/vertex_buffers.rs:190-195)."""
    return np.linalg.inv(m[:3, :3].astype(np.float64)).T.astype(np.float32)


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Returns (position, orientation quat) for a camera looking from eye at
    target, for a coordinate system whose forward/up match the arguments'
    space. The orientation maps camera-local VULKAN axes (+X right, -Y up,
    +Z forward) into world axes.

    Scalar-math hot path: this runs once per frame in the demo loops, and
    the numpy-per-op version cost ~55 µs of pure interpreter overhead on
    3-vectors."""
    import math

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


def mat3_to_quat_batch(m: np.ndarray) -> np.ndarray:
    """Batched mat3_to_quat: [N,3,3] → [N,4]. Same Shepperd branches as the
    scalar version, selected per row with np.where (all four branch formulas
    evaluated with guarded sqrt/divide, identical arithmetic on the selected
    branch)."""
    m = np.asarray(m, np.float64)
    t = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]

    def g_sqrt(x):
        return np.sqrt(np.maximum(x, 0.0))

    with np.errstate(invalid="ignore", divide="ignore"):
        s0 = g_sqrt(t + 1.0) * 2
        b0 = (0.25 * s0, (m[:, 2, 1] - m[:, 1, 2]) / s0,
              (m[:, 0, 2] - m[:, 2, 0]) / s0, (m[:, 1, 0] - m[:, 0, 1]) / s0)
        s1 = g_sqrt(1.0 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2]) * 2
        b1 = ((m[:, 2, 1] - m[:, 1, 2]) / s1, 0.25 * s1,
              (m[:, 0, 1] + m[:, 1, 0]) / s1, (m[:, 0, 2] + m[:, 2, 0]) / s1)
        s2 = g_sqrt(1.0 + m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2]) * 2
        b2 = ((m[:, 0, 2] - m[:, 2, 0]) / s2, (m[:, 0, 1] + m[:, 1, 0]) / s2,
              0.25 * s2, (m[:, 1, 2] + m[:, 2, 1]) / s2)
        s3 = g_sqrt(1.0 + m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1]) * 2
        b3 = ((m[:, 1, 0] - m[:, 0, 1]) / s3, (m[:, 0, 2] + m[:, 2, 0]) / s3,
              (m[:, 1, 2] + m[:, 2, 1]) / s3, 0.25 * s3)
    c0 = t > 0
    c1 = (m[:, 0, 0] > m[:, 1, 1]) & (m[:, 0, 0] > m[:, 2, 2])
    c2 = m[:, 1, 1] > m[:, 2, 2]
    # branch layout (w, x?, ...) differs per branch: b0=(w,x,y,z) order is
    # (w, x, y, z); map each to [x, y, z, w] rows
    def xyzw(b, perm):
        return np.stack([b[perm[0]], b[perm[1]], b[perm[2]], b[perm[3]]], axis=-1)

    q0 = xyzw(b0, (1, 2, 3, 0))
    q1 = xyzw(b1, (1, 2, 3, 0))
    q2 = xyzw(b2, (1, 2, 3, 0))
    q3 = xyzw(b3, (1, 2, 3, 0))
    out = np.where(
        c0[:, None], q0,
        np.where(c1[:, None], q1, np.where(c2[:, None], q2, q3)),
    )
    return out.astype(np.float32)


def _mat3_to_quat_scalar(m) -> tuple:
    """Scalar-math mat3_to_quat (Shepperd's branches on a 3x3 of floats):
    the per-frame camera path must cost µs, not tens."""
    import math

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


def mat3_to_quat(m: np.ndarray) -> np.ndarray:
    """Quaternion [x,y,z,w] from a rotation matrix (Shepperd's method)."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], dtype=np.float32)
