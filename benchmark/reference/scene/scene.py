# Frozen copy of renderer_tpu_torch/scene/scene.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Scene: the per-frame draw queue.

Parity: renderer/src/renderer/scene.rs:51-107. `queue_mesh` caps the queue at
MAX_DRAW_CALLS and returns False when full; skinned meshes must come with a
joints offset and vice versa (scene.rs:78-92). `allocate_joint_offset`
bump-allocates mat4 ranges out of the shared joint palette (≤1024 joints,
scene.rs:96-107).

TPU-first draw stream: draws are stored as structure-of-arrays (transforms,
packed sort keys, material/joints columns) so the per-frame prologue — sort,
instance-merge detection, frame-array packing — is pure vectorized numpy with
no per-draw Python in the hot path (the reference merges 16,384 draws into
indirect commands in ~20 µs, renderer.rs:219-256; a Python object loop cannot
approach that, an SoA can). The whole sort key packs into one uint64 (column
order scene.rs:35-41 + draw_call_tag.rs:23-31), so draw sorting is a single
stable argsort. `queue_instanced` queues N transforms of one mesh in one
vectorized call — the capacity-scale path (the analog of the reference's
instance merging making 16k draws cheap).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.core import camera as camera_mod
from benchmark.reference.core import constants
from benchmark.reference.geometry.vertex_library import Mesh
from benchmark.reference.materials.registry import AlphaMode, Material


def pipeline_index(material: Material, skinned: bool) -> int:
    """Material::pipeline parity (descriptors/material.rs:150-163); the enum
    order (pipeline_parameters.rs:33-50) makes blended pipelines sort last."""
    base = {
        AlphaMode.OPAQUE: 0,
        AlphaMode.ALPHA_TO_COVERAGE: 2,
        AlphaMode.BLENDED: 4,
    }[material.alpha_mode]
    return base + (1 if skinned else 0)


# uint64 sort-key bit layout, priority high→low matching DrawParameters /
# DrawCallTag ordering (scene.rs:35-41, draw_call_tag.rs:23-31):
# (joints_flag, joints_offset, pipeline, library, mesh, material). Rust's
# Option Ord puts None (static draws) first → flag is the top bit.
_MATERIAL_BITS = 10  # MAX_MATERIALS = 1000
_MESH_BITS = 16
_LIBRARY_BITS = 10
_PIPELINE_BITS = 3
_JOINTS_BITS = 11  # MAX_JOINT_COUNT = 1024

_MATERIAL_SHIFT = 0
_MESH_SHIFT = _MATERIAL_SHIFT + _MATERIAL_BITS
_LIBRARY_SHIFT = _MESH_SHIFT + _MESH_BITS
_PIPELINE_SHIFT = _LIBRARY_SHIFT + _LIBRARY_BITS
_JOINTS_SHIFT = _PIPELINE_SHIFT + _PIPELINE_BITS
_FLAG_SHIFT = _JOINTS_SHIFT + _JOINTS_BITS

# geometry identity = (pipeline [encodes skinned + alpha class], library,
# mesh); material slot and joint offsets don't change the geometry stream
GEOMETRY_KEY_MASK = np.uint64(
    ((1 << (_PIPELINE_BITS + _LIBRARY_BITS + _MESH_BITS)) - 1) << _MESH_SHIFT
)


@dataclass
class DrawBlock:
    """Precomputed SoA columns for a FIXED list of (mesh, material, joints)
    draws — build once with `make_draw_block`, queue every frame with fresh
    transforms via `Scene.queue_block` (one vectorized append instead of M
    Python `queue_mesh` calls; the reference's per-frame queue costs ~20 µs
    for the whole scene, renderer.rs:219-256 — per-draw Python cannot)."""

    sources: list[tuple[Mesh, Material]]
    keys: np.ndarray  # [M] u64 packed sort keys
    material_id: np.ndarray  # [M] i32
    joints_offset: np.ndarray  # [M] i32
    skinned: np.ndarray  # [M] i32


def make_draw_block(
    items: list[tuple[Mesh, Material, int | None]]
) -> DrawBlock:
    m = len(items)
    keys = np.zeros(m, np.uint64)
    material_id = np.zeros(m, np.int32)
    joints_offset = np.zeros(m, np.int32)
    skinned = np.zeros(m, np.int32)
    sources = []
    for i, (mesh, material, joints) in enumerate(items):
        assert mesh.skinned == (joints is not None), (
            "skinned meshes must have joints defined"
        )
        keys[i] = _pack_key(
            pipeline_index(material, mesh.skinned),
            mesh.library.library_id, mesh.mesh_id, material.id, joints,
        )
        material_id[i] = material.id
        joints_offset[i] = 0 if joints is None else joints
        skinned[i] = 0 if joints is None else 1
        sources.append((mesh, material))
    return DrawBlock(sources, keys, material_id, joints_offset, skinned)


def _pack_key(pipeline: int, library: int, mesh: int, material: int,
              joints_offset) -> int:
    assert library < (1 << _LIBRARY_BITS), "too many vertex libraries"
    assert mesh < (1 << _MESH_BITS), "too many meshes in one library"
    flag, joints = (0, 0) if joints_offset is None else (1, int(joints_offset))
    return (
        (flag << _FLAG_SHIFT)
        | (joints << _JOINTS_SHIFT)
        | (pipeline << _PIPELINE_SHIFT)
        | (library << _LIBRARY_SHIFT)
        | (mesh << _MESH_SHIFT)
        | material
    )


@dataclass
class DrawParameters:
    """One queued draw, materialized from the SoA for introspection and
    geometry building (the hot path never touches these objects)."""

    mesh: Mesh
    material: Material
    transform: np.ndarray  # 4x4 model matrix
    joints_offset: int | None
    morph_weights: np.ndarray | None = None  # [≤MAX_MORPH_TARGETS]

    def sort_key(self):
        """DrawParameters/DrawCallTag ordering (scene.rs:35-41,
        scene/draw_call_tag.rs:23-31): (joints, pipeline, library, mesh,
        material). Rust's Option Ord puts None (static draws) first."""
        joints = (0, 0) if self.joints_offset is None else (1, self.joints_offset)
        return (
            joints,
            pipeline_index(self.material, self.mesh.skinned),
            self.mesh.library.library_id,
            self.mesh.mesh_id,
            self.material.id,
        )

    def merge_key(self):
        """Draws with equal (tag, joints) merge into one instanced command
        (renderer.rs:236-254); the command index is the shader's draw id."""
        return (
            pipeline_index(self.material, self.mesh.skinned),
            self.mesh.library.library_id,
            self.mesh.mesh_id,
            self.material.id,
            self.joints_offset,
        )


class Scene:
    def __init__(self, world_space: camera_mod.CoordinateSystem = camera_mod.VULKAN):
        self.world_space = world_space
        self.camera = camera_mod.Camera()
        self.joint_palette = np.zeros((constants.MAX_JOINT_COUNT, 4, 4), np.float32)
        self._joint_cursor = 0
        # draw SoA (grown on demand; amortized O(1) appends)
        cap = 64
        self._n = 0
        self._transforms = np.zeros((cap, 4, 4), np.float32)
        self._keys = np.zeros(cap, np.uint64)
        self._material_id = np.zeros(cap, np.int32)
        self._joints_offset = np.zeros(cap, np.int32)
        self._skinned = np.zeros(cap, np.int32)
        self._morph_weights = np.zeros(
            (cap, constants.MAX_MORPH_TARGETS), np.float32
        )
        self._source = np.zeros(cap, np.int32)  # index into _sources
        self._sources: list[tuple[Mesh, Material]] = []
        self._draws_cache: list[DrawParameters] | None = None
        self._any_morph = False  # any queued draw carried nonzero weights
        # draw_stream.frame_view's sort/merge cache: content-keyed on the
        # packed key stream, so it deliberately SURVIVES clear() + re-queue
        # (the interactive loop re-queues an identical stream every frame)
        self._fv_cache = None

    # -- queueing -------------------------------------------------------------

    def clear(self) -> None:
        self._n = 0
        self._sources.clear()
        self._joint_cursor = 0
        self._draws_cache = None
        self._any_morph = False

    def _ensure(self, extra: int) -> None:
        need = self._n + extra
        cap = self._transforms.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        cap = min(cap, constants.MAX_DRAW_CALLS)

        def grow(a):
            out = np.zeros((cap, *a.shape[1:]), a.dtype)
            out[: self._n] = a[: self._n]
            return out

        self._transforms = grow(self._transforms)
        self._keys = grow(self._keys)
        self._material_id = grow(self._material_id)
        self._joints_offset = grow(self._joints_offset)
        self._skinned = grow(self._skinned)
        self._morph_weights = grow(self._morph_weights)
        self._source = grow(self._source)

    def _store_morph(self, i: int, n: int, morph_weights) -> None:
        """Write per-draw morph weights [n, ≤MAX_MORPH_TARGETS] (or clear
        the rows — the SoA is reused across frames)."""
        self._morph_weights[i : i + n] = 0.0
        if morph_weights is None:
            return
        w = np.asarray(morph_weights, np.float32)
        w = w.reshape(1, -1) if w.ndim == 1 else w
        assert w.shape[1] <= constants.MAX_MORPH_TARGETS, (
            f"{w.shape[1]} morph weights > MAX_MORPH_TARGETS "
            f"({constants.MAX_MORPH_TARGETS})"
        )
        self._morph_weights[i : i + n, : w.shape[1]] = w
        self._any_morph = True

    def queue_mesh(
        self,
        mesh: Mesh,
        material: Material,
        joints_offset: int | None,
        transform: np.ndarray,
        morph_weights: np.ndarray | None = None,
    ) -> bool:
        if self._n >= constants.MAX_DRAW_CALLS:
            return False
        assert mesh.skinned == (joints_offset is not None), (
            "skinned meshes must have joints defined"
        )
        self._ensure(1)
        i = self._n
        self._store_morph(i, 1, morph_weights)
        self._transforms[i] = np.asarray(transform, np.float32)
        self._keys[i] = _pack_key(
            pipeline_index(material, mesh.skinned),
            mesh.library.library_id, mesh.mesh_id, material.id, joints_offset,
        )
        self._material_id[i] = material.id
        self._joints_offset[i] = 0 if joints_offset is None else joints_offset
        self._skinned[i] = 0 if joints_offset is None else 1
        self._source[i] = len(self._sources)
        self._sources.append((mesh, material))
        self._n = i + 1
        self._draws_cache = None
        return True

    def queue_instanced(
        self,
        mesh: Mesh,
        material: Material,
        transforms: np.ndarray,  # [N, 4, 4]
        joints_offset: int | None = None,
    ) -> bool:
        """Queue N instances of one mesh in a single vectorized call — the
        capacity-scale path (equal sort keys merge into one instanced command
        exactly like N queue_mesh calls, renderer.rs:236-254). Partial-fills
        at MAX_DRAW_CALLS and returns False when any instance was refused —
        the same per-draw refusal contract as queue_mesh/queue_block
        (scene.rs:78-92)."""
        transforms = np.asarray(transforms, np.float32)
        n = transforms.shape[0]
        assert transforms.shape[1:] == (4, 4)
        assert mesh.skinned == (joints_offset is not None)
        fit = min(n, constants.MAX_DRAW_CALLS - self._n)
        if fit <= 0:
            return n == 0
        self._ensure(fit)
        i = self._n
        self._store_morph(i, fit, None)
        self._transforms[i : i + fit] = transforms[:fit]
        self._keys[i : i + fit] = _pack_key(
            pipeline_index(material, mesh.skinned),
            mesh.library.library_id, mesh.mesh_id, material.id, joints_offset,
        )
        self._material_id[i : i + fit] = material.id
        self._joints_offset[i : i + fit] = 0 if joints_offset is None else joints_offset
        self._skinned[i : i + fit] = 0 if joints_offset is None else 1
        self._source[i : i + fit] = len(self._sources)
        self._sources.append((mesh, material))
        self._n = i + fit
        self._draws_cache = None
        return fit == n

    def queue_block(self, block: DrawBlock, transforms: np.ndarray,
                    morph_weights: np.ndarray | None = None) -> bool:
        """Queue a precomputed DrawBlock with per-draw transforms [M, 4, 4]
        in one vectorized append. Equivalent to M queue_mesh calls in block
        order (partial fill at the draw cap, like the reference's per-draw
        refusal, scene.rs:78-92). `morph_weights` — optional per-draw
        [M, ≤MAX_MORPH_TARGETS] morph weights."""
        transforms = np.asarray(transforms, np.float32)
        m = block.keys.shape[0]
        assert transforms.shape == (m, 4, 4)
        fit = min(m, constants.MAX_DRAW_CALLS - self._n)
        if fit <= 0:
            return m == 0
        self._ensure(fit)
        i = self._n
        self._store_morph(
            i, fit, None if morph_weights is None else morph_weights[:fit]
        )
        self._transforms[i : i + fit] = transforms[:fit]
        self._keys[i : i + fit] = block.keys[:fit]
        self._material_id[i : i + fit] = block.material_id[:fit]
        self._joints_offset[i : i + fit] = block.joints_offset[:fit]
        self._skinned[i : i + fit] = block.skinned[:fit]
        base = len(self._sources)
        self._source[i : i + fit] = np.arange(base, base + fit, dtype=np.int32)
        self._sources.extend(block.sources[:fit])
        self._n = i + fit
        self._draws_cache = None
        return fit == m

    def allocate_joint_offset(self, count: int) -> tuple[int, np.ndarray] | None:
        """Returns (offset, [count,4,4] view to write joint matrices into),
        or None if the palette is full (scene.rs:96-107)."""
        offset = self._joint_cursor
        if offset + count > constants.MAX_JOINT_COUNT:
            return None
        self._joint_cursor = offset + count
        return offset, self.joint_palette[offset : offset + count]

    # -- frame-prologue views (vectorized; see scene/draw_stream.py) ----------

    @property
    def draw_count(self) -> int:
        return self._n

    def frame_order(self) -> tuple[np.ndarray, np.ndarray, bytes]:
        """One stable argsort of the packed keys. Returns (order [N] i64,
        sorted_keys [N] u64, geometry_key bytes — the device-geometry cache
        key: equal iff the sorted draw list references the same meshes with
        the same pipelines)."""
        keys = self._keys[: self._n]
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        # geometry identity: library ids are a never-reused monotonic counter
        # (vertex_library.py), so the (pipeline, library, mesh) key bits fully
        # determine the geometry stream.
        geom_key = (sorted_keys & GEOMETRY_KEY_MASK).tobytes()
        return order, sorted_keys, geom_key

    def materialize(self, order: np.ndarray | None = None) -> list[DrawParameters]:
        """DrawParameters objects for introspection / geometry building (NOT
        the per-frame hot path)."""
        idx = range(self._n) if order is None else order
        out = []
        for i in idx:
            mesh, material = self._sources[self._source[i]]
            joints = int(self._joints_offset[i]) if self._skinned[i] else None
            morph = (
                self._morph_weights[i, : mesh.morph_count].copy()
                if mesh.morph_count else None
            )
            out.append(
                DrawParameters(mesh, material, self._transforms[i].copy(),
                               joints, morph)
            )
        return out

    # -- introspection compatibility ------------------------------------------

    @property
    def draws(self) -> list[DrawParameters]:
        """Materialized draw list (read-only introspection; mutate the scene
        through queue_mesh/queue_instanced/clear)."""
        if self._draws_cache is None:
            self._draws_cache = self.materialize()
        return self._draws_cache

    @draws.setter
    def draws(self, value: list[DrawParameters]) -> None:
        self._n = 0
        self._sources.clear()
        self._draws_cache = None
        for d in value:
            ok = self.queue_mesh(d.mesh, d.material, d.joints_offset,
                                 d.transform, d.morph_weights)
            assert ok, "draw list exceeds MAX_DRAW_CALLS"
