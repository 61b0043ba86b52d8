# Frozen copy of renderer_tpu_torch/geometry/vertex_library.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Vertex library: the de-interleaved shared vertex/index store for all meshes.

Parity: the reference packs every mesh into one shared mega vertex buffer +
u16 index buffer per library, with quantized attributes
(reference: renderer/src/vertex_library.rs:41-46,158-312,
renderer/src/renderer/scene/mesh.rs:9-17). Here the library is a set of
structure-of-arrays numpy buffers that become device-resident f32/i32 arrays;
a Mesh is a (vertex_offset, vertex_count, first_index, index_count) window.

The measure-then-allocate discipline survives as a two-phase builder: callers
can `measure` first (returning exact array sizes, mirroring
VulkanArenaMeasurer, renderer/src/memory_measurement.rs:10-48) or just add
meshes and let the builder grow — on TPU the "allocation" is just numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.geometry import quantize


class VertexLayout:
    STATIC_MESH = "static"
    SKINNED_MESH = "skinned"


@dataclass(frozen=True)
class Mesh:
    """A window into a VertexLibrary (reference: scene/mesh.rs:9-17).
    `morph_count` — number of morph targets whose deltas live in the
    library's morph bank (0 = no morphing; the reference leaves morph
    animation as a todo!(), gltf/src/lib.rs:229 — we implement it)."""

    library: "VertexLibrary"
    layout: str
    vertex_offset: int
    vertex_count: int
    first_index: int
    index_count: int
    mesh_id: int
    morph_count: int = 0

    @property
    def skinned(self) -> bool:
        return self.layout == VertexLayout.SKINNED_MESH


class VertexLibrary:
    """Packed SoA geometry store. All attributes hold quantize→dequantize'd
    f32 values (see geometry/quantize.py). Indices are u32 and *local* to each
    mesh's vertex window (add Mesh.vertex_offset to resolve)."""

    _next_library_id = 0

    def __init__(self) -> None:
        self.positions = np.zeros((0, 3), np.float32)
        self.uvs = np.zeros((0, 2), np.float32)
        self.normals = np.zeros((0, 3), np.float32)
        self.tangents = np.zeros((0, 4), np.float32)
        self.joints = np.zeros((0, 4), np.int32)
        self.weights = np.zeros((0, 4), np.float32)
        self.indices = np.zeros((0,), np.uint32)
        # morph-target delta bank: row 0 is an all-zero sentinel; a morphed
        # mesh's target k stores vertex v's deltas at row
        # morph_row0[vertex] + k * morph_step[vertex] (row0/step are 0 for
        # unmorphed vertices, so every tap lands on the zero row)
        self.morph_pos = np.zeros((1, 3), np.float32)
        self.morph_nrm = np.zeros((1, 3), np.float32)
        self.morph_row0 = np.zeros((0,), np.int32)
        self.morph_step = np.zeros((0,), np.int32)
        self.meshes: list[Mesh] = []
        self.library_id = VertexLibrary._next_library_id
        VertexLibrary._next_library_id += 1

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def index_count(self) -> int:
        return self.indices.shape[0]


@dataclass
class VertexLibraryMeasurer:
    """Counts vertices/indices before building
    (reference: vertex_library.rs:235-312)."""

    vertex_count: int = 0
    index_count: int = 0
    mesh_count: int = 0

    def add_mesh(self, vertex_count: int, index_count: int) -> None:
        self.vertex_count += vertex_count
        self.index_count += index_count
        self.mesh_count += 1


class VertexLibraryBuilder:
    """Accumulates meshes, quantizing attributes on the way in
    (reference: vertex_library.rs:96-231)."""

    def __init__(self, measurer: VertexLibraryMeasurer | None = None) -> None:
        self._chunks: list[dict[str, np.ndarray]] = []
        self._morph_chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self._library = VertexLibrary()
        self._vertex_cursor = 0
        self._index_cursor = 0
        self._morph_cursor = 1  # bank row 0 is the zero sentinel

    def add_mesh(
        self,
        positions: np.ndarray,
        uvs: np.ndarray,
        normals: np.ndarray,
        tangents: np.ndarray,
        indices: np.ndarray,
        joints: np.ndarray | None = None,
        weights: np.ndarray | None = None,
        morph_targets: list | None = None,
    ) -> Mesh:
        """morph_targets — optional list of (position_deltas [n,3],
        normal_deltas [n,3] | None) per target, f16-quantized like base
        positions (vertex_buffers.rs:96-179 discipline applied to the
        deltas; the reference has no morph support to mirror). At most
        constants.MAX_MORPH_TARGETS targets; more is a loud error."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        n = positions.shape[0]
        uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        tangents = np.asarray(tangents, np.float32).reshape(-1, 4)
        indices = np.asarray(indices, np.uint32).reshape(-1)
        assert uvs.shape[0] == n and normals.shape[0] == n and tangents.shape[0] == n
        assert indices.size % 3 == 0, "index count must be a multiple of 3"
        assert indices.size == 0 or indices.max() < n, "index out of range"

        skinned = joints is not None
        if skinned:
            joints_arr = np.asarray(joints, np.int32).reshape(-1, 4)
            weights_arr = quantize.quantize_unorm8(np.asarray(weights, np.float32).reshape(-1, 4))
            assert joints_arr.shape[0] == n and weights_arr.shape[0] == n
        else:
            joints_arr = np.zeros((n, 4), np.int32)
            weights_arr = np.zeros((n, 4), np.float32)

        morph_count = 0
        morph_row0 = np.zeros(n, np.int32)
        morph_step = np.zeros(n, np.int32)
        if morph_targets:
            from benchmark.reference.core import constants

            morph_count = len(morph_targets)
            if morph_count > constants.MAX_MORPH_TARGETS:
                raise ValueError(
                    f"mesh has {morph_count} morph targets; the per-draw "
                    f"weight capacity is {constants.MAX_MORPH_TARGETS} "
                    "(constants.MAX_MORPH_TARGETS)"
                )
            dpos = np.zeros((morph_count * n, 3), np.float32)
            dnrm = np.zeros((morph_count * n, 3), np.float32)
            for k, target in enumerate(morph_targets):
                pd, nd = target
                pd = np.asarray(pd, np.float32).reshape(-1, 3)
                assert pd.shape[0] == n, "morph position-delta count mismatch"
                dpos[k * n : (k + 1) * n] = quantize.quantize_position(pd)
                if nd is not None:
                    nd = np.asarray(nd, np.float32).reshape(-1, 3)
                    assert nd.shape[0] == n, "morph normal-delta count mismatch"
                    # f16 like positions (snorm10 can't hold the ±2 range of
                    # a normal delta)
                    dnrm[k * n : (k + 1) * n] = quantize.quantize_position(nd)
            self._morph_chunks.append((dpos, dnrm))
            morph_row0[:] = self._morph_cursor + np.arange(n, dtype=np.int32)
            morph_step[:] = n
            self._morph_cursor += morph_count * n

        self._chunks.append(
            {
                "positions": quantize.quantize_position(positions),
                "uvs": quantize.quantize_texcoord(uvs),
                "normals": quantize.quantize_normal(normals),
                "tangents": quantize.quantize_tangent(tangents),
                "joints": joints_arr,
                "weights": weights_arr,
                "indices": indices,
                "morph_row0": morph_row0,
                "morph_step": morph_step,
            }
        )
        mesh = Mesh(
            library=self._library,
            layout=VertexLayout.SKINNED_MESH if skinned else VertexLayout.STATIC_MESH,
            vertex_offset=self._vertex_cursor,
            vertex_count=n,
            first_index=self._index_cursor,
            index_count=int(indices.size),
            mesh_id=len(self._library.meshes),
            morph_count=morph_count,
        )
        self._library.meshes.append(mesh)
        self._vertex_cursor += n
        self._index_cursor += int(indices.size)
        return mesh

    def build(self) -> VertexLibrary:
        lib = self._library
        if self._chunks:
            for key in ("positions", "uvs", "normals", "tangents", "joints",
                        "weights", "indices", "morph_row0", "morph_step"):
                setattr(lib, key, np.concatenate([c[key] for c in self._chunks], axis=0))
        if self._morph_chunks:
            zero = np.zeros((1, 3), np.float32)
            lib.morph_pos = np.concatenate(
                [zero] + [c[0] for c in self._morph_chunks], axis=0
            )
            lib.morph_nrm = np.concatenate(
                [zero] + [c[1] for c in self._morph_chunks], axis=0
            )
            self._morph_chunks = []
        self._chunks = []
        return lib
