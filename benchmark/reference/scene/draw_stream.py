# Frozen copy of renderer_tpu_torch/scene/draw_stream.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Draw-stream building: sorted draws → fixed-shape device arrays.

This is the host half of the reference's per-frame render_frame prologue:
sort draws, merge consecutive identical (tag, joints) into instanced indirect
commands, build the interleaved transform stream
(reference: renderer/src/renderer.rs:215-256). Here the "indirect command
stream" becomes two things:

- GeometryStream (cached per draw-list *shape*): expanded vertex / triangle
  index arrays. Expansion assigns every (draw, vertex) pair a slot so that
  instanced draws of the same mesh get distinct transformed vertices —
  the analog of per-instance vertex attributes.
- frame arrays (rebuilt every frame, ~µs of numpy): per-draw transforms,
  normal matrices, material ids, joints offsets, debug ids, joint palette.

Static shapes: capacities are power-of-two buckets, so device buffers keep
their shapes until a scene outgrows its bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.core import constants
from benchmark.reference.materials.registry import AlphaMode
from benchmark.reference.scene.scene import DrawParameters, Scene


def _next_pow2(x: int) -> int:
    return 1 << max(4, (int(x) - 1).bit_length())


def _bucket_quarter_pow2(x: int, quantum: int = 256) -> int:
    """Smallest quarter-pow2 bucket ≥ x (…, 1.0, 1.25, 1.5, 1.75, 2.0 ×2^k),
    rounded up to `quantum`. Pow-2 buckets waste up to 2× of the dense
    per-triangle setup math (a 263k-tri scene padding to 524k doubles the
    frame's biggest stage); quarter steps cap the waste at 25% while keeping
    recompiles rare."""
    x = max(int(x), quantum)
    p = 1 << (x - 1).bit_length()  # next pow2
    for num in (5, 6, 7, 8):  # p/2 · {1.25, 1.5, 1.75, 2.0}
        cand = (p // 2) * num // 4
        cand = (cand + quantum - 1) // quantum * quantum
        if cand >= x:
            return cand
    return p


def sorted_draws(scene: Scene) -> list[DrawParameters]:
    """Materialized sorted draw list — introspection / geometry building only
    (the per-frame path uses scene.frame_order() + build_frame_arrays)."""
    order, _keys, _gk = scene.frame_order()
    return scene.materialize(order)


def geometry_key(draws: list[DrawParameters]) -> tuple:
    """Geometry arrays depend only on this; frames that queue the same meshes
    in the same order (the common case) reuse the cached device arrays."""
    return tuple(
        (d.mesh.library.library_id, d.mesh.mesh_id, d.mesh.skinned,
         d.material.alpha_mode)
        for d in draws
    )


@dataclass
class GeometryStream:
    """Host-side packed geometry for one draw list (numpy; device_put by the
    engine). Vertex attribute arrays are the concatenation of every library
    used, in first-use order."""

    # concatenated library attributes [V, *]
    positions: np.ndarray
    uvs: np.ndarray
    normals: np.ndarray
    tangents: np.ndarray
    joints: np.ndarray
    weights: np.ndarray
    # morph-target delta banks (row 0 = zero sentinel) + per-vertex bank
    # addressing; morph_k = max target count over the draw list (0 = the
    # morph tap is compiled out of the vertex stage entirely)
    morph_pos: np.ndarray  # [B, 3]
    morph_nrm: np.ndarray  # [B, 3]
    morph_row0: np.ndarray  # [V] i32
    morph_step: np.ndarray  # [V] i32
    morph_k: int
    # expanded (draw, vertex) stream [VE]
    exp_src: np.ndarray  # i32 → index into concatenated attributes
    exp_draw: np.ndarray  # i32 → draw slot
    # triangle stream [Tc, 3] of expanded vertex ids, segmented by alpha
    # class: [opaque | masked (alpha-to-coverage) | blended], each segment in
    # draw order (the reference's pipeline iteration order,
    # renderer.rs:433-441)
    tri_v: np.ndarray
    num_tris: int
    num_opaque_tris: int
    num_masked_tris: int
    skin_start: int  # expanded-vertex index where skinned draws begin
    num_expanded: int


def build_geometry(draws: list[DrawParameters], max_triangles: int) -> GeometryStream:
    lib_base: dict[int, int] = {}
    libs = []
    cursor = 0
    for d in draws:
        lib = d.mesh.library
        if lib.library_id not in lib_base:
            lib_base[lib.library_id] = cursor
            libs.append(lib)
            cursor += lib.vertex_count

    if libs:
        positions = np.concatenate([l.positions for l in libs], axis=0)
        uvs = np.concatenate([l.uvs for l in libs], axis=0)
        normals = np.concatenate([l.normals for l in libs], axis=0)
        tangents = np.concatenate([l.tangents for l in libs], axis=0)
        joints = np.concatenate([l.joints for l in libs], axis=0)
        weights = np.concatenate([l.weights for l in libs], axis=0)
        # morph banks concatenate like vertices; each library's nonzero
        # row0 entries shift by its bank base (row 0 of the FIRST bank is
        # the shared zero sentinel — every bank's own row 0 is also zero,
        # so cross-library sentinel hits stay harmless)
        morph_pos = np.concatenate([l.morph_pos for l in libs], axis=0)
        morph_nrm = np.concatenate([l.morph_nrm for l in libs], axis=0)
        row0_parts, base_b = [], 0
        for l in libs:
            r = l.morph_row0
            row0_parts.append(np.where(r > 0, r + base_b, 0).astype(np.int32))
            base_b += l.morph_pos.shape[0]
        morph_row0 = np.concatenate(row0_parts)
        morph_step = np.concatenate([l.morph_step for l in libs])
    else:
        positions = np.zeros((1, 3), np.float32)
        uvs = np.zeros((1, 2), np.float32)
        normals = np.zeros((1, 3), np.float32)
        tangents = np.zeros((1, 4), np.float32)
        joints = np.zeros((1, 4), np.int32)
        weights = np.zeros((1, 4), np.float32)
        morph_pos = np.zeros((1, 3), np.float32)
        morph_nrm = np.zeros((1, 3), np.float32)
        morph_row0 = np.zeros(1, np.int32)
        morph_step = np.zeros(1, np.int32)
    morph_k = max((d.mesh.morph_count for d in draws), default=0)

    exp_src_parts: list[np.ndarray] = []
    exp_draw_parts: list[np.ndarray] = []
    class_tris: dict[int, list[np.ndarray]] = {
        AlphaMode.OPAQUE: [], AlphaMode.ALPHA_TO_COVERAGE: [], AlphaMode.BLENDED: []
    }
    skin_start = None
    cursor = 0
    for slot, d in enumerate(draws):
        mesh = d.mesh
        base = lib_base[mesh.library.library_id] + mesh.vertex_offset
        n = mesh.vertex_count
        if mesh.skinned and skin_start is None:
            skin_start = cursor
        exp_src_parts.append(np.arange(base, base + n, dtype=np.int32))
        exp_draw_parts.append(np.full(n, slot, np.int32))
        local = mesh.library.indices[
            mesh.first_index : mesh.first_index + mesh.index_count
        ].astype(np.int32)
        class_tris[d.material.alpha_mode].append((local + cursor).reshape(-1, 3))
        cursor += n

    num_expanded = cursor
    if skin_start is None:
        skin_start = num_expanded

    ve_cap = _bucket_quarter_pow2(num_expanded, quantum=64)
    exp_src = np.zeros(ve_cap, np.int32)
    exp_draw = np.zeros(ve_cap, np.int32)
    if exp_src_parts:
        exp_src[:num_expanded] = np.concatenate(exp_src_parts)
        exp_draw[:num_expanded] = np.concatenate(exp_draw_parts)

    def cat(lst):
        return np.concatenate(lst, axis=0) if lst else np.zeros((0, 3), np.int32)

    opaque = cat(class_tris[AlphaMode.OPAQUE])
    masked = cat(class_tris[AlphaMode.ALPHA_TO_COVERAGE])
    blended = cat(class_tris[AlphaMode.BLENDED])
    num_opaque = opaque.shape[0]
    num_masked = masked.shape[0]
    num_tris = num_opaque + num_masked + blended.shape[0]
    assert num_tris <= max_triangles, (
        f"scene has {num_tris} triangles, config.max_triangles={max_triangles}"
    )
    # Capacity must cover whole raster DMA chunks (raster_kernel.CHUNK);
    # quarter-pow2 buckets keep the dense setup math within 25% of the scene.
    t_cap = min(_bucket_quarter_pow2(num_tris), _next_pow2(max_triangles))
    tri_v = np.zeros((t_cap, 3), np.int32)
    tri_v[:num_tris] = np.concatenate([opaque, masked, blended], axis=0)

    return GeometryStream(
        positions=positions,
        uvs=uvs,
        normals=normals,
        tangents=tangents,
        joints=joints,
        weights=weights,
        morph_pos=morph_pos,
        morph_nrm=morph_nrm,
        morph_row0=morph_row0,
        morph_step=morph_step,
        morph_k=morph_k,
        exp_src=exp_src,
        exp_draw=exp_draw,
        tri_v=tri_v,
        num_tris=num_tris,
        num_opaque_tris=num_opaque,
        num_masked_tris=num_masked,
        skin_start=int(skin_start),
        num_expanded=num_expanded,
    )


@dataclass
class FrameView:
    """One frame's sorted draw stream in upload layout. Produced by
    `frame_view` in one vectorized numpy pass — the analog of the reference's sort + merge +
    temp-uniform write prologue (renderer.rs:215-302, ~20 µs at capacity)."""

    order: np.ndarray  # [N] i32/i64 — sorted draw indices
    sorted_keys: np.ndarray  # [N] u64 — packed keys, sorted
    geom_key: bytes  # device-geometry cache key
    pdf: np.ndarray  # [cap, 12] f32 — sorted 3x4 transforms
    pdi: np.ndarray  # [cap, 4] i32 — material, joints, skinned, debug_id
    # sorted per-draw morph weights [cap, MAX_MORPH_TARGETS] f32, or None
    # when no queued draw carried weights (the common case pays nothing)
    pmw: np.ndarray | None = None




def frame_view(scene: Scene) -> FrameView:
    """Sort + pack the scene's draw SoA for upload: the port's numpy plain
    version (no host library, no cache of the last frame's sort)."""
    from benchmark.reference.scene.scene import GEOMETRY_KEY_MASK

    n = scene.draw_count
    cap = _next_pow2(max(n, 1))
    order, sorted_keys, _gk = scene.frame_order()
    pdf = np.zeros((cap, 12), np.float32)
    pdi = np.zeros((cap, 4), np.int32)
    if n:
        pdf[:n] = scene._transforms[:n][order][:, :3, :].reshape(n, 12)
        pdi[:n, 0] = scene._material_id[:n][order]
        pdi[:n, 1] = scene._joints_offset[:n][order]
        pdi[:n, 2] = scene._skinned[:n][order]
        # instance-merge groups: boundary where the packed key changes;
        # the debug id of every draw is its group's first index
        first = np.empty(n, np.int64)
        first[0] = 0
        idx = np.arange(1, n, dtype=np.int64)
        first[1:] = np.where(sorted_keys[1:] != sorted_keys[:-1], idx, 0)
        pdi[:n, 3] = np.maximum.accumulate(first)
    geom_key = (sorted_keys & GEOMETRY_KEY_MASK).tobytes()
    pmw = None
    if scene._any_morph:
        pmw = np.zeros((cap, constants.MAX_MORPH_TARGETS), np.float32)
        if n:
            pmw[:n] = scene._morph_weights[:n][order]
    return FrameView(order, sorted_keys, geom_key, pdf, pdi, pmw)


def build_frame_arrays(scene: Scene) -> dict[str, np.ndarray]:
    """Per-frame arrays as a dict of views over the packed FrameView
    (introspection/tests; the renderer consumes FrameView directly). Normal
    matrices are not here — they are derived from the transforms on device
    (see unpack_frame)."""
    fv = frame_view(scene)
    cap = fv.pdf.shape[0]
    return {
        "transforms": fv.pdf.reshape(cap, 3, 4),
        "material_id": fv.pdi[:, 0],
        "joints_offset": fv.pdi[:, 1],
        "skinned": fv.pdi[:, 2],
        "debug_id": fv.pdi[:, 3],
        "joint_palette": scene.joint_palette[:, :3, :],  # [J, 3, 4]
    }


def pack_frame_arrays(fv: FrameView, joint_palette: np.ndarray,
                      proj_view: np.ndarray,
                      counts: tuple[int, int, int, int]) -> dict:
    """The per-frame state as separate arrays (introspection/tests; the
    renderer uploads it as the one blob of pack_frame_blob, the analog of
    the reference writing all temp uniforms into ONE per-frame arena
    buffer, renderer.rs:258-302):
      pdf    f32 [Dc, 12]  : sorted 3x4 transforms
      pdi    i32 [Dc, 4]   : material_id, joints_offset, skinned, debug_id
      palette f32 [J, 3, 4]
      proj_view f32 [4, 4]
      counts i32 [4]       : num_tris, n_opaque, n_masked, debug_mode
    """
    return {
        "pdf": fv.pdf,
        "pdi": fv.pdi,
        "joint_palette": joint_palette[:, :3, :],
        "proj_view": np.asarray(proj_view, np.float32),
        "counts": np.asarray(counts, np.int32),
    }


def pack_frame_blob(fv: FrameView, joint_palette: np.ndarray,
                    proj_view: np.ndarray,
                    counts: tuple[int, int, int, int],
                    morph_k: int = 0,
                    joint_cap: int | None = None) -> np.ndarray:
    """ONE i32 upload for the whole per-frame state (pdf | pdi | [pmw] |
    palette | proj_view | counts) — the literal analog of the reference
    writing all temp uniforms into one per-frame arena buffer
    (renderer.rs:258-302). Each host→device upload carries a fixed dispatch
    cost that dominates at these sizes (~50 KB total), so five uploads →
    one. f32 sections are bit-preserved via .view(int32) (i32 payloads are
    never canonicalized in transfer, unlike f32 NaN bit patterns).

    `morph_k` — the geometry stream's morph_k: when nonzero, a sorted
    per-draw morph-weight section [cap, morph_k] rides between pdi and the
    palette (scenes without morphing never pay for it; unpack_frame must be
    given the same static morph_k).

    `joint_cap` — pow-2 joint bucket (Renderer._joint_cap): only the first
    joint_cap palette rows ride the blob. The full MAX_JOINT_COUNT palette
    is 48 KB — ~10× the rest of the blob for demo-scale scenes whose skins
    use a few dozen joints — so the bucket is the dominant per-frame
    transfer saving. Sized host-side from the scene's exact joint cursor
    (measure-then-allocate like the draw cap), so it can never truncate a
    live joint; unpack_frame must be given the same static joint_cap.
    None = the palette's full row count (back-compat layout)."""
    cap = fv.pdf.shape[0]
    if joint_cap is not None:
        assert joint_cap <= joint_palette.shape[0]
        joint_palette = joint_palette[:joint_cap]
    jp = np.ascontiguousarray(joint_palette[:, :3, :], np.float32)
    j12 = jp.size
    mw = cap * morph_k
    blob = np.empty(cap * 16 + mw + j12 + 16 + 4, np.int32)
    blob[: cap * 12] = fv.pdf.reshape(-1).view(np.int32)
    blob[cap * 12 : cap * 16] = fv.pdi.reshape(-1)
    if morph_k:
        pmw = (
            fv.pmw[:, :morph_k] if fv.pmw is not None
            else np.zeros((cap, morph_k), np.float32)
        )
        blob[cap * 16 : cap * 16 + mw] = (
            np.ascontiguousarray(pmw).reshape(-1).view(np.int32)
        )
    base = cap * 16 + mw
    blob[base : base + j12] = jp.reshape(-1).view(np.int32)
    blob[base + j12 : base + j12 + 16] = (
        np.asarray(proj_view, np.float32).reshape(-1).view(np.int32)
    )
    blob[-4:] = np.asarray(counts, np.int32)
    return blob


def unpack_frame(packed: dict, morph_k: int = 0,
                 joint_cap: int = constants.MAX_JOINT_COUNT) -> dict:
    """Inverse of pack_frame_blob on a device tensor ({"blob": i32 tensor};
    slices and the i32→f32 reinterpret are views), plus the per-draw normal
    matrices — the closed-form cofactor inverse-transpose runs on the
    device. `morph_k` and `joint_cap` must match the pack_frame_blob call
    (they set the blob layout)."""
    import torch

    blob = packed["blob"]
    j12 = joint_cap * 12
    cap = (blob.shape[0] - j12 - 16 - 4) // (16 + morph_k)
    f = blob.view(torch.float32)
    mw = cap * morph_k
    base = cap * 16 + mw
    pdi = blob[cap * 12 : cap * 16].reshape(cap, 4)
    counts = blob[-4:]
    transforms = f[: cap * 12].reshape(cap, 3, 4)
    # inv(A)ᵀ row i = cross(row_{i+1}, row_{i+2}) / det
    r = transforms[:, :, :3]
    c0 = torch.linalg.cross(r[:, 1], r[:, 2])
    c1 = torch.linalg.cross(r[:, 2], r[:, 0])
    c2 = torch.linalg.cross(r[:, 0], r[:, 1])
    det = torch.sum(r[:, 0] * c0, dim=-1)
    inv_det = torch.reciprocal(
        torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det)))
    normal_mats = torch.stack([c0, c1, c2], dim=1) * inv_det[:, None, None]
    return {
        "transforms": transforms,
        "normal_mats": normal_mats,
        "material_id": pdi[:, 0],
        "joints_offset": pdi[:, 1],
        "skinned": pdi[:, 2],
        "debug_id": pdi[:, 3],
        "joint_palette": f[base : base + j12].reshape(-1, 3, 4),
        "morph_weights": f[cap * 16 : base].reshape(cap, morph_k) if morph_k else None,
        "proj_view": f[base + j12 : base + j12 + 16].reshape(4, 4),
        "num_tris": counts[0],
        "n_opaque": counts[1],
        "n_masked": counts[2],
        "debug_mode": counts[3],
        # optional UI overlay draw data (renderer_tpu_torch/ui); None = no
        # UI pass
        "ui": packed.get("ui"),
    }
