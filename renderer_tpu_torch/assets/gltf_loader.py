"""glTF 2.0 loader (.gltf + .glb) with skins, animations, morph targets
and ntex textures, and the runtime of a loaded model: nodes, skins and
animations, and their queueing into a Scene with joint palettes.

Parity: the gltf crate (reference: gltf/src/lib.rs, gltf_json.rs,
pending_gltf.rs, scene_queueing.rs, mesh_iter.rs). Behavior highlights kept:

- Required attributes per primitive: POSITION (f32 VEC3), TEXCOORD_0 (f32
  VEC2), NORMAL (f32 VEC3), TANGENT (f32 VEC4); optional JOINTS_0 (u8 VEC4) +
  WEIGHTS_0 (f32 VEC4) make it skinned; indices must be u16/u32
  (lib.rs:607-648).
- Node transforms are TRS or matrix; parent transforms are flattened into
  every node at load time (lib.rs:569-577). Animated transforms start from
  the flattened transform, decompose to TRS, and replace animated channels
  (lib.rs:199-230) — quirks included.
- Image URIs are retargeted to .ntex (lib.rs:400-401) and decoded lazily
  through assets/ntex.py on the loader's device; embedded images (a
  superset) decode by content through assets/image.py (PNG or JPEG, the
  two types glTF allows; mimeType is ignored, as Pillow ignores it). Texture color-space kind is
  inferred from material usage: baseColor/emissive → sRGB, normal → normal
  map, others linear (get_gltf_texture_kinds, lib.rs:726-764).
- Material factors: glTF defaults, alpha_cutoff forced to 0 unless alphaMode
  is MASK, MASK → alpha-to-coverage, BLEND → blended
  (pending_gltf.rs:146-218).
- Animation sampling: LINEAR lerp/slerp, STEP, CUBICSPLINE; clamp before the
  first keyframe, *error* after the last (gltf_json.rs:238-286) — callers
  wrap time by the animation's end_time.
- Skins: joint = animated_node_transform @ inverse_bind_matrix
  (scene_queueing.rs:38-45).

Pose evaluation runs the host library's samplers (tools/native.py,
csrc/anim_pose.cpp), or the vectorized numpy sampler, their plain version,
without it.
"""

from __future__ import annotations

import base64
import json
import struct
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from renderer_tpu_torch.assets import ntex
from renderer_tpu_torch.assets.image import decode_image
from renderer_tpu_torch.core import constants, math3d
from renderer_tpu_torch.geometry.vertex_library import Mesh, VertexLibraryBuilder
from renderer_tpu_torch.materials.registry import (
    AlphaMode,
    Material,
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
)
from renderer_tpu_torch.scene.scene import Scene, make_draw_block
from renderer_tpu_torch.tools import native

GLTF_BYTE, GLTF_UNSIGNED_BYTE = 5120, 5121
GLTF_SHORT, GLTF_UNSIGNED_SHORT = 5122, 5123
GLTF_UNSIGNED_INT, GLTF_FLOAT = 5125, 5126

_CTYPE_NP = {
    GLTF_BYTE: np.int8,
    GLTF_UNSIGNED_BYTE: np.uint8,
    GLTF_SHORT: np.int16,
    GLTF_UNSIGNED_SHORT: np.uint16,
    GLTF_UNSIGNED_INT: np.uint32,
    GLTF_FLOAT: np.float32,
}
_ATYPE_N = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GltfLoadingError(Exception):
    pass


def generate_mips(base: np.ndarray) -> list[np.ndarray]:
    """Full mip chain by 2×2 box filter (the runtime analog of make-ntex's
    offline mip generation, make-ntex/src/main.rs:150-156)."""
    mips = [np.ascontiguousarray(base, dtype=np.uint8)]
    while min(mips[-1].shape[:2]) > 1:
        m = mips[-1]
        h, w = m.shape[0] // 2 * 2, m.shape[1] // 2 * 2
        half = (
            m[:h:2, :w:2].astype(np.uint16)
            + m[1:h:2, :w:2]
            + m[:h:2, 1:w:2]
            + m[1:h:2, 1:w:2]
        ) // 4
        mips.append(half.astype(np.uint8))
    return mips


class AnimationError(Exception):
    pass


@dataclass
class AnimationChannel:
    interpolation: str  # "LINEAR" | "STEP" | "CUBICSPLINE"
    path: str  # "translation" | "rotation" | "scale" | "weights"
    times: np.ndarray  # [K]
    values: np.ndarray  # [K, 3|4|W] (CUBICSPLINE: the middle "value" element)
    # CUBICSPLINE only: the per-keyframe in/out tangents (a_k, b_k in the
    # glTF spec's cubic Hermite formula). The reference never implemented
    # this mode (gltf_json.rs:235-236 comments it out of the enum); we
    # support it as a superset — assets exported with cubic samplers load
    # and play instead of failing schema validation.
    in_tangents: np.ndarray | None = None  # [K, W]
    out_tangents: np.ndarray | None = None  # [K, W]


@dataclass
class Animation:
    name: str | None
    start_time: float
    end_time: float
    nodes_channels: list[list[AnimationChannel] | None]
    # lazily built vectorized sampler (see _CompiledAnimation)
    _compiled: object = None


@dataclass
class Joint:
    node_index: int
    inverse_bind_matrix: np.ndarray  # 4x4


@dataclass
class Skin:
    joints: list[Joint]


def skin_arrays(skin: Skin):
    """Cached (joint node indices [J] i64, stacked inverse bind matrices
    [J, 4, 4] f32) for the batched palette build."""
    cached = getattr(skin, "_arrays", None)
    if cached is None:
        idx = np.asarray([j.node_index for j in skin.joints], np.int64)
        ibms = np.stack(
            [np.asarray(j.inverse_bind_matrix, np.float32) for j in skin.joints]
        ) if skin.joints else np.zeros((0, 4, 4), np.float32)
        cached = skin._arrays = (idx, ibms)
    return cached


@dataclass
class Node:
    name: str | None
    mesh: int | None
    skin: int | None
    children: list[int]
    transform: np.ndarray  # 4x4, parent-flattened at load
    # node-level morph weight override (glTF: node.weights beats
    # mesh.weights; animation weights channels beat both)
    weights: np.ndarray | None = None


def _interpolate(channel: AnimationChannel, time: float, animation_name) -> np.ndarray:
    """gltf_json.rs:238-286 parity (including the past-the-end error).
    Keyframe lookup via searchsorted (the reference's linear window scan,
    vectorized for per-frame host cost)."""
    times, values = channel.times, channel.values
    if len(times) == 0:
        raise AnimationError(f"animation {animation_name}: empty channel")
    if len(times) == 1 or time < times[0]:
        return values[0]
    k = int(np.searchsorted(times, time, side="right")) - 1
    if k >= len(times) - 1:
        raise AnimationError(
            f"animation {animation_name}: invalid timestamp {time} "
            f"(end_time {times[-1]})"
        )
    if channel.interpolation == "STEP":
        return values[k]
    t = (time - times[k]) / (times[k + 1] - times[k])
    if channel.interpolation == "CUBICSPLINE":
        return _hermite(
            float(t), float(times[k + 1] - times[k]),
            values[k], channel.out_tangents[k],
            values[k + 1], channel.in_tangents[k + 1],
            channel.path == "rotation",
        )
    if channel.path == "rotation":
        # t == 0 returns values[k] EXACTLY — sampling at a keyframe yields
        # the authored quat bit-for-bit, like the _hermite s == 0 early-out.
        # (glam's slerp at t=0 would re-normalize in its nlerp branch,
        # flipping last-ULP bits; all three samplers — this oracle, the
        # vectorized batch, csrc/anim_pose.cpp — share the early-out so
        # their pinned bit-parity holds at keyframe-exact times too.)
        if t == 0.0:
            return values[k]
        return math3d.quat_slerp(values[k], values[k + 1], float(t))
    return math3d.lerp(values[k], values[k + 1], float(t))


def _hermite(s: float, d: float, v0, b0, v1, a1, is_rotation: bool):
    """glTF cubic Hermite over one keyframe span (spec appendix C):
    p(s) = (2s³−3s²+1)v_k + d(s³−2s²+s)b_k + (−2s³+3s²)v_{k+1} + d(s³−s²)a_{k+1}
    with s the normalized time and d the span length; rotation results are
    renormalized (and s == 0 returns the keyframe value EXACTLY, mirroring
    the slerp early-out). Coefficients and accumulation in f64, f32 out —
    the same precision discipline as the lerp/slerp paths."""
    if is_rotation and s == 0.0:
        return v0
    s2 = s * s
    s3 = s2 * s
    r = (
        (2.0 * s3 - 3.0 * s2 + 1.0) * v0.astype(np.float64)
        + (d * (s3 - 2.0 * s2 + s)) * b0.astype(np.float64)
        + (-2.0 * s3 + 3.0 * s2) * v1.astype(np.float64)
        + (d * (s3 - s2)) * a1.astype(np.float64)
    )
    if is_rotation:
        r = r / np.sqrt(np.sum(r * r))
    return r.astype(np.float32)


class _CompiledAnimation:
    """Vectorized sampler for one animation: every channel's keyframe lookup
    and interpolation runs in a handful of batched numpy calls instead of a
    per-node / per-channel Python loop (which costs ~1 ms/frame even for a
    small skeleton — pure interpreter overhead). Bit-equivalent to the
    sequential `_interpolate` + `_decompose_trs` + `trs` path, which remains
    as the oracle and the path with nothing playing."""

    def __init__(self, anim: "Animation", nodes: list["Node"]):
        self.nodes_ref = nodes  # identity of the node list baked against
        chans: list[tuple[int, AnimationChannel]] = []
        self.touched: list[int] = []  # node indices that have a channel list
        self.has_weights = False
        self.weight_channels: list[tuple[int, AnimationChannel]] = []
        for ni, channels in enumerate(anim.nodes_channels):
            if channels is None:
                continue
            # a node with ANY channel list gets its TRS recomposed, matching
            # the sequential decompose→recompose (even when only a weights
            # channel targets it)
            slot = len(self.touched)
            self.touched.append(ni)
            for ch in channels:
                if ch.path == "weights":
                    # morph weights don't touch node transforms — they are
                    # sampled separately (Gltf.morph_weights_at)
                    self.has_weights = True
                    self.weight_channels.append((ni, ch))
                    continue
                if len(ch.times) == 0:
                    raise AnimationError(f"animation {anim.name}: empty channel")
                chans.append((slot, ch))
        m = len(self.touched)
        # static TRS of every touched node, decomposed ONCE (the sequential
        # path re-decomposes the node's flattened transform every frame)
        s0 = np.ones((m, 3), np.float32)
        q0 = np.zeros((m, 4), np.float32)
        t0 = np.zeros((m, 3), np.float32)
        for slot, ni in enumerate(self.touched):
            sc, q, tr = _decompose_trs(nodes[ni].transform)
            s0[slot], q0[slot], t0[slot] = sc, q, tr
        self.s0, self.q0, self.t0 = s0, q0, t0
        self.touched_arr = np.asarray(self.touched, np.int64)

        c = len(chans)
        self.n_channels = c
        counts = np.array([len(ch.times) for _, ch in chans], np.int64)
        self.counts = counts
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.big = float(
            max((float(ch.times[-1]) for _, ch in chans), default=0.0)
        ) + 2.0
        self.times = (
            np.concatenate(
                [ch.times.astype(np.float64) + i * self.big
                 for i, (_, ch) in enumerate(chans)]
            ) if c else np.zeros(0)
        )
        self.first_times = np.array(
            [float(ch.times[0]) for _, ch in chans], np.float64
        )
        vals = np.zeros((int(self.offsets[-1]), 4), np.float32)
        in_tan = np.zeros_like(vals)
        out_tan = np.zeros_like(vals)
        for i, (_, ch) in enumerate(chans):
            v = np.asarray(ch.values, np.float32).reshape(len(ch.times), -1)
            vals[self.offsets[i] : self.offsets[i + 1], : v.shape[1]] = v
            if ch.interpolation == "CUBICSPLINE":
                a = np.asarray(ch.in_tangents, np.float32).reshape(len(ch.times), -1)
                b = np.asarray(ch.out_tangents, np.float32).reshape(len(ch.times), -1)
                in_tan[self.offsets[i] : self.offsets[i + 1], : a.shape[1]] = a
                out_tan[self.offsets[i] : self.offsets[i + 1], : b.shape[1]] = b
        self.values = vals
        self.in_tan = in_tan
        self.out_tan = out_tan
        self.slot_of_chan = np.array([s for s, _ in chans], np.int64)
        path_ids = {"translation": 0, "rotation": 1, "scale": 2, "weights": 3}
        self.path_id = np.array([path_ids[ch.path] for _, ch in chans], np.int64)
        self.step = np.array(
            [ch.interpolation == "STEP" for _, ch in chans], bool
        )
        self.cubic = np.array(
            [ch.interpolation == "CUBICSPLINE" for _, ch in chans], bool
        )
        # the native samplers' layouts (csrc/anim_pose.cpp): raw per-channel
        # times (no big-offset packing) and narrow dtypes
        self.times_raw = (
            np.concatenate([ch.times.astype(np.float64) for _, ch in chans])
            if c else np.zeros(0)
        )
        self.path_id32 = self.path_id.astype(np.int32)
        self.step_u8 = self.step.astype(np.uint8)
        self.cubic_u8 = self.cubic.astype(np.uint8)

    def local_matrices(self, time: float, name, base=None) -> np.ndarray:
        """[n_touched, 4, 4] animated local transforms (T·R·S over the cached
        static decompose, channel overrides applied in channel order).

        `base` — optional (s [m,3], q [m,4], t [m,3]) replacing the baked
        static decompose per touched slot: the animation-layering path
        (multiple playing animations) re-decomposes the PREVIOUS animation's
        output for nodes both animations touch (lib.rs:199-230 starts each
        animation's TRS from the accumulated result)."""
        s, q, t = (
            (self.s0.copy(), self.q0.copy(), self.t0.copy())
            if base is None else base
        )
        if self.n_channels:
            qtime = float(time) + np.arange(self.n_channels) * self.big
            k = np.searchsorted(self.times, qtime, side="right") - 1 - self.offsets[:-1]
            below = float(time) < self.first_times
            single = self.counts == 1
            use0 = below | single
            if np.any((k >= self.counts - 1) & ~use0):
                raise AnimationError(
                    f"animation {name}: invalid timestamp {time}"
                )
            k = np.where(use0, 0, k)
            i0 = self.offsets[:-1] + k
            i1 = self.offsets[:-1] + np.minimum(k + 1, self.counts - 1)
            tk = self.times[i0] - np.arange(self.n_channels) * self.big
            tk1 = self.times[i1] - np.arange(self.n_channels) * self.big
            denom = np.where(tk1 > tk, tk1 - tk, 1.0)
            frac = np.where(use0 | self.step, 0.0, (float(time) - tk) / denom)
            v0 = self.values[i0]
            v1 = self.values[i1]
            fr32 = frac.astype(np.float32)[:, None]
            out = v0 * (1.0 - fr32) + v1 * fr32  # lerp (f32, `lerp` parity)
            cub = self.cubic
            if np.any(cub):
                # cubic Hermite (see _hermite): f64 coefficients over the
                # span hd = t_{k+1} − t_k, per-keyframe out/in tangents
                hd = tk1 - tk
                hs = frac
                hs2 = hs * hs
                hs3 = hs2 * hs
                c0 = (2.0 * hs3 - 3.0 * hs2 + 1.0)[:, None]
                c1 = (hd * (hs3 - 2.0 * hs2 + hs))[:, None]
                c2 = (-2.0 * hs3 + 3.0 * hs2)[:, None]
                c3 = (hd * (hs3 - hs2))[:, None]
                herm = (
                    c0 * v0.astype(np.float64)
                    + c1 * self.out_tan[i0].astype(np.float64)
                    + c2 * v1.astype(np.float64)
                    + c3 * self.in_tan[i1].astype(np.float64)
                )
                hrot = cub & (self.path_id == 1)
                if np.any(hrot):
                    n = np.sqrt(np.sum(herm * herm, axis=1, keepdims=True))
                    normed = herm / np.where(n > 0.0, n, 1.0)
                    # s == 0 returns the keyframe value EXACTLY (_hermite)
                    herm = np.where(
                        hrot[:, None],
                        np.where((frac == 0.0)[:, None],
                                 v0.astype(np.float64), normed),
                        herm,
                    )
                out[cub] = herm[cub].astype(np.float32)
            rot = (self.path_id == 1) & ~cub
            if np.any(rot):
                res = math3d.quat_slerp_batch(v0[rot], v1[rot], frac[rot])
                # frac == 0 must return values[k] EXACTLY (the sequential
                # path's early-outs skip slerp's normalization)
                out[rot] = np.where((frac[rot] == 0.0)[:, None], v0[rot], res)
            # scatter overrides; duplicate (node, path) channels keep the
            # LAST write like the sequential loop
            for pid, dst, width in ((0, t, 3), (1, q, 4), (2, s, 3)):
                sel = self.path_id == pid
                if np.any(sel):
                    dst[self.slot_of_chan[sel]] = out[sel][:, :width]
        return math3d.trs_batch(t, q, s)


def _compiled_animation(anim: "Animation", nodes) -> _CompiledAnimation:
    # re-bake if the cache was built against a different Gltf's node list
    # (an Animation reused across models must not serve the other model's
    # baked static TRS)
    if anim._compiled is None or anim._compiled.nodes_ref is not nodes:
        anim._compiled = _CompiledAnimation(anim, nodes)
    return anim._compiled


def _decompose_trs(m: np.ndarray):
    """glam Affine3A::to_scale_rotation_translation parity: scale from column
    norms (x negated if the determinant is negative), rotation from the
    normalized columns."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    cols = m[:3, :3]
    det = np.linalg.det(cols)
    sx = np.linalg.norm(cols[:, 0]) * (np.sign(det) or 1.0)
    sy = np.linalg.norm(cols[:, 1])
    sz = np.linalg.norm(cols[:, 2])
    scale = np.array([sx, sy, sz])
    safe = np.where(np.abs(scale) > 1e-12, scale, 1.0)
    rot = cols / safe[None, :]
    return scale.astype(np.float32), math3d.mat3_to_quat(rot), t.astype(np.float32)


def _decompose_trs_batch(ms: np.ndarray):
    """Batched _decompose_trs: [N,4,4] → (scale [N,3] f32, quat [N,4] f32,
    translation [N,3] f32). Same f64 math per row (cofactor determinant in
    place of the LAPACK one — only its SIGN is consumed)."""
    m = np.asarray(ms, np.float64)
    t = m[:, :3, 3]
    c = m[:, :3, :3]
    det = (
        c[:, 0, 0] * (c[:, 1, 1] * c[:, 2, 2] - c[:, 1, 2] * c[:, 2, 1])
        - c[:, 0, 1] * (c[:, 1, 0] * c[:, 2, 2] - c[:, 1, 2] * c[:, 2, 0])
        + c[:, 0, 2] * (c[:, 1, 0] * c[:, 2, 1] - c[:, 1, 1] * c[:, 2, 0])
    )
    sign = np.sign(det)
    sign = np.where(sign == 0.0, 1.0, sign)
    norms = np.sqrt(
        c[:, 0, :] * c[:, 0, :] + c[:, 1, :] * c[:, 1, :]
        + c[:, 2, :] * c[:, 2, :]
    )  # [N,3] column norms
    scale = norms * np.stack([sign, np.ones_like(sign), np.ones_like(sign)], -1)
    safe = np.where(np.abs(scale) > 1e-12, scale, 1.0)
    rot = c / safe[:, None, :]
    return (
        scale.astype(np.float32),
        math3d.mat3_to_quat_batch(rot),
        t.astype(np.float32),
    )


class Gltf:
    """A loaded glTF model: meshes+materials in device-ready form, node
    hierarchy, skins and animations (reference Gltf, gltf/src/lib.rs:101-150).
    """

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.root_nodes: list[int] = []
        self.skins: list[Skin] = []
        self.animations: list[Animation] = []
        # (mesh, material) per primitive per mesh index
        self.meshes: list[list[tuple[Mesh, Material]]] = []
        # glTF mesh-level default morph weights per mesh index (or None)
        self.mesh_weights: list[np.ndarray | None] = []
        self.materials: list[Material] = []
        self.textures: list[Texture] = []
        self._walk = None  # cached (order, parent, static_locals) arrays
        # queue()'s transform @ static-pose product, keyed on the root
        # transform bytes (the demo re-queues Sponza at the same transform
        # every frame — main.rs:549-583)
        self._queue_cache = None
        self._multi_cache = None  # comps tuple -> native layered sampler
        self._prologue_cache = None  # comps tuple -> native prologue entry

    def invalidate_caches(self) -> None:
        """Drop every derived cache: compiled animations (with their baked
        static TRS decomposes and native-sampler pointers), the hierarchy
        walk arrays, the queue-order row split and the native prologues.

        The fast paths snapshot `Node.transform` (and the node graph) at
        first use; nodes are treated as IMMUTABLE afterwards — mutate a node
        transform, reparent nodes, or edit animation channels only if you
        call this afterwards, or subsequent frames serve stale poses that
        diverge from the sequential oracle path."""
        self._walk = None
        self._walk_valid = None
        self._walk_all_valid = None
        self._rows_cache = None
        self._multi_cache = None
        self._prologue_cache = None
        self._queue_cache = None
        for a in self.animations:
            a._compiled = None

    @property
    def has_morph(self) -> bool:
        """True when any primitive carries morph targets (computed once —
        geometry is immutable after load)."""
        cached = getattr(self, "_has_morph_cache", None)
        if cached is None:
            cached = self._has_morph_cache = any(
                m.morph_count for prims in self.meshes for m, _mat in prims
            )
        return cached

    # -- queueing (scene_queueing.rs) -------------------------------------

    def _mesh_iter(self):
        """DFS yielding (node_index, mesh, material, skin, transform)
        (mesh_iter.rs; stack order matches the reference's Vec::pop)."""
        queue = list(self.root_nodes)
        while queue:
            node_index = queue.pop()
            node = self.nodes[node_index]
            queue.extend(node.children)
            if node.mesh is not None:
                for mesh, material in self.meshes[node.mesh]:
                    yield node_index, mesh, material, node.skin, node.transform

    def _split_rows(self):
        """Cached queue-order split of _mesh_iter: (skinned rows
        [(node_index, mesh, material, skin_index)], static DrawBlock,
        static node indices [M], static default morph weights [M, 8] or
        None, morphed static rows [(row, morph_count, node_index)]).
        Statics batch into one vectorized queue_block; interleaving order vs
        the sequential loop only moves draws with DIFFERENT sort keys
        relative to each other (the skinned flag bit separates the groups),
        so the sorted stream is identical."""
        cached = getattr(self, "_rows_cache", None)
        if cached is None:
            skinned_rows = []
            static_items = []
            static_idx = []
            for ni, mesh, material, skin_index, _ in self._mesh_iter():
                if skin_index is not None:
                    skinned_rows.append((ni, mesh, material, skin_index))
                else:
                    static_items.append((mesh, material, None))
                    static_idx.append(ni)
            static_mw = None
            morph_rows = []
            for r, ((mesh, _mat, _j), ni) in enumerate(
                zip(static_items, static_idx)
            ):
                if mesh.morph_count:
                    morph_rows.append((r, mesh.morph_count, ni))
            if morph_rows:
                static_mw = np.zeros(
                    (len(static_items), constants.MAX_MORPH_TARGETS), np.float32
                )
                for r, mc, ni in morph_rows:
                    w = self._node_default_weights(ni)
                    if w is not None:
                        k = min(mc, w.size)
                        static_mw[r, :k] = w[:k]
            cached = self._rows_cache = (
                skinned_rows,
                make_draw_block(static_items),
                np.asarray(static_idx, np.int64),
                static_mw,
                morph_rows,
            )
        return cached

    def _node_default_weights(self, ni: int) -> np.ndarray | None:
        """glTF default morph weights for a node's mesh: node.weights beats
        mesh.weights (animation weights channels beat both)."""
        node = self.nodes[ni]
        if node.weights is not None:
            return node.weights
        if node.mesh is not None and node.mesh < len(self.mesh_weights):
            return self.mesh_weights[node.mesh]
        return None

    def morph_weights_at(
        self, playing_animations: list[tuple[float, "Animation"]]
    ) -> dict[int, np.ndarray]:
        """node index → morph weights [T] sampled from the playing
        animations' weights channels (later animations override — channel
        semantics applied to weights). The reference leaves this as a
        todo!() (gltf/src/lib.rs:229); we implement it."""
        out: dict[int, np.ndarray] = {}
        for time, anim in playing_animations:
            comp = _compiled_animation(anim, self.nodes)
            for ni, ch in comp.weight_channels:
                out[ni] = np.asarray(
                    _interpolate(ch, float(time), anim.name), np.float32
                ).reshape(-1)
        return out

    def _row_morph_weights(self, ni: int, mesh, wmap) -> np.ndarray | None:
        if not mesh.morph_count:
            return None
        w = wmap.get(ni)
        if w is None:
            w = self._node_default_weights(ni)
        return None if w is None else w[: mesh.morph_count]

    def queue(self, scene: Scene, transform: np.ndarray) -> bool:
        skinned_rows, block, static_idx, static_mw, _ = self._split_rows()
        assert not skinned_rows, "skinned meshes must have joints defined"
        t = np.asarray(transform, np.float32)
        tb = t.tobytes()
        c = self._queue_cache
        if c is None or c[0] != tb:
            locals_ = self._walk_arrays()[2][static_idx]  # [M,4,4] node poses
            # cached per root transform: static node poses are immutable
            # after first queue (see invalidate_caches); queue_block copies,
            # so the cached product is never aliased by the scene
            self._queue_cache = c = (tb, t @ locals_)
        return scene.queue_block(block, c[1], morph_weights=static_mw)

    def queue_animated(
        self,
        scene: Scene,
        transform: np.ndarray,
        playing_animations: list[tuple[float, Animation]],
    ) -> bool:
        """scene_queueing.rs:17-57: skinned meshes get joint palettes (joint =
        animated node transform @ inverse bind matrix) and the *un-multiplied*
        model transform; static meshes get transform @ animated node pose."""
        all_drawn = True
        joints_offsets_per_skin: dict[int, int] = {}
        wmap = (
            self.morph_weights_at(playing_animations)
            if self.has_morph else {}
        )
        if playing_animations:
            done = self._queue_animated_native(
                scene, transform, playing_animations, wmap
            )
            if done is not None:
                return done
        fast = self._fast_node_transforms(playing_animations)
        if fast is None:
            node_transforms = self.get_node_transforms(playing_animations)
            for node_index, mesh, material, skin_index, _ in self._mesh_iter():
                mw = self._row_morph_weights(node_index, mesh, wmap)
                if skin_index is not None:
                    offset = joints_offsets_per_skin.get(skin_index)
                    if offset is None:
                        skin = self.skins[skin_index]
                        alloc = scene.allocate_joint_offset(len(skin.joints))
                        if alloc is None:
                            raise RuntimeError("too many bones in scene")
                        offset, palette = alloc
                        for i, joint in enumerate(skin.joints):
                            animated = node_transforms[joint.node_index]
                            if animated is None:
                                animated = math3d.IDENTITY
                            palette[i] = animated @ joint.inverse_bind_matrix
                        joints_offsets_per_skin[skin_index] = offset
                    all_drawn &= scene.queue_mesh(mesh, material, offset,
                                                  transform, mw)
                else:
                    animated = node_transforms[node_index]
                    if animated is None:
                        animated = math3d.IDENTITY
                    all_drawn &= scene.queue_mesh(
                        mesh, material, None, transform @ animated, mw
                    )
            return all_drawn

        # fast path: skinned palettes batched per skin; the static subset is
        # ONE vectorized queue_block (see _split_rows for the order argument)
        mats, valid = fast
        # every scene-reachable node is valid in the common case — skip the
        # identity-substitution np.where on the hot path
        all_valid = getattr(self, "_walk_all_valid", None)
        if all_valid is None:
            all_valid = self._walk_all_valid = bool(valid.all())
        skinned_rows, block, static_idx, static_mw, morph_rows = \
            self._split_rows()
        for ni, mesh, material, skin_index in skinned_rows:
            offset = joints_offsets_per_skin.get(skin_index)
            if offset is None:
                skin = self.skins[skin_index]
                alloc = scene.allocate_joint_offset(len(skin.joints))
                if alloc is None:
                    raise RuntimeError("too many bones in scene")
                offset, palette = alloc
                # batched: palette = animated[joints] @ ibms
                idx, ibms = skin_arrays(skin)
                a = mats[idx] if all_valid else np.where(
                    valid[idx][:, None, None], mats[idx], math3d.IDENTITY
                )
                np.matmul(a, ibms, out=palette[: len(skin.joints)])
                joints_offsets_per_skin[skin_index] = offset
            all_drawn &= scene.queue_mesh(
                mesh, material, offset, transform,
                self._row_morph_weights(ni, mesh, wmap),
            )
        if len(static_idx):
            a = mats[static_idx] if all_valid else np.where(
                valid[static_idx][:, None, None], mats[static_idx],
                math3d.IDENTITY,
            )
            mw = static_mw
            if wmap and morph_rows:
                mw = static_mw.copy()
                for r, mc, ni in morph_rows:
                    w = wmap.get(ni)
                    if w is not None:
                        k = min(mc, w.size)
                        mw[r] = 0.0
                        mw[r, :k] = w[:k]
            all_drawn &= scene.queue_block(
                block, np.asarray(transform, np.float32) @ a,
                morph_weights=mw,
            )
        return all_drawn

    def get_animation(self, name: str) -> Animation | None:
        for a in self.animations:
            if a.name == name:
                return a
        return None

    def get_node_transforms(
        self, playing_animations: list[tuple[float, Animation]]
    ) -> list[np.ndarray | None]:
        """lib.rs:181-193: walk from roots multiplying parent poses (note the
        node transforms are already parent-flattened, matching the reference's
        behavior exactly)."""
        fast = self._fast_node_transforms(playing_animations)
        if fast is not None:
            mats, valid = fast
            return [mats[i] if valid[i] else None for i in range(len(self.nodes))]
        transforms: list[np.ndarray | None] = [None] * len(self.nodes)
        stack = [(n, math3d.IDENTITY) for n in self.root_nodes]
        while stack:
            node_index, parent = stack.pop()
            current = parent @ self._animated_transform(node_index, playing_animations)
            transforms[node_index] = current
            for child in self.nodes[node_index].children:
                stack.append((child, current))
        return transforms

    def _walk_arrays(self):
        """Cached hierarchy-walk order: (order [R] i64 in the same pop order
        as get_node_transforms, parent [R] i64 (-1 = root), static_locals
        [n, 4, 4])."""
        if self._walk is None:
            order: list[int] = []
            parents: list[int] = []
            stack = [(ni, -1) for ni in self.root_nodes]
            while stack:
                ni, p = stack.pop()
                order.append(ni)
                parents.append(p)
                for child in self.nodes[ni].children:
                    stack.append((child, ni))
            n = len(self.nodes)
            static = np.zeros((max(n, 1), 4, 4), np.float32)
            for i, node in enumerate(self.nodes):
                static[i] = node.transform
            self._walk = (
                np.asarray(order, np.int64), np.asarray(parents, np.int64), static
            )
        return self._walk

    def _valid_mask(self, n: int, order) -> np.ndarray:
        valid = getattr(self, "_walk_valid", None)
        if valid is None:
            valid = np.zeros(n, bool)
            valid[order] = True
            self._walk_valid = valid
        return valid

    def _fast_node_transforms(self, playing_animations):
        """Vectorized pose evaluation for any number of playing animations:
        (mats [n, 4, 4] f32, valid [n] bool); None only when nothing is
        playing (node transforms are then the static poses)."""
        if len(playing_animations) == 0:
            return None
        comps = [
            _compiled_animation(anim, self.nodes)
            for _t, anim in playing_animations
        ]
        if len(playing_animations) > 1:
            return self._layered_node_transforms(playing_animations, comps)
        time, anim = playing_animations[0]
        comp = comps[0]
        order, parents, static = self._walk_arrays()

        sampler = getattr(comp, "_native_pose", False)
        if sampler is False:  # built once; None: no host library
            sampler = comp._native_pose = native.make_anim_pose(
                comp, static, order, parents
            )
        if sampler is not None:
            try:
                mats = sampler(float(time))
            except ValueError:
                raise AnimationError(
                    f"animation {anim.name}: invalid timestamp {time}"
                ) from None
            return mats, self._valid_mask(mats.shape[0], order)

        local = static.copy()
        if comp.touched:
            local[comp.touched_arr] = comp.local_matrices(time, anim.name)
        return self._chain_walk(local, order, parents)

    def _chain_walk(self, local, order, parents):
        """Sequential parent-chain multiply (inherent data dependence; the
        order array makes it a tight loop of 4x4 matmuls)."""
        mats = np.empty_like(local)
        for ni, p in zip(order.tolist(), parents.tolist()):
            mats[ni] = local[ni] if p < 0 else mats[p] @ local[ni]
        return mats, self._valid_mask(local.shape[0], order)

    def _layered_node_transforms(self, playing_animations, comps):
        """N ≥ 2 playing animations layered in play order — the fast analog
        of the sequential oracle (lib.rs:181-230 via scene_queueing.rs:17-57):
        each animation's TRS starts from the DECOMPOSE of the accumulated
        result for nodes an earlier playing animation already touched, and
        from the baked static decompose otherwise."""
        order, parents, static = self._walk_arrays()

        # native full path (sample + layer + decompose + chain), cached per
        # compiled-animation tuple. The comps themselves are the key: the
        # strong references keep them alive, so a freed comp's id() can
        # never alias a live entry after a rebake.
        key = tuple(comps)
        if self._multi_cache is None:
            self._multi_cache = {}
        sampler = self._multi_cache.get(key, False)
        if sampler is False:
            sampler = self._multi_cache[key] = native.make_anim_pose_multi(
                comps, static, order, parents
            )
        times = [float(t) for t, _ in playing_animations]
        if sampler is not None:
            try:
                mats = sampler(times)
            except ValueError as e:
                k = int(e.args[0]) if e.args and isinstance(e.args[0], int) else 0
                anim = playing_animations[k][1]
                raise AnimationError(
                    f"animation {anim.name}: invalid timestamp {times[k]}"
                ) from None
            return mats, self._valid_mask(mats.shape[0], order)

        # the plain version: identical layering, vectorized per animation
        local = static.copy()
        touched = np.zeros(static.shape[0], bool)
        for (time, anim), comp in zip(playing_animations, comps):
            if not comp.touched:
                continue
            idx = comp.touched_arr
            prev = touched[idx]
            base = None
            if prev.any():
                s, q, t0 = comp.s0.copy(), comp.q0.copy(), comp.t0.copy()
                ds, dq, dt = _decompose_trs_batch(local[idx[prev]])
                s[prev], q[prev], t0[prev] = ds, dq, dt
                base = (s, q, t0)
            local[idx] = comp.local_matrices(time, anim.name, base=base)
            touched[idx] = True
        return self._chain_walk(local, order, parents)

    def _build_prologue(self, comps):
        """Compile the one-call native frame prologue for a fixed tuple of
        playing animations (csrc anim_prologue via native.make_anim_prologue).
        Returns None when ineligible — no native library, or unreachable
        nodes that need the numpy path's identity substitution. The returned
        entry bakes the skin/joint layout and the DrawBlock row split; only
        the joint OFFSETS (scene palette cursor positions) vary per frame,
        handled by the per-offsets block cache in _queue_animated_native."""
        order, parents, static = self._walk_arrays()
        valid = self._valid_mask(static.shape[0], order)
        all_valid = getattr(self, "_walk_all_valid", None)
        if all_valid is None:
            all_valid = self._walk_all_valid = bool(valid.all())
        if not all_valid:
            return None
        skinned_rows, static_block, static_idx, static_mw, morph_rows = \
            self._split_rows()
        skins_in_order: list[int] = []
        for _ni, _mesh, _mat, skin_index in skinned_rows:
            if skin_index not in skins_in_order:
                skins_in_order.append(skin_index)
        joint_nodes_parts, ibms_parts, skin_counts = [], [], []
        for si in skins_in_order:
            idx, ibms = skin_arrays(self.skins[si])
            joint_nodes_parts.append(idx)
            ibms_parts.append(ibms)
            skin_counts.append(len(idx))
        joint_nodes = (
            np.concatenate(joint_nodes_parts) if joint_nodes_parts
            else np.zeros(0, np.int64)
        )
        ibms = (
            np.concatenate(ibms_parts) if ibms_parts
            else np.zeros((0, 4, 4), np.float32)
        )
        sample = native.make_anim_prologue(
            comps, static, order, parents, joint_nodes, ibms,
            len(skinned_rows), static_idx,
        )
        if sample is None:
            return None

        # combined default morph weights in DrawBlock row order
        # [skinned..., static...]; None when nothing in the draw list morphs
        n_rows = len(skinned_rows) + len(static_block.keys)
        skinned_morph = [
            (r, mesh.morph_count, ni)
            for r, (ni, mesh, _mat, _si) in enumerate(skinned_rows)
            if mesh.morph_count
        ]
        base_mw = None
        if skinned_morph or morph_rows:
            base_mw = np.zeros((n_rows, constants.MAX_MORPH_TARGETS), np.float32)
            for r, mc, ni in skinned_morph:
                w = self._node_default_weights(ni)
                if w is not None:
                    k = min(mc, w.size)
                    base_mw[r, :k] = w[:k]
            if static_mw is not None:
                base_mw[len(skinned_rows):] = static_mw
        return {
            "sample": sample,
            "skins_in_order": skins_in_order,
            "skin_counts": skin_counts,
            "skinned_rows": skinned_rows,
            "static_block": static_block,
            "skinned_morph": skinned_morph,
            "static_morph": morph_rows,
            "base_mw": base_mw,
            "blocks": {},  # joint-offsets tuple -> combined DrawBlock
        }

    def _queue_animated_native(self, scene, transform, playing, wmap):
        """queue_animated's fastest path: ONE native call (pose sampling +
        joint palettes written into the scene palette + the per-draw
        transform array) and ONE vectorized queue_block. Returns the
        all-drawn bool, or None to fall back to the numpy fast path.
        Bit-compatible with the numpy path (tests/test_torch_native.py pins
        the resulting scene SoA and palette)."""
        comps = [_compiled_animation(a, self.nodes) for _t, a in playing]
        key = tuple(comps)
        if self._prologue_cache is None:
            self._prologue_cache = {}
        cache = self._prologue_cache
        entry = cache.get(key, False)
        if entry is False:
            entry = cache[key] = self._build_prologue(comps)
        if entry is None:
            return None

        # joint palette ranges: bump-allocated back-to-back, so the skins'
        # palettes form ONE contiguous scene slice the native call fills.
        # Remember the cursor so a failed pose sample can roll the
        # allocation back — the numpy paths raise BEFORE allocating, and a
        # caller that catches AnimationError and requeues must not leak
        # palette slots.
        cursor_before = scene._joint_cursor
        offsets = []
        for si, count in zip(entry["skins_in_order"], entry["skin_counts"]):
            alloc = scene.allocate_joint_offset(count)
            if alloc is None:
                raise RuntimeError("too many bones in scene")
            offsets.append(alloc[0])
        total_joints = sum(entry["skin_counts"])
        first = offsets[0] if offsets else 0
        palettes_out = scene.joint_palette[first : first + total_joints]

        off_key = tuple(offsets)
        block = entry["blocks"].get(off_key)
        if block is None:
            if len(entry["blocks"]) >= 8:  # offsets churn: keep it bounded
                entry["blocks"].clear()
            off_of_skin = dict(zip(entry["skins_in_order"], offsets))
            items = [
                (mesh, material, off_of_skin[si])
                for _ni, mesh, material, si in entry["skinned_rows"]
            ] + [
                (mesh, material, None)
                for mesh, material in entry["static_block"].sources
            ]
            block = entry["blocks"][off_key] = make_draw_block(items)

        times = [float(t) for t, _ in playing]
        try:
            transforms = entry["sample"](times, transform, palettes_out)
        except ValueError as e:
            scene._joint_cursor = cursor_before  # nothing was drawn
            k = int(e.args[0]) if e.args and isinstance(e.args[0], int) else 0
            raise AnimationError(
                f"animation {playing[k][1].name}: invalid timestamp "
                f"{times[k]}"
            ) from None

        mw = entry["base_mw"]
        if wmap and mw is not None:
            n_skinned = len(entry["skinned_rows"])
            mw = mw.copy()
            for r, mc, ni in entry["skinned_morph"]:
                w = wmap.get(ni)
                if w is not None:
                    k = min(mc, w.size)
                    mw[r] = 0.0
                    mw[r, :k] = w[:k]
            for r, mc, ni in entry["static_morph"]:
                w = wmap.get(ni)
                if w is not None:
                    k = min(mc, w.size)
                    mw[n_skinned + r] = 0.0
                    mw[n_skinned + r, :k] = w[:k]
        return scene.queue_block(block, transforms, morph_weights=mw)

    def _animated_transform(self, node_index, playing_animations) -> np.ndarray:
        node = self.nodes[node_index]
        result = node.transform
        for time, animation in playing_animations:
            channels = animation.nodes_channels[node_index]
            if channels is None:
                continue
            scale, rotation, translation = _decompose_trs(result)
            for ch in channels:
                if ch.path == "weights":
                    continue  # morph weights are sampled by morph_weights_at
                value = _interpolate(ch, time, animation.name)
                if ch.path == "translation":
                    translation = value
                elif ch.path == "rotation":
                    rotation = value
                elif ch.path == "scale":
                    scale = value
            result = math3d.trs(translation, rotation, scale)
        return result


# -- container parsing --------------------------------------------------------


def _parse_glb(data: bytes) -> tuple[dict, bytes | None]:
    """GLB container (lib.rs:239-296): 12-byte header then chunks."""
    magic, version, _length = struct.unpack("<III", data[:12])
    if magic != 0x46546C67:
        raise GltfLoadingError("not a GLB file (bad magic)")
    if version != 2:
        raise GltfLoadingError(f"unsupported GLB version {version}")
    offset = 12
    json_chunk = None
    bin_chunk = None
    while offset + 8 <= len(data):
        clen, ctype = struct.unpack("<II", data[offset : offset + 8])
        if offset + 8 + clen > len(data):
            # a truncated container fails here with file context, not later
            # as a short read in some accessor
            raise GltfLoadingError(
                f"GLB truncated: chunk at {offset} claims {clen} bytes, "
                f"file has {len(data) - offset - 8} left"
            )
        chunk = data[offset + 8 : offset + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            json_chunk = chunk
        elif ctype == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
        offset += 8 + clen + (-clen % 4)
    if json_chunk is None:
        raise GltfLoadingError("GLB missing JSON chunk")
    return json.loads(json_chunk), bin_chunk


class _Accessors:
    def __init__(self, gltf: dict, resource_dir: Path, bin_buffer: bytes | None):
        self.gltf = gltf
        self.dir = resource_dir
        self.bin = bin_buffer
        self._buffers: dict[int, bytes] = {}

    def _buffer(self, index: int) -> bytes:
        if index not in self._buffers:
            buf = self.gltf["buffers"][index]
            uri = buf.get("uri")
            if uri is None:
                if self.bin is None:
                    raise GltfLoadingError("buffer without uri and no GLB BIN chunk")
                self._buffers[index] = self.bin
            elif uri.startswith("data:"):
                self._buffers[index] = base64.b64decode(uri.split(",", 1)[1])
            else:
                self._buffers[index] = (self.dir / uri).read_bytes()
        return self._buffers[index]

    def read(self, accessor_index: int, ctype: int | None, atype: str) -> np.ndarray:
        """Accessor → numpy [count, ncomp] with ctype/atype validation
        (lib.rs:650-724). Sparse accessors (common for morph-target deltas)
        decode per the spec: the dense base (zeros when the accessor has no
        bufferView) overridden at `sparse.indices` with `sparse.values` —
        a superset of the reference, which has no sparse handling."""
        acc = self.gltf["accessors"][accessor_index]
        if ctype is not None and acc["componentType"] != ctype:
            raise GltfLoadingError(
                f"accessor {accessor_index}: componentType "
                f"{acc['componentType']} != required {ctype}"
            )
        if acc["type"] != atype:
            raise GltfLoadingError(
                f"accessor {accessor_index}: type {acc['type']} != required {atype}"
            )
        dtype = np.dtype(_CTYPE_NP[acc["componentType"]]).newbyteorder("<")
        ncomp = _ATYPE_N[atype]
        count = acc["count"]
        if "bufferView" in acc:
            base = self._read_view(
                acc["bufferView"], dtype, ncomp, count, acc.get("byteOffset", 0)
            )
        else:
            # spec: a sparse (or zero-filled) accessor may omit bufferView
            base = np.zeros((count, ncomp), dtype)
        sparse = acc.get("sparse")
        if sparse:
            sc = sparse["count"]
            sidx = sparse["indices"]
            ict = sidx["componentType"]
            if ict not in (GLTF_UNSIGNED_BYTE, GLTF_UNSIGNED_SHORT,
                           GLTF_UNSIGNED_INT):
                raise GltfLoadingError(
                    "sparse indices componentType must be unsigned int"
                )
            idt = np.dtype(_CTYPE_NP[ict]).newbyteorder("<")
            indices = self._read_view(
                sidx["bufferView"], idt, 1, sc, sidx.get("byteOffset", 0)
            ).reshape(-1).astype(np.int64)
            svals = sparse["values"]
            values = self._read_view(
                svals["bufferView"], dtype, ncomp, sc, svals.get("byteOffset", 0)
            )
            if sc and (indices.max() >= count or indices.min() < 0):
                raise GltfLoadingError("sparse index out of accessor range")
            base = base.copy()
            base[indices] = values
        return base

    def _read_view(self, view_index: int, dtype, ncomp: int, count: int,
                   acc_offset: int) -> np.ndarray:
        view = self.gltf["bufferViews"][view_index]
        data = self._buffer(view["buffer"])
        start = view.get("byteOffset", 0) + acc_offset
        stride = view.get("byteStride")
        elem_size = dtype.itemsize * ncomp
        # spec §3.6.2.1: the accessor must fit inside ITS bufferView — never
        # silently read the neighbouring bytes of the shared buffer, nor
        # surface as a bare numpy ValueError on a short file
        if count:
            step = stride if stride and stride != elem_size else elem_size
            need = acc_offset + step * (count - 1) + elem_size
            avail = view.get("byteLength", len(data) - view.get("byteOffset", 0))
            if need > avail or start + step * (count - 1) + elem_size > len(data):
                raise GltfLoadingError(
                    f"bufferView {view_index}: accessor needs {need} bytes "
                    f"but the view holds {avail} (buffer {len(data)}B, "
                    f"offset {start})"
                )
        if stride is None or stride == elem_size:
            arr = np.frombuffer(data, dtype, count=count * ncomp, offset=start)
            return arr.reshape(count, ncomp)
        # interleaved view (byteStride > element size): one strided window
        # over the raw bytes + one contiguous copy (Sponza interleaves all
        # vertex attributes in one view, lib.rs:607-649)
        if count == 0:
            return np.zeros((0, ncomp), dtype)
        raw = np.frombuffer(
            data, np.uint8, count=stride * (count - 1) + elem_size, offset=start
        )
        window = np.lib.stride_tricks.as_strided(
            raw, shape=(count, elem_size), strides=(stride, 1), writeable=False
        )
        return np.ascontiguousarray(window).view(dtype).reshape(count, ncomp)


#: normalized-integer → float dequantization for animation outputs
#: (rotation VEC4 / weights SCALAR may be stored quantized; glTF spec
#: §3.6.2.2). The reference dequantizes per component type in parse_float
#: (gltf/src/lib.rs:766-776) except that its SHORT branch reads the bits as
#: u16; this keeps the spec mapping (i16/32767, clamped at -1).
_ANIM_DEQUANT = {
    GLTF_BYTE: lambda v: np.maximum(v.astype(np.float32) / 127.0, -1.0),
    GLTF_UNSIGNED_BYTE: lambda v: v.astype(np.float32) / 255.0,
    GLTF_SHORT: lambda v: np.maximum(v.astype(np.float32) / 32767.0, -1.0),
    GLTF_UNSIGNED_SHORT: lambda v: v.astype(np.float32) / 65535.0,
    GLTF_FLOAT: lambda v: v.astype(np.float32),
}


def _dequantize_anim(values: np.ndarray, ctype: int) -> np.ndarray:
    try:
        f = _ANIM_DEQUANT[ctype]
    except KeyError:
        raise GltfLoadingError(
            f"animation output componentType {ctype} not float or "
            "normalized-integer"
        ) from None
    return f(values)


def _texture_kinds(gltf: dict) -> dict[int, str]:
    """Image index → color-space kind from material usage (lib.rs:726-764)."""
    kinds: dict[int, str] = {}
    textures = gltf.get("textures", [])

    def mark(tex_info, kind):
        if tex_info is None:
            return
        source = textures[tex_info["index"]].get("source")
        if source is not None:
            kinds.setdefault(source, kind)

    for mat in gltf.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        mark(pbr.get("baseColorTexture"), TextureKind.SRGB_COLOR)
        mark(mat.get("emissiveTexture"), TextureKind.SRGB_COLOR)
        mark(mat.get("normalTexture"), TextureKind.NORMAL_MAP)
        mark(pbr.get("metallicRoughnessTexture"), TextureKind.LINEAR_COLOR)
        mark(mat.get("occlusionTexture"), TextureKind.LINEAR_COLOR)
    return kinds


def _image_wrap_modes(gltf: dict) -> dict[int, tuple[int, int]]:
    """Image index → (wrap_s, wrap_t) TextureWrap pair, from glTF samplers.

    BEYOND the reference, which parses glTF `samplers` but never uses them
    (one repeat sampler for everything, descriptors.rs:90-105). A registry
    Texture is per IMAGE, so an image shared by several glTF textures takes
    the first *explicit* sampler's modes: samplerless textures (spec
    default: REPEAT) never claim an entry, and a conflicting second explicit
    sampler warns. Unknown enums fall back to REPEAT."""
    _gl_wrap = {10497: 0, 33071: 1, 33648: 2}  # REPEAT / CLAMP / MIRROR
    samplers = gltf.get("samplers", [])
    image_wrap: dict[int, tuple[int, int]] = {}
    for t in gltf.get("textures", []):
        src = t.get("source")
        if src is None or "sampler" not in t:
            continue  # default REPEAT == the caller's .get() fallback
        s = samplers[t["sampler"]]
        wrap = (_gl_wrap.get(s.get("wrapS", 10497), 0),
                _gl_wrap.get(s.get("wrapT", 10497), 0))
        if src in image_wrap:
            if wrap != image_wrap[src]:
                warnings.warn(
                    f"glTF image {src} is referenced by textures with "
                    f"conflicting sampler wrap modes {image_wrap[src]} vs "
                    f"{wrap}; keeping the first (per-image sampler state)",
                    stacklevel=2,
                )
            continue
        image_wrap[src] = wrap
    return image_wrap


def _parse_nodes(gltf: dict, out: Gltf) -> None:
    """Nodes (TRS or column-major matrix), then parent transforms flattened
    into every child (lib.rs:569-577)."""
    for node in gltf.get("nodes", []):
        if "matrix" in node:
            m = np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major
        else:
            m = math3d.trs(
                np.array(node.get("translation", [0, 0, 0]), np.float32),
                np.array(node.get("rotation", [0, 0, 0, 1]), np.float32),
                np.array(node.get("scale", [1, 1, 1]), np.float32),
            )
        nw = node.get("weights")
        out.nodes.append(Node(
            name=node.get("name"),
            mesh=node.get("mesh"),
            skin=node.get("skin"),
            children=list(node.get("children", [])),
            transform=m,
            weights=None if nw is None else np.asarray(nw, np.float32),
        ))


def _flatten_transforms(out: Gltf) -> None:
    parents = list(out.root_nodes)
    while parents:
        p = parents.pop()
        for c in out.nodes[p].children:
            out.nodes[c].transform = out.nodes[p].transform @ out.nodes[c].transform
            parents.append(c)


def ntex_texture(ntex_path: Path, kind: str, wrap=(0, 0), device="cuda",
                 name: str | None = None) -> Texture:
    """A lazy Texture over an .ntex file: header now (the reference's
    measure phase), the decode (on `device`) only if the atlas needs the
    mips, and the raw BC7 blocks for the device-decode atlas."""
    header = ntex.decode_header_file(ntex_path)
    return Texture(
        None, kind, name=ntex_path.name if name is None else name,
        loader=lambda p=ntex_path: ntex.decode_file(p, device=device)[1],
        shape=(header.height, header.width),
        fingerprint=ntex.file_fingerprint(ntex_path),
        wrap_s=wrap[0], wrap_t=wrap[1],
        blocks_loader=lambda p=ntex_path: ntex.read_blocks_file(p)[1],
    )


def _material_params(gltf: dict, mat: dict, images: list[Texture],
                     check_tex_coord: bool) -> PbrMaterialParameters:
    """PbrMaterialParameters of one glTF material (pending_gltf.rs:146-218)."""
    pbr = mat.get("pbrMetallicRoughness")
    if pbr is None:
        if check_tex_coord:
            raise GltfLoadingError("material missing pbrMetallicRoughness")
        pbr = {}

    def tex_for(tex_info) -> Texture | None:
        if tex_info is None:
            return None
        if check_tex_coord and tex_info.get("texCoord", 0) != 0:
            raise GltfLoadingError("non-0 texCoord used for texture")
        source = gltf["textures"][tex_info["index"]].get("source")
        return None if source is None else images[source]

    raw_alpha = mat.get("alphaMode", "OPAQUE")
    try:
        alpha_mode = {
            "OPAQUE": AlphaMode.OPAQUE,
            "MASK": AlphaMode.ALPHA_TO_COVERAGE,
            "BLEND": AlphaMode.BLENDED,
        }[raw_alpha]
    except KeyError:
        raise GltfLoadingError(
            f"material {mat.get('name', '?')!r}: unknown alphaMode {raw_alpha!r}"
        ) from None
    return PbrMaterialParameters(
        base_color=tex_for(pbr.get("baseColorTexture")),
        metallic_roughness=tex_for(pbr.get("metallicRoughnessTexture")),
        normal=tex_for(mat.get("normalTexture")),
        occlusion=tex_for(mat.get("occlusionTexture")),
        emissive=tex_for(mat.get("emissiveTexture")),
        base_color_factor=tuple(pbr.get("baseColorFactor", (1, 1, 1, 1))),
        emissive_factor=tuple(mat.get("emissiveFactor", (0, 0, 0))),
        occlusion_factor=(mat.get("occlusionTexture") or {}).get("strength", 1.0),
        roughness_factor=pbr.get("roughnessFactor", 1.0),
        metallic_factor=pbr.get("metallicFactor", 1.0),
        normal_strength=(mat.get("normalTexture") or {}).get("scale", 1.0),
        # cutoff forced to 0 unless MASK (pending_gltf.rs:193)
        alpha_cutoff=(mat.get("alphaCutoff", 0.5)
                      if alpha_mode == AlphaMode.ALPHA_TO_COVERAGE else 0.0),
        alpha_mode=alpha_mode,
    )


def load_gltf(
    path: str | Path,
    builder: VertexLibraryBuilder,
    registry: MaterialRegistry,
    *,
    device="cuda",
) -> Gltf:
    """Load a .gltf or .glb file: meshes into `builder`, textures+materials
    into `registry`. The lazy ntex textures decode on `device` (the card
    unless the caller asks for the CPU) when the atlas needs them."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:4] == b"glTF":
        gltf, bin_buffer = _parse_glb(raw)
    else:
        gltf, bin_buffer = json.loads(raw), None
    resource_dir = path.parent

    version = gltf.get("asset", {}).get("version", "2.0")
    try:
        if not (2.0 <= float(version) < 3.0):
            raise GltfLoadingError(f"unsupported glTF version {version}")
    except ValueError:
        pass  # assume 2.0 (lib.rs:315-317)

    out = Gltf()
    acc = _Accessors(gltf, resource_dir, bin_buffer)

    # -- scene / nodes ----------------------------------------------------
    scene_index = gltf.get("scene")
    if scene_index is None:
        raise GltfLoadingError("gltf does not have a scene")
    out.root_nodes = list(gltf["scenes"][scene_index].get("nodes") or [])
    if not out.root_nodes:
        raise GltfLoadingError("no nodes in scene")
    _parse_nodes(gltf, out)

    # cycle check (lib.rs:553-566)
    visited = [False] * len(out.nodes)
    stack = list(out.root_nodes)
    while stack:
        n = stack.pop()
        if visited[n]:
            raise GltfLoadingError("invalid node graph (cycle or shared child)")
        visited[n] = True
        stack.extend(out.nodes[n].children)
    _flatten_transforms(out)

    # -- images / textures --------------------------------------------------
    kinds = _texture_kinds(gltf)
    image_wrap = _image_wrap_modes(gltf)
    images: list[Texture] = []
    for i, image in enumerate(gltf.get("images", [])):
        uri = image.get("uri")
        kind = kinds.get(i, TextureKind.LINEAR_COLOR)
        wrap_s, wrap_t = image_wrap.get(i, (0, 0))
        if uri is not None:
            # image URIs are retargeted to .ntex (lib.rs:400-401)
            tex = ntex_texture((resource_dir / uri).with_suffix(".ntex"), kind,
                               (wrap_s, wrap_t), device, name=uri)
        elif "bufferView" in image:
            # embedded image (e.g. testbox.glb): decode + generate a mip
            # chain (the reference requires ntex uris, lib.rs:396-398; this
            # is a superset for self-contained glbs)
            view = gltf["bufferViews"][image["bufferView"]]
            data = acc._buffer(view["buffer"])
            start = view.get("byteOffset", 0)
            try:
                rgba = decode_image(data[start : start + view["byteLength"]])
            except ValueError as e:
                raise GltfLoadingError(f"embedded image {i}: {e}") from e
            mips = generate_mips(rgba)
            tex = Texture(mips, kind, name=image.get("name", f"embedded-{i}"),
                          wrap_s=wrap_s, wrap_t=wrap_t)
        else:
            raise GltfLoadingError("image missing an uri")
        registry.register_texture(tex)
        images.append(tex)
    out.textures = images

    # -- materials ----------------------------------------------------------
    for mat in gltf.get("materials", []):
        params = _material_params(gltf, mat, images, check_tex_coord=True)
        out.materials.append(
            registry.create_material(mat.get("name", "unnamed material"), params)
        )

    # -- meshes ---------------------------------------------------------------
    for mesh in gltf.get("meshes", []):
        primitives = []
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            if "indices" not in prim:
                raise GltfLoadingError("primitive missing indices")
            ict = gltf["accessors"][prim["indices"]]["componentType"]
            if ict not in (GLTF_UNSIGNED_SHORT, GLTF_UNSIGNED_INT):
                raise GltfLoadingError("index ctype must be u16 or u32")
            indices = acc.read(prim["indices"], ict, "SCALAR")

            def req(name, atype):
                if name not in attrs:
                    raise GltfLoadingError(f"missing {name} attributes")
                return acc.read(attrs[name], GLTF_FLOAT, atype)

            positions = req("POSITION", "VEC3")
            uvs = req("TEXCOORD_0", "VEC2")
            normals = req("NORMAL", "VEC3")
            tangents = req("TANGENT", "VEC4")
            joints = weights = None
            if "JOINTS_0" in attrs and "WEIGHTS_0" in attrs:
                joints = acc.read(attrs["JOINTS_0"], GLTF_UNSIGNED_BYTE, "VEC4")
                weights = acc.read(attrs["WEIGHTS_0"], GLTF_FLOAT, "VEC4")

            # morph targets (POSITION/NORMAL delta accessors) — the
            # reference leaves morph support as a todo!() (lib.rs:229)
            morph_targets = None
            targets = prim.get("targets")
            if targets:
                if len(targets) > constants.MAX_MORPH_TARGETS:
                    raise GltfLoadingError(
                        f"primitive has {len(targets)} morph targets; the "
                        f"capacity is {constants.MAX_MORPH_TARGETS} "
                        "(constants.MAX_MORPH_TARGETS)"
                    )
                morph_targets = []
                for tgt in targets:
                    if "POSITION" not in tgt:
                        raise GltfLoadingError("morph target missing POSITION deltas")
                    pd = acc.read(tgt["POSITION"], GLTF_FLOAT, "VEC3")
                    nd = (acc.read(tgt["NORMAL"], GLTF_FLOAT, "VEC3")
                          if "NORMAL" in tgt else None)
                    morph_targets.append((pd, nd))

            lib_mesh = builder.add_mesh(
                positions, uvs, normals, tangents, indices.reshape(-1),
                joints=joints, weights=weights, morph_targets=morph_targets,
            )
            if "material" not in prim:
                raise GltfLoadingError("primitive missing material")
            primitives.append((lib_mesh, out.materials[prim["material"]]))
        out.meshes.append(primitives)
        mw = mesh.get("weights")
        out.mesh_weights.append(None if mw is None else np.asarray(mw, np.float32))

    # -- animations ------------------------------------------------------------
    for anim in gltf.get("animations", []):
        out.animations.append(_parse_animation(gltf, acc, anim, len(out.nodes)))

    # -- skins -------------------------------------------------------------------
    for skin in gltf.get("skins", []):
        joint_nodes = skin["joints"]
        if "inverseBindMatrices" in skin:
            ibms = acc.read(skin["inverseBindMatrices"], GLTF_FLOAT, "MAT4")
            if ibms.shape[0] != len(joint_nodes):
                raise GltfLoadingError("joint/inverse-bind-matrix count mismatch")
            joints = [Joint(n, ibms[i].reshape(4, 4).T.copy())  # column-major
                      for i, n in enumerate(joint_nodes)]
        else:
            joints = [Joint(n, np.eye(4, dtype=np.float32)) for n in joint_nodes]
        out.skins.append(Skin(joints))

    for node in out.nodes:
        if node.skin is not None and node.skin >= len(out.skins):
            raise GltfLoadingError("node has an out-of-bounds skin index")
    return out


def _parse_animation(gltf: dict, acc: _Accessors, anim: dict,
                     n_nodes: int) -> Animation:
    nodes_channels: list[list[AnimationChannel] | None] = [None] * n_nodes
    start_time = end_time = None
    for ch in anim.get("channels", []):
        sampler = anim["samplers"][ch["sampler"]]
        target = ch["target"]
        if "node" not in target:
            continue
        times = acc.read(sampler["input"], GLTF_FLOAT, "SCALAR").reshape(-1)
        in_acc = gltf["accessors"][sampler["input"]]
        if in_acc.get("min"):
            m = in_acc["min"][0]
            start_time = m if start_time is None else min(start_time, m)
        if in_acc.get("max"):
            m = in_acc["max"][0]
            end_time = m if end_time is None else max(end_time, m)
        path = target["path"]
        out_ctype = gltf["accessors"][sampler["output"]]["componentType"]
        if path in ("translation", "scale"):
            values = acc.read(sampler["output"], GLTF_FLOAT, "VEC3")
        elif path == "rotation":
            values = _dequantize_anim(
                acc.read(sampler["output"], None, "VEC4"), out_ctype)
        else:  # weights
            values = _dequantize_anim(
                acc.read(sampler["output"], None, "SCALAR"), out_ctype)
        interp = sampler.get("interpolation", "LINEAR")
        if interp not in ("LINEAR", "STEP", "CUBICSPLINE"):
            raise GltfLoadingError(f"unsupported animation interpolation {interp!r}")
        in_tan = out_tan = None
        if interp == "CUBICSPLINE":
            # the output accessor holds (in-tangent, value, out-tangent)
            # triples per keyframe (glTF spec §3.8.2.2); split them. A
            # superset of the reference (gltf_json.rs:235-236)
            k = len(times)
            arr = np.asarray(values, np.float32)
            if k == 0 or arr.size % (3 * k):
                raise GltfLoadingError(
                    "CUBICSPLINE output accessor must hold 3 elements per keyframe"
                )
            arr = arr.reshape(k, 3, -1)
            in_tan = np.ascontiguousarray(arr[:, 0])
            values = np.ascontiguousarray(arr[:, 1])
            out_tan = np.ascontiguousarray(arr[:, 2])
        elif path == "weights":
            # T weights per keyframe ride flat in the SCALAR accessor
            if len(times) == 0 or values.size % len(times):
                raise GltfLoadingError(
                    "weights output accessor count must be a multiple "
                    "of the keyframe count"
                )
            values = values.reshape(len(times), -1)
        lst = nodes_channels[target["node"]]
        if lst is None:
            lst = nodes_channels[target["node"]] = []
        lst.append(AnimationChannel(
            interpolation=interp, path=path, times=times, values=values,
            in_tangents=in_tan, out_tangents=out_tan,
        ))
    if start_time is None or end_time is None:
        raise GltfLoadingError("animation channel input accessor must have min/max")
    return Animation(anim.get("name"), float(start_time), float(end_time),
                     nodes_channels)
