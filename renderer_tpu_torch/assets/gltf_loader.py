"""glTF runtime: nodes, skins and animations of a loaded model, and their
queueing into a Scene with joint palettes.

Parity: the gltf crate (reference: gltf/src/lib.rs, gltf_json.rs,
scene_queueing.rs, mesh_iter.rs). Behavior highlights kept:

- Node transforms are parent-flattened into every node at load time
  (lib.rs:569-577). Animated transforms start from the flattened transform,
  decompose to TRS, and replace animated channels (lib.rs:199-230) — quirks
  included.
- Animation sampling: LINEAR lerp/slerp, STEP; clamp before the first
  keyframe, *error* after the last (gltf_json.rs:238-286) — callers wrap
  time by the animation's end_time.
- Skins: joint = animated_node_transform @ inverse_bind_matrix
  (scene_queueing.rs:38-45).

The file parser (.gltf/.glb, ntex textures) is not part of this module yet;
models are built in code (assets/proxy.make_skinned_character). Pose
evaluation runs the vectorized numpy sampler.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.geometry.vertex_library import Mesh
from renderer_tpu_torch.materials.registry import Material, Texture
from renderer_tpu_torch.scene.scene import Scene


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

    def invalidate_caches(self) -> None:
        """Drop every derived cache: compiled animations (with their baked
        static TRS decomposes), the hierarchy walk arrays, and the
        queue-order row split.

        The fast paths snapshot `Node.transform` (and the node graph) at
        first use; nodes are treated as IMMUTABLE afterwards — mutate a node
        transform, reparent nodes, or edit animation channels only if you
        call this afterwards, or subsequent frames serve stale poses that
        diverge from the sequential oracle path."""
        self._walk = None
        self._walk_valid = None
        self._walk_all_valid = None
        self._rows_cache = None
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
            from renderer_tpu_torch.core import constants as _c
            from renderer_tpu_torch.scene.scene import make_draw_block

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
                    (len(static_items), _c.MAX_MORPH_TARGETS), np.float32
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
        # identical layering, vectorized per animation
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
