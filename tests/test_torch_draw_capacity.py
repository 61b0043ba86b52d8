"""The port's twin of tests/test_draw_capacity.py: its CPU path held to the same
oracles and invariants.

Draw stream at its advertised capacity (MAX_DRAW_CALLS = 16384): the
vectorized SoA prologue (packed-key argsort + instance-merge detection +
frame-array packing) must match a slow per-draw Python oracle and stay in the
sub-millisecond range per frame, mirroring the reference's ~20 µs merge of
16,384 draws into indirect commands (renderer.rs:219-256)."""

import time

import numpy as np

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import constants, math3d
from renderer_tpu_torch.scene import draw_stream
from tests.test_torch_alpha_modes import quad


def _assets(n_meshes=4):
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    meshes = [quad(builder, 1.4 + 0.1 * i, half=0.05) for i in range(n_meshes)]
    builder.build()
    mats = [
        registry.create_material(
            f"m{i}",
            rt.PbrMaterialParameters(
                base_color_factor=(1, 1, 1, 1),
                alpha_mode=(rt.AlphaMode.BLENDED if i == 3 else rt.AlphaMode.OPAQUE),
            ),
        )
        for i in range(n_meshes)
    ]
    return registry, builder, meshes, mats


def _python_oracle(draws):
    """The round-1 per-draw Python implementation, kept as the oracle."""
    n = len(draws)
    material_id = np.zeros(n, np.int32)
    joints_offset = np.zeros(n, np.int32)
    skinned = np.zeros(n, np.int32)
    debug_id = np.zeros(n, np.int32)
    prev_merge_key = None
    group_first = 0
    for i, d in enumerate(draws):
        material_id[i] = d.material.id
        if d.joints_offset is not None:
            joints_offset[i] = d.joints_offset
            skinned[i] = 1
        key = d.merge_key()
        if key != prev_merge_key:
            group_first = i
            prev_merge_key = key
        debug_id[i] = group_first
    return material_id, joints_offset, skinned, debug_id


class TestVectorizedPrologue:
    def test_matches_python_oracle_on_mixed_scene(self):
        registry, _b, meshes, mats = _assets()
        rng = np.random.default_rng(7)
        scene = rt.Scene()
        for _ in range(300):
            i = int(rng.integers(len(meshes)))
            j = int(rng.integers(len(mats)))
            t = math3d.trs(translation=rng.normal(size=3).astype(np.float32) * 0.1)
            scene.queue_mesh(meshes[i], mats[j], None, t)

        arrays = draw_stream.build_frame_arrays(scene)

        draws_sorted = sorted(scene.draws, key=lambda d: d.sort_key())
        mat_o, joints_o, skin_o, debug_o = _python_oracle(draws_sorted)
        n = len(draws_sorted)
        np.testing.assert_array_equal(arrays["material_id"][:n], mat_o)
        np.testing.assert_array_equal(arrays["joints_offset"][:n], joints_o)
        np.testing.assert_array_equal(arrays["skinned"][:n], skin_o)
        np.testing.assert_array_equal(arrays["debug_id"][:n], debug_o)
        for i, d in enumerate(draws_sorted):
            np.testing.assert_array_equal(
                arrays["transforms"][i], d.transform[:3, :4]
            )

    def test_queue_instanced_equals_queue_mesh_loop(self):
        registry, _b, meshes, mats = _assets()
        rng = np.random.default_rng(3)
        transforms = np.stack(
            [math3d.trs(translation=rng.normal(size=3).astype(np.float32))
             for _ in range(17)]
        )
        s1 = rt.Scene()
        assert s1.queue_instanced(meshes[0], mats[0], transforms)
        s2 = rt.Scene()
        for t in transforms:
            s2.queue_mesh(meshes[0], mats[0], None, t)
        a1 = draw_stream.build_frame_arrays(s1)
        a2 = draw_stream.build_frame_arrays(s2)
        for k in ("transforms", "material_id", "debug_id", "skinned"):
            np.testing.assert_array_equal(a1[k], a2[k])

    def test_instanced_respects_draw_cap(self):
        registry, _b, meshes, mats = _assets()
        scene = rt.Scene()
        big = np.tile(np.eye(4, dtype=np.float32), (constants.MAX_DRAW_CALLS, 1, 1))
        assert scene.queue_instanced(meshes[0], mats[0], big)
        assert not scene.queue_mesh(meshes[0], mats[0], None, math3d.IDENTITY)
        assert not scene.queue_instanced(meshes[0], mats[0], big[:1])
        assert scene.draw_count == constants.MAX_DRAW_CALLS

    def test_instanced_partial_fills_like_queue_block(self):
        """One refusal contract across queueing paths (scene.rs:78-92
        per-draw refusal): at the cap, queue_instanced keeps the instances
        that fit and reports False — not all-or-nothing."""
        registry, _b, meshes, mats = _assets()
        scene = rt.Scene()
        head = np.tile(np.eye(4, dtype=np.float32),
                       (constants.MAX_DRAW_CALLS - 5, 1, 1))
        assert scene.queue_instanced(meshes[0], mats[0], head)
        tail = np.tile(np.eye(4, dtype=np.float32), (10, 1, 1))
        tail[:, 0, 3] = np.arange(10)
        assert not scene.queue_instanced(meshes[1], mats[1], tail)
        assert scene.draw_count == constants.MAX_DRAW_CALLS
        # the 5 that fit are the FIRST 5, in order
        kept = scene.draws[-5:]
        for i, d in enumerate(kept):
            assert d.mesh is meshes[1]
            assert d.transform[0, 3] == i


class TestCapacityScale:
    def test_16k_draw_prologue_is_fast_and_correct(self):
        registry, _b, meshes, mats = _assets()
        rng = np.random.default_rng(0)
        n_total = constants.MAX_DRAW_CALLS
        scene = rt.Scene()
        # 4 instanced groups → 4 merged commands, like the reference's
        # instance merge compressing the 16k stream
        per = n_total // len(meshes)
        for i, m in enumerate(meshes):
            transforms = np.tile(np.eye(4, dtype=np.float32), (per, 1, 1))
            transforms[:, 0, 3] = rng.uniform(-0.9, 0.9, per)
            transforms[:, 1, 3] = rng.uniform(-0.9, 0.9, per)
            assert scene.queue_instanced(m, mats[i], transforms)
        assert scene.draw_count == n_total

        proj_view = np.eye(4, dtype=np.float32)
        # warm up then time the full per-frame host prologue
        for _ in range(2):
            fv = draw_stream.frame_view(scene)
            draw_stream.pack_frame_arrays(fv, scene.joint_palette, proj_view,
                                          (0, 0, 0, 0))
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            fv = draw_stream.frame_view(scene)
            packed = draw_stream.pack_frame_arrays(
                fv, scene.joint_palette, proj_view, (0, 0, 0, 0)
            )
        dt_ms = (time.perf_counter() - t0) / iters * 1e3
        # native target ≲0.5 ms on any host; a per-draw Python loop is ≳30 ms
        assert dt_ms < 3.0, f"16k-draw prologue took {dt_ms:.2f} ms"

        # merge correctness at scale: 4 groups → exactly 4 distinct debug ids,
        # each the group's first sorted index
        n = scene.draw_count
        ids = np.unique(fv.pdi[:n, 3])
        assert len(ids) == len(meshes), ids
        np.testing.assert_array_equal(np.sort(ids), np.arange(4) * per)

    def test_16k_draws_render_end_to_end(self):
        registry, _b, meshes, mats = _assets(n_meshes=2)
        rng = np.random.default_rng(1)
        scene = rt.Scene()
        per = 8192
        for i, m in enumerate(meshes):
            transforms = np.tile(np.eye(4, dtype=np.float32), (per, 1, 1))
            transforms[:, 0, 3] = rng.uniform(-0.9, 0.9, per)
            transforms[:, 1, 3] = rng.uniform(-0.9, 0.9, per)
            assert scene.queue_instanced(m, mats[i], transforms)
        r = cpu_renderer(registry, rt.RenderConfig(width=128, height=64, tile_h=16),
                        overflow_policy="sync")
        img = r.render_frame(scene, debug_mode=1)
        assert r.frame_stats()["overflow_opaque"] == 0
        assert (img.sum(axis=-1) > 0).mean() > 0.2  # plenty of quads visible


def test_stress_field_shape_invariants():
    """make_stress_field must deliver exactly n x tris_per_mesh real
    (non-degenerate-by-construction) triangles with valid mesh-local
    indices."""
    import renderer_tpu_torch as rt
    from renderer_tpu_torch.assets import proxy

    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    meshes, mat = proxy.make_stress_field(builder, registry, n_meshes=4,
                                          tris_per_mesh=2048)
    # a non-square-exact request rounds DOWN to a grid-exact count instead
    # of zero-padding degenerate triangles (1000 → 2·22² = 968)
    r2 = rt.MaterialRegistry()
    b2 = rt.VertexLibraryBuilder()
    meshes2, _ = proxy.make_stress_field(b2, r2, n_meshes=1,
                                         tris_per_mesh=1000)
    lib2 = b2.build()
    assert meshes2[0].index_count == 968 * 3
    idx2 = lib2.indices[:meshes2[0].index_count].reshape(-1, 3)
    assert (idx2[:, 0] != idx2[:, 1]).all()

    lib = builder.build()
    assert len(meshes) == 4
    assert sum(m.index_count for m in meshes) == 4 * 2048 * 3
    for m in meshes:
        idx = lib.indices[m.first_index : m.first_index + m.index_count]
        assert idx.max() < m.vertex_count
        tris = idx.reshape(-1, 3)
        # grid triangulation: no padded degenerate (0,0,0) triangles
        assert (tris[:, 0] != tris[:, 1]).all()


class TestJointCapBucket:
    """The frame blob carries only a pow-2 joint-palette bucket sized from
    the scene's exact joint cursor (Renderer._joint_cap) — the full
    MAX_JOINT_COUNT palette is 48 KB of per-frame transfer, ~10× the rest
    of the blob for demo-scale skins. pack/unpack with the bucketed layout
    must be bit-identical to the full layout on every field."""

    def test_blob_roundtrip_bucketed_equals_full(self):
        import torch

        registry, _b, meshes, mats = _assets(n_meshes=2)
        scene = rt.Scene()
        off, pal = scene.allocate_joint_offset(52)
        rng = np.random.default_rng(7)
        pal[:] = rng.standard_normal(pal.shape).astype(np.float32)
        for i, m in enumerate(meshes):
            tr = np.eye(4, dtype=np.float32)
            tr[0, 3] = 0.1 * i
            assert scene.queue_mesh(m, mats[i], None, tr)
        fv = draw_stream.frame_view(scene)
        pv = rng.standard_normal((4, 4)).astype(np.float32)
        meta = (12, 8, 2, 0)

        jc = 64  # _next_pow2(52)
        blob_b = draw_stream.pack_frame_blob(fv, scene.joint_palette, pv,
                                             meta, joint_cap=jc)
        blob_f = draw_stream.pack_frame_blob(fv, scene.joint_palette, pv, meta)
        # the bucket saves (MAX_JOINT_COUNT - jc) * 12 i32 words per frame
        assert blob_f.size - blob_b.size == (constants.MAX_JOINT_COUNT - jc) * 12

        fb = draw_stream.unpack_frame({"blob": torch.from_numpy(blob_b)}, joint_cap=jc)
        ff = draw_stream.unpack_frame({"blob": torch.from_numpy(blob_f)})
        assert fb["joint_palette"].shape[0] == jc
        np.testing.assert_array_equal(
            np.asarray(fb["joint_palette"]),
            np.asarray(ff["joint_palette"])[:jc],
        )
        for k in ("transforms", "normal_mats", "material_id", "joints_offset",
                  "skinned", "debug_id", "proj_view"):
            np.testing.assert_array_equal(np.asarray(fb[k]), np.asarray(ff[k]))
        assert int(fb["num_tris"]) == int(ff["num_tris"]) == 12

    def test_renderer_bucket_covers_cursor(self):
        registry, _b, meshes, mats = _assets(n_meshes=1)
        r = cpu_renderer(registry, rt.RenderConfig(width=64, height=64))
        scene = rt.Scene()
        assert r._joint_cap(scene) == 8  # floor for skinless scenes
        scene.allocate_joint_offset(52)
        assert r._joint_cap(scene) == 64
        scene.allocate_joint_offset(constants.MAX_JOINT_COUNT - 52)
        assert r._joint_cap(scene) == constants.MAX_JOINT_COUNT


class TestFrameViewCache:
    """frame_view's steady-state sort/merge cache: an interactive loop
    re-queues an identical key stream every frame (the reference demo's
    shape, main.rs:549-583), so the sort + merge + pdi pack is reused and
    only transforms/morph weights re-pack. Content-keyed on the packed u64
    keys — which fully determine order, merge ids, and every pdi column —
    so a hit is provably equivalent to a rebuild; these tests pin that."""

    def _queue(self, scene, picks, transforms):
        _registry, _b, meshes, mats = self._assets
        for (i, j), t in zip(picks, transforms):
            scene.queue_mesh(meshes[i], mats[j], None, t)

    def _rand_transforms(self, rng, n):
        return [
            math3d.trs(translation=rng.normal(size=3).astype(np.float32))
            for _ in range(n)
        ]

    def test_requeue_same_stream_hits_and_matches_fresh_scene(self):
        self._assets = _assets()
        rng = np.random.default_rng(11)
        picks = [(int(rng.integers(4)), int(rng.integers(4)))
                 for _ in range(37)]

        scene = rt.Scene()
        self._queue(scene, picks, self._rand_transforms(rng, 37))
        fv1 = draw_stream.frame_view(scene)
        assert scene._fv_cache is not None

        t2 = self._rand_transforms(rng, 37)
        scene.clear()
        self._queue(scene, picks, t2)
        fv2 = draw_stream.frame_view(scene)
        # the hit reuses the cached sort/merge arrays outright
        assert fv2.order is fv1.order and fv2.pdi is fv1.pdi

        fresh = rt.Scene()
        self._queue(fresh, picks, t2)
        fv3 = draw_stream.frame_view(fresh)
        np.testing.assert_array_equal(fv2.order, fv3.order)
        np.testing.assert_array_equal(fv2.sorted_keys, fv3.sorted_keys)
        assert fv2.geom_key == fv3.geom_key
        np.testing.assert_array_equal(fv2.pdf, fv3.pdf)
        np.testing.assert_array_equal(fv2.pdi, fv3.pdi)

    def test_changed_stream_misses_and_stays_correct(self):
        self._assets = _assets()
        rng = np.random.default_rng(13)
        picks = [(int(rng.integers(4)), int(rng.integers(4)))
                 for _ in range(20)]
        scene = rt.Scene()
        self._queue(scene, picks, self._rand_transforms(rng, 20))
        draw_stream.frame_view(scene)

        # different stream: one extra draw + permuted mesh choices
        picks2 = list(reversed(picks)) + [(0, 3)]
        t2 = self._rand_transforms(rng, 21)
        scene.clear()
        self._queue(scene, picks2, t2)
        fv = draw_stream.frame_view(scene)

        fresh = rt.Scene()
        self._queue(fresh, picks2, t2)
        ref = draw_stream.frame_view(fresh)
        np.testing.assert_array_equal(fv.order, ref.order)
        np.testing.assert_array_equal(fv.pdf, ref.pdf)
        np.testing.assert_array_equal(fv.pdi, ref.pdi)
        assert fv.geom_key == ref.geom_key

    def test_morph_weights_repack_on_hit(self):
        self._assets = _assets()
        _registry, _b, meshes, mats = self._assets
        rng = np.random.default_rng(17)

        def queue_with_weights(scene, weights):
            for k, w in enumerate(weights):
                scene.queue_mesh(meshes[k % 4], mats[k % 4], None,
                                 math3d.IDENTITY, morph_weights=w)

        w1 = [rng.random(3).astype(np.float32) for _ in range(6)]
        scene = rt.Scene()
        queue_with_weights(scene, w1)
        draw_stream.frame_view(scene)

        w2 = [rng.random(3).astype(np.float32) for _ in range(6)]
        scene.clear()
        queue_with_weights(scene, w2)
        fv = draw_stream.frame_view(scene)

        fresh = rt.Scene()
        queue_with_weights(fresh, w2)
        ref = draw_stream.frame_view(fresh)
        assert fv.pmw is not None
        np.testing.assert_array_equal(fv.pmw, ref.pmw)
        np.testing.assert_array_equal(fv.pdf, ref.pdf)
