"""The port's twin of tests/test_layer_feedback.py: its CPU path held to the same
oracles and invariants.

Runtime right-sizing of the layered-capture capacities
(mask_layers / blend_layers / ui_layers) from the per-frame demand stats —
the convergence path toward the reference's UNBOUNDED fixed-function
src-alpha blending (reference: renderer/src/renderer/pipelines.rs:112-132):
a K-layer capture that truncates grows toward the measured peak per-pixel
fragment demand under the Renderer's "auto"/"sync" overflow policies, and
shrinks back to the configured floor with streak hysteresis (the same
measure-then-allocate feedback discipline as the binning pair bucket,
arena/buffers.rs analog)."""

import numpy as np

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import math3d
from renderer_tpu_torch.ui import DrawList
from tests.test_torch_alpha_modes import quad

W, H = 128, 96


def _stacked_blended(n=6):
    """Opaque background + n stacked translucent quads queued far → near so
    the ordered-accept chain takes every one: per-pixel blended demand = n."""
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    mesh = quad(builder, 1.5, half=0.4)
    bg = quad(builder, 2.2)
    builder.build()
    red = registry.create_material(
        "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
    )
    mats = [
        registry.create_material(
            f"l{i}",
            rt.PbrMaterialParameters(
                base_color_factor=(i / n, 1.0 - i / n, 0.5, 0.5),
                alpha_mode=rt.AlphaMode.BLENDED,
            ),
        )
        for i in range(n)
    ]
    scene = rt.Scene()
    scene.queue_mesh(bg, red, None, math3d.IDENTITY)
    # spacing keeps the WHOLE stack in front of the opaque bg quad (z=2.2)
    # for any n, so every layer passes the depth floor: demand = n
    for i, mat in enumerate(mats):
        dz = np.array([0, 0, (0.5 / n) * (n - 1 - i)], np.float32)
        scene.queue_mesh(mesh, mat, None, math3d.trs(translation=dz))
    return registry, scene, (red, mats)


class TestBlendedGrowth:
    def test_sync_policy_grows_to_demand_and_matches_ample(self):
        registry, scene, _keep = _stacked_blended(n=6)
        r = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=2),
            overflow_policy="sync",
        )
        img = r.render_frame(scene, debug_mode=1)
        # demand 6 → next pow-2 bucket 8
        assert r.config.blend_layers == 8, r.config.blend_layers
        stats = r.frame_stats()
        assert stats["blended_demand_max"] == 6, stats
        assert stats["blended_saturated_px"] == 0, stats

        ample = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=8)
        )
        np.testing.assert_array_equal(img, ample.render_frame(scene, 1))

    def test_auto_policy_grows_on_next_frame(self):
        registry, scene, _keep = _stacked_blended(n=6)
        r = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=2),
            overflow_policy="auto",
        )
        r.render_frame(scene, debug_mode=1)  # truncates (demand in stats)
        assert r.config.blend_layers == 2
        r.render_frame(scene, debug_mode=1)  # sees frame 1's stats → grows
        assert r.config.blend_layers == 8
        img3 = r.render_frame(scene, debug_mode=1)  # rendered at grown K
        ample = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=8)
        )
        np.testing.assert_array_equal(img3, ample.render_frame(scene, 1))

    def test_shrinks_back_to_floor_after_streak(self):
        registry, heavy, _keep = _stacked_blended(n=6)
        r = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=2),
            overflow_policy="sync", shrink_after=2,
        )
        r.render_frame(heavy, debug_mode=1)
        assert r.config.blend_layers == 8
        # a scene with no blended geometry: demand 0 for two consecutive
        # frames → shrink back to the configured floor (2), never below it
        empty = rt.Scene()
        for _ in range(3):
            r.render_frame(empty, debug_mode=1)
        assert r.config.blend_layers == 2, r.config.blend_layers


class TestMaskedGrowth:
    def test_growth_recovers_dropped_passing_fragment(self):
        """The nearest masked candidate FAILS its alpha cutoff and the true
        passer sits behind it: a 1-layer capture drops the passer (shows the
        background), growth to the demand restores it — truncation here is
        not just under-blending, so the feedback is correctness-restoring."""
        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        mesh = quad(builder, 1.5, half=0.4)
        bg = quad(builder, 2.2)
        builder.build()
        red = registry.create_material(
            "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        fail_near = registry.create_material(
            "fail",
            rt.PbrMaterialParameters(
                base_color_factor=(0, 0, 1, 0.25), alpha_cutoff=0.5,
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
            ),
        )
        pass_far = registry.create_material(
            "pass",
            rt.PbrMaterialParameters(
                base_color_factor=(0, 1, 0, 1.0), alpha_cutoff=0.5,
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
            ),
        )
        scene = rt.Scene()
        scene.queue_mesh(bg, red, None, math3d.IDENTITY)
        scene.queue_mesh(
            mesh, pass_far, None,
            math3d.trs(translation=np.array([0, 0, 0.3], np.float32)),
        )
        scene.queue_mesh(mesh, fail_near, None, math3d.IDENTITY)

        r = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, mask_layers=1),
            overflow_policy="sync",
        )
        img = r.render_frame(scene, debug_mode=1)
        assert r.config.mask_layers == 2, r.config.mask_layers
        stats = r.frame_stats()
        assert stats["masked_demand_max"] == 2, stats
        ample = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, mask_layers=2)
        )
        ref = ample.render_frame(scene, 1)
        np.testing.assert_array_equal(img, ref)
        # and the passer is actually visible (green, not the red background)
        center = ref[H // 2, W // 2]
        assert center[1] > center[0], center


class TestUiGrowth:
    def test_overlapping_ui_grows_ui_layers(self):
        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        bg = quad(builder, 2.0)
        builder.build()
        red = registry.create_material(
            "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        scene = rt.Scene()
        scene.queue_mesh(bg, red, None, math3d.IDENTITY)

        def ui():
            d = DrawList()
            for i in range(6):
                d.add_rect_filled((32, 24), (96, 72), (0, 0, 255, 40))
            return d

        r = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, ui_layers=2),
            overflow_policy="sync",
        )
        img = r.render_frame(scene, debug_mode=1, ui=ui())
        assert r.config.ui_layers == 8, r.config.ui_layers
        assert r.frame_stats()["ui_demand_max"] == 6
        ample = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, ui_layers=8)
        )
        np.testing.assert_array_equal(
            img, ample.render_frame(scene, 1, ui=ui())
        )


def _pinwheel_scene():
    """Four opaque triangles fanned around one point, each with its own face
    normal (separate vertices): pixels at the hub straddle several distinct
    solid triangles across their MSAA samples, and debug mode 3 (normals)
    gives each triangle a distinct color so candidate-set starvation is
    visible in the image."""
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    z, r = 1.5, 0.5
    hub = [0.0, 0.0, z]
    # ring on the DIAGONALS so the fan's interior edges are diagonal in
    # screen space and cross pixel interiors (axis-aligned edges through
    # pixel boundaries would never split a pixel's sample set)
    ring = [[r, r, z], [r, -r, z], [-r, -r, z], [-r, r, z]]
    # clockwise in world (y-up) = front-facing for the default camera, same
    # winding as tests.test_alpha_modes.quad
    corners = [(ring[0], ring[1]), (ring[1], ring[2]),
               (ring[2], ring[3]), (ring[3], ring[0])]
    face_normals = [[0, 0, -1], [1, 0, 0], [0, 1, 0], [0, 0.6, -0.8]]
    pos, nrm = [], []
    for (a, b), n in zip(corners, face_normals):
        pos += [hub, a, b]
        nrm += [n, n, n]
    pos = np.asarray(pos, np.float32)
    nrm = np.asarray(nrm, np.float32)
    uvs = np.zeros((12, 2), np.float32)
    tangents = np.tile([1, 0, 0, 1.0], (12, 1)).astype(np.float32)
    idx = np.arange(12, dtype=np.uint32)
    mesh = builder.add_mesh(pos, uvs, nrm, tangents, idx)
    builder.build()
    mat = registry.create_material(
        "white", rt.PbrMaterialParameters(base_color_factor=(1, 1, 1, 1))
    )
    scene = rt.Scene()
    scene.queue_mesh(mesh, mat, None, math3d.IDENTITY)
    return registry, scene, (mesh, mat)


class TestShadeCandidatesGrowth:
    def test_sync_growth_restores_exact_msaa_dedup(self):
        registry, scene, _keep = _pinwheel_scene()
        r = cpu_renderer(
            registry,
            rt.RenderConfig(width=W, height=H, msaa_samples=4,
                            msaa_shade_candidates=1),
            overflow_policy="sync",
        )
        img = r.render_frame(scene, debug_mode=3)
        stats = r.frame_stats()
        assert stats["shade_demand_max"] >= 2, stats
        assert r.config.msaa_shade_candidates == stats["shade_demand_max"]
        assert stats["shade_clamped_px"] == 0, stats
        ample = cpu_renderer(
            registry,
            rt.RenderConfig(width=W, height=H, msaa_samples=4,
                            msaa_shade_candidates=4),
        )
        np.testing.assert_array_equal(img, ample.render_frame(scene, 3))

    def test_shrinks_back_when_demand_drops(self):
        registry, scene, _keep = _pinwheel_scene()
        r = cpu_renderer(
            registry,
            rt.RenderConfig(width=W, height=H, msaa_samples=4,
                            msaa_shade_candidates=1),
            overflow_policy="sync", shrink_after=2,
        )
        r.render_frame(scene, debug_mode=3)
        assert r.config.msaa_shade_candidates >= 2
        empty = rt.Scene()
        for _ in range(3):
            r.render_frame(empty, debug_mode=3)
        assert r.config.msaa_shade_candidates == 1


class TestGrowthCap:
    def test_pathological_stack_caps_loudly(self):
        """A stack deeper than the growth ceiling grows TO the ceiling and
        reports the remaining truncation instead of looping (max_layers
        lowered here so the test doesn't compile a 16-layer pipeline;
        the default ceiling is renderer.MAX_LAYERS = 16)."""
        registry, scene, _keep = _stacked_blended(n=6)
        r = cpu_renderer(
            registry, rt.RenderConfig(width=W, height=H, blend_layers=2),
            overflow_policy="sync", max_layers=4,
        )
        r.render_frame(scene, debug_mode=1)
        assert r.config.blend_layers == 4
        stats = r.frame_stats()
        assert stats["blended_demand_max"] == 6
        assert stats["blended_saturated_px"] > 0
