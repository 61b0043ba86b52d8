"""The port's twin of tests/test_alpha_modes.py: its CPU path held to the same
oracles and invariants.

Alpha-mode behavior: masked (alpha-to-coverage) and blended pipelines,
cross-checked against hand-computed expectations on tiny scenes."""

import numpy as np
import pytest

from tests.torch_parity import cpu_renderer  # (and one torch thread a worker)
import renderer_tpu_torch as rt
from renderer_tpu_torch.core import math3d
from tests import np_reference

W, H = 128, 96


def quad(builder, z, half=0.6):
    positions = np.array(
        [[-half, half, z], [half, half, z], [-half, -half, z], [half, -half, z]],
        np.float32,
    )
    uvs = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    normals = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
    tangents = np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32)
    # front-facing winding for the default camera (see triangle example)
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint32)
    return builder.add_mesh(positions, uvs, normals, tangents, indices)


@pytest.fixture(scope="module")
def renderer_and_assets():
    registry = rt.MaterialRegistry()
    builder = rt.VertexLibraryBuilder()
    mesh_far = quad(builder, 2.0)
    mesh_near = quad(builder, 1.5, half=0.3)
    builder.build()
    renderer = cpu_renderer(registry, rt.RenderConfig(width=W, height=H))
    return registry, renderer, mesh_far, mesh_near


def render(renderer, scene, mode=1):
    return renderer.render_frame(scene, debug_mode=mode)


def expected_u8(rgb):
    return np_reference.aces_srgb_u8(np.asarray(rgb, np.float64))


class TestBlended:
    def test_src_alpha_blend_over_opaque(self, renderer_and_assets):
        registry, renderer, mesh_far, mesh_near = renderer_and_assets
        red = registry.create_material(
            "red", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        blue_half = registry.create_material(
            "blue50",
            rt.PbrMaterialParameters(
                base_color_factor=(0, 0, 1, 0.5), alpha_mode=rt.AlphaMode.BLENDED
            ),
        )
        scene = rt.Scene()
        scene.queue_mesh(mesh_far, red, None, math3d.IDENTITY)
        scene.queue_mesh(mesh_near, blue_half, None, math3d.IDENTITY)
        img = render(renderer, scene)
        center = img[H // 2, W // 2]
        # base-color mode: hdr = red*(1-.5) + blue*.5 = (0.5, 0, 0.5)
        np.testing.assert_allclose(
            center, expected_u8([0.5, 0, 0.5]), atol=2,
            err_msg=f"got {center}",
        )
        # inside the big red quad but outside the small blended one: pure red
        edge = img[H // 2, 46]
        np.testing.assert_allclose(edge, expected_u8([1, 0, 0]), atol=2)

    def test_blended_behind_opaque_is_hidden(self, renderer_and_assets):
        registry, renderer, mesh_far, mesh_near = renderer_and_assets
        green = registry.create_material(
            "green", rt.PbrMaterialParameters(base_color_factor=(0, 1, 0, 1))
        )
        blue_half = registry.create_material(
            "blue50b",
            rt.PbrMaterialParameters(
                base_color_factor=(0, 0, 1, 0.5), alpha_mode=rt.AlphaMode.BLENDED
            ),
        )
        scene = rt.Scene()
        # opaque NEAR, blended FAR → blended must be depth-rejected
        scene.queue_mesh(mesh_near, blue_half, None,
                         math3d.trs(translation=np.array([0, 0, 0.5], np.float32)))
        scene.queue_mesh(mesh_far, green, None,
                         math3d.trs(translation=np.array([0, 0, -0.7], np.float32)))
        img = render(renderer, scene)
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(center, expected_u8([0, 1, 0]), atol=2)

    def test_two_blended_layers_compose_in_order(self, renderer_and_assets):
        registry, renderer, mesh_far, mesh_near = renderer_and_assets
        red = registry.create_material(
            "redO", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        g_half = registry.create_material(
            "g50", rt.PbrMaterialParameters(
                base_color_factor=(0, 1, 0, 0.5), alpha_mode=rt.AlphaMode.BLENDED)
        )
        b_half = registry.create_material(
            "b50", rt.PbrMaterialParameters(
                base_color_factor=(0, 0, 1, 0.5), alpha_mode=rt.AlphaMode.BLENDED)
        )
        scene = rt.Scene()
        scene.queue_mesh(mesh_far, red, None, math3d.IDENTITY)
        # far blended green (z≈1.8), near blended blue (z=1.5): both accepted,
        # blend order far→near: ((red·.5+g·.5)·.5 + b·.5)
        scene.queue_mesh(mesh_near, g_half, None,
                         math3d.trs(translation=np.array([0, 0, 0.3], np.float32)))
        scene.queue_mesh(mesh_near, b_half, None, math3d.IDENTITY)
        img = render(renderer, scene)
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(
            center, expected_u8([0.25, 0.25, 0.5]), atol=2, err_msg=f"{center}"
        )


class TestMasked:
    def test_cutout_shows_background(self, renderer_and_assets):
        registry, renderer, mesh_far, mesh_near = renderer_and_assets
        red = registry.create_material(
            "redM", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        # masked material with factor alpha below its cutoff → fully discarded
        ghost = registry.create_material(
            "ghost",
            rt.PbrMaterialParameters(
                base_color_factor=(1, 1, 1, 0.3), alpha_cutoff=0.5,
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
            ),
        )
        scene = rt.Scene()
        scene.queue_mesh(mesh_far, red, None, math3d.IDENTITY)
        scene.queue_mesh(mesh_near, ghost, None, math3d.IDENTITY)
        img = render(renderer, scene)
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(center, expected_u8([1, 0, 0]), atol=2)

    def test_passing_masked_occludes(self, renderer_and_assets):
        registry, renderer, mesh_far, mesh_near = renderer_and_assets
        red = registry.create_material(
            "redM2", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        solid_masked = registry.create_material(
            "leaf",
            rt.PbrMaterialParameters(
                base_color_factor=(0, 1, 0, 0.9), alpha_cutoff=0.5,
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
            ),
        )
        scene = rt.Scene()
        scene.queue_mesh(mesh_far, red, None, math3d.IDENTITY)
        scene.queue_mesh(mesh_near, solid_masked, None, math3d.IDENTITY)
        img = render(renderer, scene)
        center = img[H // 2, W // 2]
        # base-color debug mode shows base_color as-is (alpha in the factor
        # does not premultiply rgb)
        np.testing.assert_allclose(center, expected_u8([0, 1, 0]), atol=2)

    def test_nearest_passing_of_stacked_masked(self, renderer_and_assets):
        registry, renderer, mesh_far, mesh_near = renderer_and_assets
        fail_near = registry.create_material(
            "failN",
            rt.PbrMaterialParameters(
                base_color_factor=(1, 1, 1, 0.2), alpha_cutoff=0.5,
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
            ),
        )
        pass_far = registry.create_material(
            "passF",
            rt.PbrMaterialParameters(
                base_color_factor=(0, 1, 1, 1.0), alpha_cutoff=0.5,
                alpha_mode=rt.AlphaMode.ALPHA_TO_COVERAGE,
            ),
        )
        red = registry.create_material(
            "redM3", rt.PbrMaterialParameters(base_color_factor=(1, 0, 0, 1))
        )
        scene = rt.Scene()
        scene.queue_mesh(mesh_far, red, None, math3d.IDENTITY)
        # failing masked in front of passing masked → passing one shows
        scene.queue_mesh(mesh_near, fail_near, None, math3d.IDENTITY)
        scene.queue_mesh(mesh_near, pass_far, None,
                         math3d.trs(translation=np.array([0, 0, 0.2], np.float32)))
        img = render(renderer, scene)
        center = img[H // 2, W // 2]
        np.testing.assert_allclose(center, expected_u8([0, 1, 1]), atol=2)
