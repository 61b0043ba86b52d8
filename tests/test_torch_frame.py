"""Whole frames through the port's Renderer on the CPU (plain versions of
the kernels): the golden images of tests/golden/goldens.npz, and the static
mini-sandbox at 4×MSAA against the JAX package's frame of the same scene.

Tolerance: the golden suite's own — at most 0.5% of pixels more than 2 u8
steps off (tests/test_golden.py); the stats vectors must be equal."""

from pathlib import Path

import numpy as np
import pytest

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from renderer_tpu_torch.assets import demo_scenes
from tests.torch_parity import build_scene

GOLDEN = Path(__file__).parent / "golden" / "goldens.npz"
W, H = 160, 96


def _assert_golden_close(got, expected, what):
    assert got.shape == expected.shape and got.dtype == np.uint8, what
    diff = np.abs(got.astype(int) - expected.astype(int)).max(axis=-1)
    bad = (diff > 2).mean()
    assert bad < 0.005, f"{what}: {bad:.2%} of pixels drifted (max {diff.max()})"


@pytest.fixture(scope="module")
def triangle_renderers():
    registry, scene = demo_scenes.triangle_scene()
    return (scene,
            trt.Renderer(registry, trt.RenderConfig(width=W, height=H),
                         device="cpu"),
            trt.Renderer(registry, trt.RenderConfig(width=W, height=H,
                                                    msaa_samples=4),
                         device="cpu"))


@pytest.mark.parametrize("name", [
    "triangle-mode0", "triangle-mode1", "triangle-mode2", "triangle-mode3",
    "triangle-mode4", "triangle-mode6", "triangle-msaa4",
])
def test_triangle_goldens(triangle_renderers, name):
    scene, r1, r4 = triangle_renderers
    if name == "triangle-msaa4":
        img = r4.render_frame(scene, 3)
    else:
        img = r1.render_frame(scene, int(name[-1]))
    _assert_golden_close(img, np.load(GOLDEN)[name], name)


def test_alpha_layers_golden():
    registry, scene = demo_scenes.alpha_layers_scene()
    r = trt.Renderer(registry, trt.RenderConfig(width=W, height=H), device="cpu")
    img = r.render_frame(scene, 1)
    _assert_golden_close(img, np.load(GOLDEN)["alpha-layers"], "alpha-layers")
    stats = r.frame_stats()
    assert stats["masked_demand_max"] >= 1 and stats["blended_demand_max"] >= 1


def test_static_sandbox_matches_jax():
    """All three alpha classes, the checker atlas with mips, per-tap sRGB +
    aniso16, 4×MSAA with candidate-deduped shading: the port's frame and
    stats against the JAX package's (Pallas interpret mode)."""
    reg_j, scene_j, cfg_j = build_scene("renderer_tpu", "sandbox-static")
    rj = jrt.Renderer(reg_j, cfg_j, overflow_policy="off")
    img_j = rj.render_frame(scene_j)
    reg_t, scene_t = demo_scenes.patch_ring_scene()
    rt_ = trt.Renderer(reg_t, trt.RenderConfig(width=W, height=H, msaa_samples=4),
                       overflow_policy="off", device="cpu")
    img_t = rt_.render_frame(scene_t)
    _assert_golden_close(img_t, img_j, "sandbox-static")
    assert rt_.frame_stats() == rj.frame_stats()
    assert img_t.std() > 10  # not blank


def test_cuda_device_requested_without_cuda_raises(monkeypatch):
    """No quiet fallback: a CUDA renderer on a machine without CUDA raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    registry, _ = demo_scenes.triangle_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.Renderer(registry, device="cuda")


def test_renderer_defaults_to_the_card(monkeypatch):
    """With no device the Renderer asks for CUDA: without it, it raises
    rather than running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    registry, _ = demo_scenes.triangle_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.Renderer(registry)
