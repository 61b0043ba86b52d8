"""The port's skinned character and whole mini-sandbox frames on the CPU.

- Skinning: proxy.make_skinned_character + Gltf.queue_animated (the port's
  numpy pose sampler) against the JAX package's (which may take its native
  C++ sampler): the scene's joint palette, draw transforms and node
  transforms within 1e-6 relative (1e-7 absolute near 0) — the same f32/f64
  numpy arithmetic; the native sampler is pinned bit-compatible with it in
  the JAX package's own tests.
- Frames: the keys of tests/golden/sandbox-golden.npz rendered by the
  port's Renderer on the CPU (plain kernel versions) within the golden
  suite's tolerance — at most 0.5% of pixels more than 2 u8 steps off
  (tests/test_sandbox_golden.py) — with every overflow stat 0, and the
  default sampler within a mean of 8 u8 of fast_sampler() at 1×MSAA.
  The "Performance stats" key lives in tests/test_torch_ui.py.
"""

from pathlib import Path

import numpy as np
import pytest

import renderer_tpu as jrt
from renderer_tpu.assets import proxy as jproxy
from renderer_tpu.core import math3d as jmath
import renderer_tpu_torch as trt
from renderer_tpu_torch.assets import demo_scenes
from renderer_tpu_torch.assets import gltf_loader as tgltf
from renderer_tpu_torch.assets import proxy as tproxy
from renderer_tpu_torch.core import math3d as tmath
from tests.torch_parity import H, W

GOLDEN = Path(__file__).parent / "golden" / "sandbox-golden.npz"


def _character(root, proxy):
    builder, registry = root.VertexLibraryBuilder(), root.MaterialRegistry()
    character = proxy.make_skinned_character(builder, registry)
    builder.build()
    return character


def _queued(root, proxy, math3d, t, n_playing):
    character = _character(root, proxy)
    scene = root.Scene()
    playing = [(t % a.end_time, a) for a in character.animations[:n_playing]]
    character.queue_animated(scene, math3d.trs(
        translation=np.array([0.3, 0.0, -0.2], np.float32)), playing)
    return (scene.joint_palette[: scene._joint_cursor], scene._transforms[: scene._n],
            np.stack(character.get_node_transforms(playing)))


@pytest.mark.parametrize("n_playing", [1, 2])
@pytest.mark.parametrize("t", [0.0, 0.4, 2.7])
def test_skinning_matches_jax(t, n_playing):
    got = _queued(trt, tproxy, tmath, t, n_playing)
    want = _queued(jrt, jproxy, jmath, t, n_playing)
    for name, g, w in zip(("joint palette", "transforms", "node transforms"), got, want):
        assert g.shape == w.shape and g.shape[0] > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)
    # the pose moved: joints are not at their bind pose
    assert not np.allclose(got[0], np.eye(4, dtype=np.float32)[None], atol=1e-3)


def test_animation_past_its_end_raises():
    character = _character(trt, tproxy)
    sway = character.get_animation("sway")
    with pytest.raises(tgltf.AnimationError):
        character.queue_animated(trt.Scene(), tmath.IDENTITY, [(sway.end_time + 1.0, sway)])


@pytest.fixture(scope="module")
def frames():
    """Port renders of the sandbox keys (and the fast sampler at 1×MSAA for
    the drift bound), each with its stats."""
    out = {}
    for key, msaa, fast in (("mini-sandbox-msaa4", 4, False),
                            ("mini-sandbox-fast-msaa4", 4, True),
                            ("mini-sandbox-exact", 1, False),
                            ("fast-msaa1", 1, True)):
        sandbox = demo_scenes.mini_sandbox_scene(0.4)
        ui = demo_scenes.mini_sandbox_ui(sandbox.registry, "hud")
        cfg = trt.RenderConfig(width=W, height=H, msaa_samples=msaa)
        r = trt.Renderer(sandbox.registry, cfg.fast_sampler() if fast else cfg,
                         device="cpu")
        out[key] = (r.render_frame(sandbox.scene, 0, ui=ui), r.frame_stats())
    return out


def assert_sandbox_golden(img, stats, key):
    assert sum(v for k, v in stats.items() if "overflow" in k) == 0, stats
    expected = np.load(GOLDEN)[key]
    assert img.shape == expected.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - expected.astype(int)).max(axis=-1)
    bad = (diff > 2).mean()
    assert bad < 0.005, f"{key}: {bad:.2%} of pixels drifted (max {diff.max()})"


@pytest.mark.parametrize("key", ["mini-sandbox-msaa4", "mini-sandbox-fast-msaa4",
                                 "mini-sandbox-exact"])
def test_sandbox_golden(frames, key):
    img, stats = frames[key]
    assert_sandbox_golden(img, stats, key)
    assert stats["ui_demand_max"] >= 1 and stats["masked_demand_max"] >= 1


def test_fast_vs_default_drift(frames):
    exact, fast = frames["mini-sandbox-exact"][0], frames["fast-msaa1"][0]
    drift = np.abs(exact.astype(int) - fast.astype(int)).mean()
    assert 0.0 < drift < 8.0, drift
