"""Two RenderConfig switches of the shading path, on the CPU (the card twins
are in tests/test_torch_cuda_kernels.py):

- `bf16_shading` (texture filtering and lighting at bf16, texel addressing,
  depth, edges and compositing at f32): the port's frame of the static
  mini-sandbox at 4×MSAA (96×64, fast sampler) against the JAX package's
  with the same switch — stats equal, pixels within the golden tolerance
  (at most 0.5% of pixels more than 2 u8 steps off, tests/test_golden.py)
  — and against the port's own f32 frame with tests/test_bf16_shading.py's
  bounds and equal covered-pixel masks.
- `shade_strip_elems`: strip-mapped stacked shading bit-equal to the
  unstripped frame over all three stacked shade call sites, the twin of
  tests/test_engine.py::test_shade_strips_bit_equal.
"""

from dataclasses import replace

import numpy as np
import pytest

from tests.test_torch_frame import _assert_golden_close
from tests.torch_parity import build_scene

import renderer_tpu as jrt
import renderer_tpu_torch as trt


@pytest.fixture(scope="module")
def sandbox_frames():
    """(port bf16, port f32, JAX bf16) frames and stats of sandbox-static,
    cut to 96×64 with the fast sampler to keep the JAX package's interpret
    mode to a few tens of seconds (bf16 still filters every texture tap)."""
    out = {}
    for name, pkg, bf16 in (("port-bf16", trt, True), ("port-f32", trt, False),
                            ("jax-bf16", jrt, True)):
        registry, scene, cfg = build_scene(pkg.__name__, "sandbox-static")
        cfg = replace(cfg.fast_sampler(), width=96, height=64, bf16_shading=bf16)
        kw = {"device": "cpu"} if pkg is trt else {}
        r = pkg.Renderer(registry, cfg, overflow_policy="off", **kw)
        out[name] = (np.asarray(r.render_frame(scene)), r.frame_stats())
    return out


def test_bf16_shading_matches_jax(sandbox_frames):
    img, stats = sandbox_frames["port-bf16"]
    want, want_stats = sandbox_frames["jax-bf16"]
    assert stats == want_stats
    assert sum(v for k, v in stats.items() if "overflow" in k) == 0
    _assert_golden_close(img, want, "sandbox-static bf16")
    assert img.std() > 10  # not blank


def test_bf16_close_to_f32_with_the_same_coverage(sandbox_frames):
    """tests/test_bf16_shading.py's contract on the port: a few u8 quanta of
    drift after the tonemap, and coverage untouched by bf16."""
    b16, _ = sandbox_frames["port-bf16"]
    f32, _ = sandbox_frames["port-f32"]
    diff = np.abs(f32.astype(int) - b16.astype(int))
    assert diff.mean() < 2.0, f"bf16 mean drift {diff.mean():.2f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.01
    np.testing.assert_array_equal(f32.sum(axis=-1) > 0, b16.sum(axis=-1) > 0)


def striped_frames(device):
    """torch_parity's "strip-quads" frame (tile_h 16, 4×MSAA) unstripped
    (shade_strip_elems 0) and with a budget of one element (every stack in
    per-tile-row strips)."""
    registry, scene, cfg = build_scene("renderer_tpu_torch", "strip-quads")
    return [trt.Renderer(registry, replace(cfg, shade_strip_elems=e).validate(),
                         device=device).render_frame(scene, 0) for e in (0, 1)]


def test_shade_strips_bit_equal():
    plain, striped = striped_frames("cpu")
    assert plain.std() > 10
    assert (plain == striped).all(), (
        f"striped shading diverged on {(plain != striped).any(-1).sum()} px")
