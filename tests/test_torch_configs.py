"""The port's configuration matrix (renderer_tpu_torch/apps/configs.py) and
the two proxy builders it adds, on the CPU against the JAX package.

Tolerances:
- the builders' vertex, index, morph-delta and transform arrays: bit-equal
  (the same numpy code);
- rows 8 and 9 at 160×96 against the JAX Renderer (Pallas in interpret
  mode): the stats vector exactly, images at the golden suite's tolerance
  (at most 0.5% of pixels more than 2 u8 steps off, tests/test_golden.py).
"""

import json
from functools import partial

import numpy as np
import pytest

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from renderer_tpu.assets import proxy as jproxy
from renderer_tpu_torch.apps import configs
from renderer_tpu_torch.assets import png
from renderer_tpu_torch.assets import proxy as tproxy
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.test_torch_frame import _assert_golden_close
from tests.torch_parity import H, W

# the cheapest sampler (one tap a sample, sRGB decoded after filtering):
# these rows check the matrix, the pair counts and the morph tap, and
# tests/test_torch_stages.py holds the samplers to JAX's
CHEAP = dict(srgb_per_tap=False, aniso_samples=1)
SMALL = dict(width=W, height=H, pair_capacity=1 << 14, row_capacity=1 << 14, **CHEAP)
OVERDRAW = dict(n_layers=64, n_meshes=2, tris_per_mesh=512)


class RecordingBuilder:
    """Stands in for a VertexLibraryBuilder: keeps every add_mesh call's
    arrays."""

    def __init__(self):
        self.meshes = []

    def add_mesh(self, *arrays, morph_targets=None):
        self.meshes.append((arrays, morph_targets))
        return len(self.meshes) - 1


def _assert_bit_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("builder", ["overdraw", "morph"])
def test_proxy_builders_equal_jax(builder):
    out = {}
    for name, mod, pkg in (("jax", jproxy, jrt), ("torch", tproxy, trt)):
        rec, reg = RecordingBuilder(), pkg.MaterialRegistry()
        if builder == "overdraw":
            mesh, mat, transforms = mod.make_overdraw_stack(rec, reg, n_layers=300)
            out[name] = (rec.meshes, transforms, mat)
        else:
            mesh, mat = mod.make_morph_sheet(rec, reg)
            out[name] = (rec.meshes, None, mat)
        assert mesh == 0
    (jm, jtr, jmat), (tm, ttr, tmat) = out["jax"], out["torch"]
    assert len(jm) == len(tm) == 1
    (ja, jmorph), (ta, tmorph) = jm[0], tm[0]
    for i, (a, b) in enumerate(zip(ja, ta, strict=True)):
        _assert_bit_equal(a, b, f"array {i}")
    if builder == "overdraw":
        _assert_bit_equal(jtr, ttr, "transforms")
        assert ttr.shape == (300, 4, 4) and jmorph is tmorph is None
    else:
        assert len(jmorph) == len(tmorph) == 2 and tmorph[1][1] is None
        for (jd, jn), (td, tn) in zip(jmorph, tmorph):
            _assert_bit_equal(jd, td, "position deltas")
            if jn is not None:
                _assert_bit_equal(jn, tn, "normal deltas")
    assert jmat.name == tmat.name
    assert jmat.params.base_color_factor == tmat.params.base_color_factor


def _jax_scene(port_scene):
    scene = jrt.Scene(world_space=jrt.GLTF)
    scene.camera.position = port_scene.camera.position
    scene.camera.orientation = port_scene.camera.orientation
    return scene


def test_overdraw_row_reduced_matches_jax():
    """Row 8 at 160×96: a 64-layer overdraw stack over a 2 × 512 stress
    field, at row 8's camera."""
    renderer, scene = configs.overdraw_row("cpu", **OVERDRAW, **SMALL)
    img = renderer.render_frame(scene, 0)
    stats = renderer.frame_stats()
    assert stats["total_pairs"] > 64 * 2 * 4 and stats["row_overflow"] == 0

    reg, builder = jrt.MaterialRegistry(), jrt.VertexLibraryBuilder()
    omesh, omat, otransforms = jproxy.make_overdraw_stack(builder, reg, n_layers=64)
    meshes, mat = jproxy.make_stress_field(builder, reg, n_meshes=2, tris_per_mesh=512)
    builder.build()
    rj = jrt.Renderer(reg, jrt.RenderConfig(max_triangles=1 << 21, **SMALL),
                      overflow_policy="off")
    js = _jax_scene(scene)
    for m in meshes:
        js.queue_mesh(m, mat, None, np.eye(4, dtype=np.float32))
    js.queue_instanced(omesh, omat, otransforms)
    jimg = np.asarray(rj.render_frame(js, 0))
    assert list(stats.values()) == list(rj.frame_stats().values())
    _assert_golden_close(img, jimg, "row 8")
    assert img.std() > 5


@pytest.fixture(scope="module")
def morph_frames():
    """Row 9's frames at 160×96 in debug mode 3 (normals) at two weight
    settings, from the port and from the JAX Renderer: {t: (port renderer's
    stats, port image, JAX stats, JAX image)}."""
    renderer, scene_at = configs.morph_row("cpu", width=W, height=H, **CHEAP)
    reg, builder = jrt.MaterialRegistry(), jrt.VertexLibraryBuilder()
    mesh, mat = jproxy.make_morph_sheet(builder, reg)
    builder.build()
    rj = jrt.Renderer(reg, jrt.RenderConfig(width=W, height=H, **CHEAP),
                      overflow_policy="off")
    frames = {}
    for t in MORPH_TIMES:
        img = renderer.render_frame(scene_at(t), 3)
        js = _jax_scene(scene_at(t))
        js.queue_mesh(mesh, mat, None, np.eye(4, dtype=np.float32),
                      morph_weights=configs.morph_weights(t))
        jimg = np.asarray(rj.render_frame(js, 3))
        frames[t] = (renderer.frame_stats(), img, rj.frame_stats(), jimg)
    return frames


MORPH_TIMES = (0.0, 0.8)


@pytest.mark.parametrize("t", MORPH_TIMES)
def test_morph_row_reduced_matches_jax(morph_frames, t):
    stats, img, jstats, jimg = morph_frames[t]
    assert list(stats.values()) == list(jstats.values())
    _assert_golden_close(img, jimg, f"row 9 at t={t}")
    assert img.std() > 5


def test_morph_weights_move_the_sheet(morph_frames):
    a, b = (morph_frames[t][1] for t in MORPH_TIMES)
    assert (np.abs(a.astype(int) - b.astype(int)).max(axis=-1) > 8).mean() > 0.02


ROWS = ("triangle-800x600-flat", "stress-1M-tris-1080p", "stress-4Mpairs-1080p",
        "morph-sheet-480p-normals")
SKIPPED = ("sponza-albedo-720p", "sponza-gbuffer-draw-id", "sponza-gbuffer-normals",
           "sponza-gbuffer-rough-metal", "sponza-gbuffer-emissive",
           "sponza-gbuffer-occlusion", "skinned-anim-t0.0", "skinned-anim-t0.75",
           "sandbox-lit-1080p-msaa4", "sandbox-lit-1080p-msaa4-fastsampler",
           "sandbox-flythrough-batch16-1080p-msaa4", "testbox-real-geometry-800x608",
           "testbox-field-276k-1080p-msaa4")


def test_run_all_smoke_on_the_cpu(tmp_path, monkeypatch, capsys):
    """run_all with every row cut to 160×96 (the stress field to 2 × 128
    triangles, the overdraw stack to 16 layers, the morph sheet to 8 × 8
    cells) on the cheapest sampler: the rows that need no
    asset render, time and write their PNGs after results.json; the asset
    rows (no sandbox assets here) print their skip line."""
    small = dict(width=W, height=H, **CHEAP)
    field = dict(n_meshes=2, tris_per_mesh=128, **SMALL)
    monkeypatch.setattr(configs, "triangle_row", partial(configs.triangle_row, **small))
    monkeypatch.setattr(configs, "stress_row", partial(configs.stress_row, **field))
    monkeypatch.setattr(configs, "overdraw_row",
                        partial(configs.overdraw_row, n_layers=16, **field))
    monkeypatch.setattr(configs, "morph_row", partial(configs.morph_row, n=8, **small))
    results = configs.run_all(str(tmp_path), frames=1, device="cpu")
    printed = capsys.readouterr().out
    assert [r["config"] for r in results] == list(ROWS)
    for name in SKIPPED:
        assert f"# {name} unavailable (" in printed, name
    saved = json.loads((tmp_path / "results.json").read_text())
    assert [r["config"] for r in saved] == list(ROWS)
    for r in results:
        assert r["ms_per_frame"] > 0 and r["fps"] == pytest.approx(1000 / r["ms_per_frame"])
        assert r["dropped_pairs"] == r["dropped_rows"] == 0, r
        assert r["frame_stats"]["total_pairs"] > 0
        img = png.decode_png((tmp_path / f"{r['config']}.png").read_bytes())
        assert img.shape == (H, W, 4) and img[..., :3].std() > 1.0, r["config"]
