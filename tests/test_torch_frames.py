"""The port's multi-frame path on the CPU, at 160×96: render_frames_device
(pipeline.render_frames_scan) against the JAX package's and against the
port's own per-frame path, the batch-max overflow policy, shade.shade,
the per-stage timings and the sandbox flythrough.

Tolerances:
- JAX against the port: stats rows equal exactly; images the golden
  suite's tolerance, at most 0.5% of pixels more than 2 u8 steps off
  (tests/test_golden.py).
- The port's batch against its own per-frame path: bit-equal (on the CPU
  the batch runs render_frame once a blob).
- shade.shade against JAX: ≤ 2^-12 absolute on the HDR color, ≥ 99.9% of
  samples within 2^-18 (tests/test_torch_stages.py::test_shade's reasons).
"""

import copy
import inspect
import re
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from apps import triangle as jtri
from renderer_tpu.engine import stats as jstats
from renderer_tpu_torch.apps import sandbox as tsandbox
from renderer_tpu_torch.apps import triangle as ttri
from renderer_tpu_torch.assets import demo_scenes, png
from renderer_tpu_torch.engine import stats as tstats
from renderer_tpu_torch.raster.pipeline import STAT_NAMES
from tests import torch_parity
from tests.test_torch_frame import _assert_golden_close
from tests.torch_parity import H, W

OFFSETS = (0.0, 0.15, -0.15)


def _triangle_batch(tri, rt, **kw):
    """The triangle demo seen from three camera offsets (one draw list)."""
    registry, meshes, material = tri.build_triangle_assets()
    r = rt.Renderer(registry, rt.RenderConfig(width=W, height=H), **kw)
    scenes = []
    for dx in OFFSETS:
        s = tri.build_scene(meshes, material)
        s.camera.position = s.camera.position + np.array([dx, 0, 0], np.float32)
        scenes.append(s)
    return r, scenes


@pytest.fixture(scope="module")
def triangle_frames():
    rj, sj = _triangle_batch(jtri, jrt)
    imgs_j, stats_j = rj.render_frames_device(sj, debug_mode=3)
    rt_, st = _triangle_batch(ttri, trt, device="cpu")
    imgs_t, stats_t = rt_.render_frames_device(st, debug_mode=3)
    return (np.asarray(imgs_j), np.asarray(stats_j), imgs_t.numpy(),
            stats_t.numpy(), rt_, st)


def test_frames_device_matches_jax(triangle_frames):
    imgs_j, stats_j, imgs_t, stats_t, _, _ = triangle_frames
    assert imgs_t.shape == (len(OFFSETS), H, W, 3) and imgs_t.dtype == np.uint8
    np.testing.assert_array_equal(stats_t, stats_j)
    for k in range(len(OFFSETS)):
        _assert_golden_close(imgs_t[k], imgs_j[k], f"frame {k}")
    assert len({imgs_t[k].tobytes() for k in range(len(OFFSETS))}) == len(OFFSETS)


@pytest.mark.parametrize("k", range(len(OFFSETS)))
def test_triangle_batch_equals_per_frame(triangle_frames, k):
    _, _, imgs_t, stats_t, r, scenes = triangle_frames
    np.testing.assert_array_equal(imgs_t[k], r.render_frame(scenes[k], 3))
    assert list(r.frame_stats().values()) == stats_t[k].tolist()


def _moved(scene, dx):
    """`scene` with its camera moved by dx along x (the draws shared)."""
    moved = copy.copy(scene)
    moved.camera = copy.deepcopy(scene.camera)
    moved.camera.position = moved.camera.position + np.array([dx, 0, 0], np.float32)
    return moved


def test_lit_batch_with_all_alpha_classes_matches_jax():
    """The lit six-patch ring (textured opaque, masked a2c and blended
    layers; 1×MSAA to keep interpret mode short) from two camera offsets:
    the port's render_frames_device against the JAX package's frame of
    each scene — stats rows exactly, images at the golden tolerance.

    The reference is JAX's render_frame, which the Renderer composes
    eagerly on the CPU (op by op). JAX's own batch of this scene is the
    jitted frame, and under jit XLA contracts the cross products of
    setup.cross (renderer_tpu/raster/setup.py:84-89) into FMAs: 16 of the
    scene's zero-index padding triangles (points, column 792 the first)
    get edge coefficients of 1e-6 to 1e-5 instead of 0, pass det > 0 and
    fill a screen rectangle, so its total_pairs and total_rows grow and
    ~17% of pixels move. The scan is not the cause: a jitted single frame
    gives the same. So the jitted batch is not the comparison here; the
    port rejects those triangles as the eager reference does
    (tests/test_torch_stages.py::test_degenerate_triangles_are_invalid)."""
    registry, scene, cfg = torch_parity.build_scene("renderer_tpu_torch", "sandbox-static")
    r = trt.Renderer(registry, replace(cfg, msaa_samples=1), overflow_policy="off",
                     device="cpu")
    imgs_t, stats_t = r.render_frames_device([_moved(scene, dx) for dx in OFFSETS[:2]])
    imgs_t, stats_t = imgs_t.numpy(), stats_t.numpy()
    registry, scene, cfg = torch_parity.build_scene("renderer_tpu", "sandbox-static")
    rj = jrt.Renderer(registry, replace(cfg, msaa_samples=1), overflow_policy="off")
    for k, dx in enumerate(OFFSETS[:2]):
        img_j = np.asarray(rj.render_frame(_moved(scene, dx)))
        assert stats_t[k].tolist() == list(rj.frame_stats().values())
        _assert_golden_close(imgs_t[k], img_j, f"frame {k}")
        assert imgs_t[k].std() > 10
    assert stats_t[:, STAT_NAMES.index("masked_demand_max")].min() >= 1
    assert stats_t[:, STAT_NAMES.index("blended_demand_max")].min() >= 1
    assert not np.array_equal(imgs_t[0], imgs_t[1])


# -- the sandbox flythrough: all three alpha classes and the skinned
# character, through render_frames_device ----------------------------------

@pytest.fixture(scope="module")
def flight(tmp_path_factory):
    out = tmp_path_factory.mktemp("flythrough")
    result = tsandbox.flythrough(frames=2, out_dir=str(out), width=W, height=H,
                                 msaa=1, sandbox=demo_scenes.MiniSandbox(),
                                 device="cpu")
    return result, out


def test_flythrough_pngs_decode_to_its_frames(flight):
    result, out = flight
    images = result["images"]
    assert images.shape == (2, H, W, 3) and images.dtype == np.uint8
    assert sorted(p.name for p in out.iterdir()) == ["0000.png", "0001.png"]
    for i in range(2):
        decoded = png.decode_png((out / f"{i:04d}.png").read_bytes())
        np.testing.assert_array_equal(decoded[..., :3], images[i])
        assert (decoded[..., 3] == 255).all()
    assert not np.array_equal(images[0], images[1])  # the camera moved
    stats = result["stats"].numpy()
    assert stats.shape == (2, len(STAT_NAMES))
    assert stats[:, :4].sum() == 0 and stats[:, -1].sum() == 0


@pytest.mark.parametrize("k", [0, 1])
def test_flythrough_batch_equals_per_frame(flight, k):
    """Masked, blended and skinned geometry: the batch is
    bit-equal to the same renderer's per-frame path, stats included."""
    result, _ = flight
    r, scene = result["renderer"], result["scenes"][k]
    np.testing.assert_array_equal(result["images"][k], r.render_frame(scene))
    assert list(r.frame_stats().values()) == result["stats"][k].tolist()
    assert r.frame_stats()["masked_demand_max"] >= 1
    assert r.frame_stats()["blended_demand_max"] >= 1


# -- the batch-max overflow policy (tests/test_frame_stats.py
# TestBatchOverflowPolicy) -------------------------------------------------

CFG = dict(width=128, height=64, tile_h=16)


def _overflow_batch():
    """Two scenes sharing one draw list: frame 0 sees 32 stacked quads
    (many pairs), frame 1 looks away (near-zero pairs), so an overflow mid
    batch must not hide behind the clean final frame."""
    m = torch_parity._mods("renderer_tpu_torch")
    registry = trt.MaterialRegistry()
    builder = trt.VertexLibraryBuilder()
    meshes = [torch_parity._quad(m, builder, 1.2 + 0.02 * i, half=0.9)
              for i in range(32)]
    builder.build()
    mat = registry.create_material(
        "gray", trt.PbrMaterialParameters(base_color_factor=(0.5, 0.5, 0.5, 1)))

    def make():
        s = trt.Scene()
        for mesh in meshes:
            s.queue_mesh(mesh, mat, None, m.math3d.IDENTITY)
        return s

    scene, away = make(), make()
    away.camera.orientation = m.math3d.quat_from_axis_angle([0, 1, 0], np.pi)
    return registry, [scene, away]


def test_sync_policy_rerenders_whole_batch():
    registry, scenes = _overflow_batch()
    r = trt.Renderer(registry, trt.RenderConfig(pair_capacity=32, **CFG),
                     overflow_policy="sync", device="cpu")
    imgs, stats = r.render_frames_device(scenes, debug_mode=1)
    assert r.config.pair_capacity > 32
    host = stats.numpy()
    assert host[:, :4].sum() == 0, host  # every frame complete
    ample = trt.Renderer(registry, trt.RenderConfig(**CFG), device="cpu")
    ref, _ = ample.render_frames_device(scenes, debug_mode=1)
    np.testing.assert_array_equal(imgs.numpy(), ref.numpy())
    assert r.frame_stats() == dict(zip(STAT_NAMES, host[-1].tolist()))


def test_auto_policy_grows_for_next_batch():
    registry, scenes = _overflow_batch()
    r = trt.Renderer(registry, trt.RenderConfig(pair_capacity=32, **CFG),
                     overflow_policy="auto", device="cpu")
    _imgs, stats = r.render_frames_device(scenes, debug_mode=1)
    # frame 0 overflowed (and the check saw it despite frame 1 being
    # clean); the NEXT batch runs at grown capacity
    assert stats.numpy()[0, :4].sum() > 0
    assert r.config.pair_capacity > 32
    assert r._skip_stat_checks == 1
    _imgs2, stats2 = r.render_frames_device(scenes, debug_mode=1)
    assert stats2.numpy()[:, :4].sum() == 0


def test_off_policy_leaves_the_capacity():
    registry, scenes = _overflow_batch()
    r = trt.Renderer(registry, trt.RenderConfig(pair_capacity=32, **CFG),
                     overflow_policy="off", device="cpu")
    _imgs, stats = r.render_frames_device(scenes, debug_mode=1)
    assert stats.numpy()[0, :4].sum() > 0
    assert r.config.pair_capacity == 32 and r._skip_stat_checks == 0


def test_batch_needs_one_draw_list():
    registry, scenes = _overflow_batch()
    r = trt.Renderer(registry, trt.RenderConfig(**CFG), device="cpu")
    scenes[1].draws = scenes[1].draws[:-1]
    with pytest.raises(ValueError, match="same draw list"):
        r.render_frames_device(scenes)
    with pytest.raises(ValueError, match="at least one scene"):
        r.render_frames_device([])


def test_morph_batch_with_varying_weights_matches_per_frame():
    """Different morph weights per frame (tests/test_morph.py
    TestMorphScanBatch): each blob's weights drive its own frame, bit-equal
    to the per-frame path."""
    from tests.test_morph import DELTA0, DELTA1, _quad_arrays

    m = torch_parity._mods("renderer_tpu_torch")
    registry = trt.MaterialRegistry()
    builder = trt.VertexLibraryBuilder()
    p, uv, n, t, i = _quad_arrays()
    morphed = builder.add_mesh(p, uv, n, t, i,
                               morph_targets=[(DELTA0, None), (DELTA1, None)])
    builder.build()
    mat = registry.create_material(
        "m-scan", trt.PbrMaterialParameters(base_color_factor=(1, 1, 1, 1)))
    r = trt.Renderer(registry, trt.RenderConfig(width=W, height=H), device="cpu")

    def scene_at(w0, w1):
        scene = trt.Scene()
        scene.queue_mesh(morphed, mat, None, m.math3d.IDENTITY,
                         morph_weights=np.array([w0, w1], np.float32))
        return scene

    weight_sets = [(0.0, 0.0), (0.8, 0.0), (0.3, 0.6)]
    imgs, _stats = r.render_frames_device([scene_at(*w) for w in weight_sets],
                                          debug_mode=3)
    imgs = imgs.numpy()
    assert len({imgs[k].tobytes() for k in range(3)}) == 3
    for k, w in enumerate(weight_sets):
        np.testing.assert_array_equal(imgs[k], r.render_frame(scene_at(*w), 3))


# -- shade.shade and the per-stage timings ---------------------------------

def test_shade_matches_jax():
    """shade.shade (interpolants + shade_interpolated, default sampler
    arguments) on the all-classes scene's sample-0 visibility."""
    from renderer_tpu.raster import binning as jbin
    from renderer_tpu.raster import raster_kernel as jrk
    from renderer_tpu.raster import setup as jsetup
    from renderer_tpu.raster import shade as jshade
    from renderer_tpu.raster import vertex_stage as jvs
    from renderer_tpu.scene import draw_stream as jds
    from renderer_tpu_torch.interop import from_numpy_arrays
    from renderer_tpu_torch.raster import shade as tshade
    from renderer_tpu_torch.raster import vertex_stage as tvs
    from renderer_tpu_torch.scene import draw_stream as tds

    geom, mats, blob, static, cfg = torch_parity.host_inputs("sandbox-static")
    unpack = dict(morph_k=static["morph_k"], joint_cap=static["joint_cap"])
    jf = jds.unpack_frame({"blob": jnp.asarray(blob)}, **unpack)
    jgeom = {k: jnp.asarray(v) for k, v in geom.items()}
    jv = jvs.run_vertex_stage(jgeom, jf, static["skin_start"])
    jt = jsetup.triangle_setup(jv["clip"], jgeom["tri_v"], jf["num_tris"],
                               cfg.width, cfg.height)
    jb = jbin.bin_triangle_classes(
        jt, (0, jf["num_tris"]), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, pair_capacity=1 << 11)
    _, tid = jrk.rasterize_binned(
        jb[0], jb[1][0], jb[2][0], padded_height=cfg.padded_height,
        padded_width=cfg.padded_width, interpret=True)
    tid = np.asarray(tid)[0, : cfg.height, : cfg.width].copy()
    kw = dict(width=cfg.width, height=cfg.height)
    want = np.asarray(jshade.shade(jnp.asarray(tid), jgeom, jv, jf,
                                   {k: jnp.asarray(v) for k, v in mats.items()}, **kw))
    tgeom = from_numpy_arrays(geom, device="cpu")
    tf = tds.unpack_frame({"blob": torch.from_numpy(blob)}, **unpack)
    tv = tvs.run_vertex_stage(tgeom, tf, static["skin_start"])
    got = tshade.shade(torch.from_numpy(tid), tgeom, tv, tf,
                       from_numpy_arrays(mats, device="cpu"), **kw).numpy()
    assert got.shape == want.shape == (cfg.height, cfg.width, 4)
    assert (tid >= 0).mean() > 0.05  # the patches cover the frame
    err = np.abs(got - want)
    assert err.max() <= 2.0**-12, err.max()
    assert (err <= 2.0**-18).mean() >= 0.999


def _jax_stage_keys(msaa: int) -> list:
    """The stage names of the JAX package's device_stage_timings, read from
    its source."""
    src = inspect.getsource(jstats.device_stage_timings)
    keys = re.findall(r'timings\["([^"]+)"\]', src)
    assert re.search(r'timings\[f"FULL FRAME \(fused, msaa\{cfg\.msaa_samples\}\)"\]', src)
    return keys + [f"FULL FRAME (fused, msaa{msaa})"]


def test_stage_timings_have_the_jax_keys():
    registry, scene = demo_scenes.patch_ring_scene()
    r = trt.Renderer(registry, trt.RenderConfig(width=W, height=H).fast_sampler(),
                     overflow_policy="off", device="cpu")
    timings = tstats.device_stage_timings(r, scene, iters=1)
    assert list(timings) == _jax_stage_keys(1)
    assert len(timings) == 10
    assert all(v > 0.0 for v in timings.values()), timings


def test_fused_frame_ms_is_positive():
    registry, meshes, material = ttri.build_triangle_assets()
    r = trt.Renderer(registry, trt.RenderConfig(width=W, height=H), device="cpu")
    assert tstats.fused_frame_ms(r, ttri.build_scene(meshes, material), iters=2) > 0.0
