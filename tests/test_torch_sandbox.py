"""The port's sandbox app (renderer_tpu_torch.apps.sandbox.run_loop) and its
PNG codec (renderer_tpu_torch.assets.png) on the CPU.

- run_loop driven by tests/test_sandbox_events.py's event script through
  the same `sandbox=` seam, with that test's assertions.
- show_hud=False runs of both packages' run_loop on one 3-frame script at
  128×80: camera, debug mode and capture flags agree exactly, the final
  image within the golden tolerance (±2 u8 on < 0.5% of pixels).
- Sandbox() on a synthetic asset tree without .bin buffers: both packages'
  proxy path gives the same registry, vertex library and scene.
- png.py: decode equals Pillow's convert("RGBA") over every supported
  colour type, bit depth and row filter; the writer round-trips through
  both decoders.
"""

import io
import struct
import time
import zlib

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker

import renderer_tpu_torch as trt
from renderer_tpu_torch.assets import png
from renderer_tpu_torch.core import math3d


def mini_sandbox(pkg_name: str):
    """test_sandbox_events.MiniSandbox built with either package: two
    procedural patches + the skinned character."""
    import importlib

    pkg = importlib.import_module(pkg_name)
    proxy = importlib.import_module(f"{pkg_name}.assets.proxy")
    m3 = importlib.import_module(f"{pkg_name}.core.math3d")

    class MiniSandbox:
        def __init__(self):
            self.registry = pkg.MaterialRegistry()
            builder = pkg.VertexLibraryBuilder()
            self.meshes = []
            for i in range(2):
                p, uv, n, t, idx = proxy._patch_geometry(
                    200, 600, [-0.8, -0.5, -0.2], [0.8, 0.5, 0.2], seed=7 + i)
                self.meshes.append(builder.add_mesh(p, uv, n, t, idx))
            self.mat = self.registry.create_material(
                "m", pkg.PbrMaterialParameters(base_color_factor=(0.8, 0.5, 0.3, 1)))
            self.character = proxy.make_skinned_character(builder, self.registry)
            builder.build()

        def build_scene(self, game_time, scene=None):
            if scene is None:
                scene = pkg.Scene(world_space=pkg.GLTF)
            else:
                scene.clear()
            for i, mesh in enumerate(self.meshes):
                tr = m3.trs(translation=np.array([i - 0.5, 0.8, -1.5], np.float32))
                scene.queue_mesh(mesh, self.mat, None, tr)
            playing = [(game_time % a.end_time, a) for a in self.character.animations]
            self.character.queue_animated(scene, m3.IDENTITY, playing)
            return scene

    return MiniSandbox()


@pytest.fixture
def no_sleep(monkeypatch):
    # pacing would sleep budget-minus-frame-time per frame (100 s here)
    monkeypatch.setattr(time, "sleep", lambda _s: None)


def test_scripted_events_drive_camera_ui_and_debug_mode(no_sleep):
    from renderer_tpu_torch.apps.sandbox import run_loop

    events = [
        [],                                             # f0: UI appears
        [("key_down", "Num3", []), ("key_up", "Num3", []),  # debug mode 3
         ("key_down", "W", [])],                        # start moving
        [("key_up", "W", []),                           # stop (before update)
         ("mouse_motion", 100.0, 65.0)],                # hover the window
        [("mouse_button_down", "left"),                 # f3: click ON window:
         ("mouse_button_up", "left")],                  #   gated, NO mouselook
        [("mouse_motion", 10.0, 90.0)],                 # f4: leave the window
        [("mouse_button_down", "left"),                 # f5: click empty space
         ("mouse_button_up", "left"),                   #   -> mouse-look ON
         ("mouse_motion_rel", 750.0, 0.0)],             #   turn: yaw -= 1.0
    ]
    budget = 100.0
    stats = run_loop(
        frames=len(events), target_fps=1.0 / budget, width=128, height=80,
        msaa=1, show_hud=True, immediate_present=False, events=events,
        sandbox=mini_sandbox("renderer_tpu_torch"), device="cpu",
    )
    assert stats["debug_mode"] == 3
    assert stats["image"].shape == (80, 128, 3)
    pos = np.array(stats["cam_position"])
    disp = pos - np.array([0.0, 1.6, 0.0])
    assert np.linalg.norm(disp) == pytest.approx(5.0 * budget, rel=1e-4)
    fwd = math3d.quat_to_mat3(math3d.quat_mul(
        math3d.quat_from_axis_angle([0, 1, 0], 1.56),
        math3d.quat_from_axis_angle([1, 0, 0], 0.0),
    )) @ np.array([0.0, 0.0, 1.0])
    assert np.allclose(disp / np.linalg.norm(disp), fwd, atol=1e-4)
    assert stats["mouse_look"] is True
    assert stats["cam_yaw"] == pytest.approx(1.56 - 1.0)
    assert stats["cam_pitch"] == pytest.approx(0.0)
    assert not stats["want_capture_mouse"]
    assert stats["frame_stats"]["overflow_ui"] == 0


def test_events_without_hud_still_processed(no_sleep):
    from renderer_tpu_torch.apps.sandbox import run_loop

    stats = run_loop(
        frames=2, target_fps=0.01, width=128, height=80, msaa=1,
        show_hud=False, events=[[("key_down", "Num2", [])], []],
        sandbox=mini_sandbox("renderer_tpu_torch"), device="cpu",
    )
    assert stats["debug_mode"] == 2
    assert not stats["want_capture_keyboard"]


def test_zero_frames_refused():
    from renderer_tpu_torch.apps.sandbox import run_loop

    with pytest.raises(AssertionError, match="at least one frame"):
        run_loop(frames=0, sandbox=mini_sandbox("renderer_tpu_torch"), device="cpu")


def test_run_loop_matches_jax_without_hud(no_sleep, tmp_path):
    """The same 3-frame event script through both packages' run_loop: the
    camera, debug mode and capture flags agree exactly; the final frame
    within the golden tolerance; the port's PNG dump decodes to it."""
    from apps.sandbox import run_loop as jax_run_loop
    from renderer_tpu_torch.apps.sandbox import run_loop

    # the budget (100 s) is far above any frame's time, so game time and
    # movement take the fixed step; the turn brings the patches into view
    events = [
        [("key_down", "Num4", []), ("key_down", "LShift", []),
         ("mouse_button_down", "left")],                       # mouse-look on
        [("key_down", "W", []), ("key_up", "W", []),           # no net move
         ("mouse_motion_rel", -1185.0, 300.0)],                # turn
        [("key_up", "LShift", []), ("key_down", "Escape", [])],  # look off
    ]
    kw = dict(frames=3, target_fps=0.01, width=128, height=80, msaa=1,
              show_hud=False, events=events)
    want = jax_run_loop(sandbox=mini_sandbox("renderer_tpu"), **kw)
    got = run_loop(sandbox=mini_sandbox("renderer_tpu_torch"), device="cpu",
                   dump_path=str(tmp_path / "out.png"), **kw)
    for k in ("debug_mode", "cam_position", "cam_yaw", "cam_pitch", "mouse_look",
              "want_capture_mouse", "want_capture_keyboard", "immediate_present"):
        assert got[k] == want[k], k
    assert got["debug_mode"] == 4 and got["mouse_look"] is False
    diff = np.abs(got["image"].astype(int) - want["image"].astype(int)).max(axis=-1)
    assert got["image"].std() > 5
    assert (diff > 2).mean() < 0.005, f"{(diff > 2).mean():.2%} (max {diff.max()})"
    assert sum(v for k, v in got["frame_stats"].items() if "overflow" in k) == 0
    np.testing.assert_array_equal(
        png.decode_png((tmp_path / "out.png").read_bytes())[..., :3], got["image"])


def test_sandbox_proxy_path_matches_jax(tmp_path, monkeypatch):
    """Sandbox() on an asset tree without .bin buffers (a synthetic
    Sponza.gltf with ntex textures, and Smol Ame's texture): both packages
    take the proxy path and build the same registry and the same scene."""
    import apps.sandbox as jsb
    from renderer_tpu_torch.apps import sandbox as tsb
    from renderer_tpu_torch.assets import ntex
    from tests.test_torch_bc7 import _proxy_files, chain_blocks, ntex_bytes

    monkeypatch.setenv("RENDERER_TPU_CACHE", str(tmp_path / "cache"))
    sponza_dir = tmp_path / "sponza" / "glTF"
    sponza_dir.mkdir(parents=True)
    _proxy_files(sponza_dir).rename(sponza_dir / "Sponza.gltf")
    ame_dir = tmp_path / "smol-ame-by-seafoam"
    ame_dir.mkdir()
    (ame_dir / "terrariumtexsketchfab.ntex").write_bytes(ntex_bytes(
        16, 16, ntex.VK_FORMAT_BC7_SRGB,
        chain_blocks(np.random.default_rng(9), 16, 16, 5)))
    for mod in (jsb, tsb):
        monkeypatch.setattr(mod, "SPONZA", sponza_dir / "Sponza.gltf")
        monkeypatch.setattr(mod, "SMOL_AME", ame_dir / "smol-ame.gltf")
    want, got = jsb.Sandbox(), tsb.Sandbox(device="cpu")
    assert want.proxy_geometry and got.proxy_geometry
    for k in ("base_color_factor", "emissive_occlusion", "alpha_rgh_mtl_normal",
              "tex_indices", "alpha_mode"):
        np.testing.assert_array_equal(getattr(got.registry, k),
                                      getattr(want.registry, k), k)
    for a, b in zip(want.registry.textures.values(), got.registry.textures.values(),
                    strict=True):
        for x, y in zip(a.mips, b.mips, strict=True):
            np.testing.assert_array_equal(y, x)
    for k in ("positions", "indices", "joints", "weights"):
        np.testing.assert_array_equal(getattr(got.library, k),
                                      getattr(want.library, k), k)
    js, ts = want.build_scene(0.5), got.build_scene(0.5)
    n = ts.draw_count
    assert n == js.draw_count > 0
    # keys without the library field (a process-wide counter of libraries)
    from renderer_tpu_torch.scene import scene as tscene

    lib = np.uint64(((1 << tscene._LIBRARY_BITS) - 1) << tscene._LIBRARY_SHIFT)
    np.testing.assert_array_equal(ts._keys[:n] & ~lib, js._keys[:n] & ~lib)
    np.testing.assert_array_equal(ts._material_id[:n], js._material_id[:n])
    np.testing.assert_array_equal(ts._transforms[:n], js._transforms[:n])
    assert ts._joint_cursor == js._joint_cursor > 0
    np.testing.assert_array_equal(ts.joint_palette[:ts._joint_cursor],
                                  js.joint_palette[:js._joint_cursor])


# -- PNG codec ---------------------------------------------------------------


# Adam7's passes, written out again here so the encoder is the test's own
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _scanlines(samples, depth, ftype) -> bytes:
    """The filtered scanlines of [h, w, channels] samples at `depth`:
    below 8 bits packed leftmost-first into bytes, 16 bits big-endian."""
    h, w, _ = samples.shape
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        shifts = depth * np.arange(per - 1, -1, -1)
        b = (padded.reshape(h, -1, per) << shifts).sum(axis=-1).astype(np.uint8)
        b = b.reshape(h, -1, 1)  # filters work on whole bytes (bpp 1)
    elif depth == 16:
        b = samples.astype(">u2").view(np.uint8).reshape(h, w, -1)
    else:
        b = samples.astype(np.uint8)
    return png._filter_rows(b, ftype)


def raw_png(samples, ctype, depth, ftype, palette=None, trns=None,
            interlace=False) -> bytes:
    """A PNG of [h, w, channels] samples at any colour type and bit depth,
    every row filtered with `ftype`, plain or Adam7-interlaced."""
    h, w, nch = samples.shape
    if interlace:
        data = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, ftype)
                        for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    else:
        data = _scanlines(samples, depth, ftype)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    out = png.SIGNATURE + png._chunk(b"IHDR", ihdr)
    if palette is not None:
        out += png._chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += png._chunk(b"tRNS", trns)
    return (out + png._chunk(b"IDAT", zlib.compress(data))
            + png._chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_CASES = [(c, d, f, t) for c in (0, 2, 3, 4, 6) for d in ((8,) if c == 3 else (8, 16))
             for f in range(5) for t in ((False, True) if c in (0, 2, 3) else (False,))]


def _png_vectors(ctype, depth, trns, seed, shape=(7, 9)):
    """(samples, palette, tRNS body) of a random image: palette images
    index 20 entries (fewer at low depth); a colour key repeats one pixel."""
    rng = np.random.default_rng(seed)
    nch = _CHANNELS[ctype]
    n_pal = min(20, 1 << depth)
    s = rng.integers(0, n_pal if ctype == 3 else 1 << depth, (*shape, nch))
    pal = key = None
    if ctype == 3:
        pal = rng.integers(0, 256, (n_pal, 3), dtype=np.uint8)
        key = bytes(rng.integers(0, 256, min(12, n_pal), dtype=np.uint8)) if trns else None
    elif trns:
        if depth < 8:
            # a zero key for odd seeds: Pillow matches a 2- or 4-bit grey key
            # against the scaled value, which only 0 keeps
            s[0, 0] = s[0, 0] * (seed % 2 == 0)
        s[-1, -1] = s[0, 0]
        key = struct.pack(">" + "H" * nch, *(int(v) for v in s[0, 0]))
    return s, pal, key


@pytest.mark.parametrize("ctype,depth,ftype,trns", PNG_CASES)
def test_png_decode_matches_pillow(ctype, depth, ftype, trns):
    from PIL import Image

    s, pal, key = _png_vectors(ctype, depth, trns, ctype * 100 + depth * 10 + ftype)
    data = raw_png(s, ctype, depth, ftype, pal, key)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(png.decode_png(data), want)


# every colour type and bit depth the specification allows, plain and
# Adam7-interlaced, each with and without a tRNS chunk where one may stand
INTERLACE_CASES = [
    (c, d, i, t) for c in (0, 2, 3, 4, 6)
    for d in {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(c, (8, 16))
    for i in (False, True) for t in ((False, True) if c in (0, 2, 3) else (False,))
    if i or d < 8]


@pytest.mark.parametrize("ctype,depth,interlace,trns", INTERLACE_CASES)
def test_png_interlaced_and_low_depth_decode_matches_pillow(ctype, depth, interlace, trns):
    """Sizes that leave some Adam7 passes empty (1×1, 3×2) or ragged
    (13×11), every filter type on a larger image's passes."""
    pytest.importorskip("PIL")
    from PIL import Image

    for k, (shape, ftype) in enumerate((((1, 1), 0), ((2, 3), 1), ((11, 13), 4),
                                        ((17, 10), 3), ((9, 16), 2))):
        s, pal, key = _png_vectors(ctype, depth, trns, ctype * 100 + depth * 10 + k,
                                   shape)
        data = raw_png(s, ctype, depth, ftype, pal, key, interlace=interlace)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(png.decode_png(data), want, err_msg=str(shape))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", range(5))
def test_png_writer_round_trips(channels, ftype):
    """channels 1: a 2-D grey image, written as colour type 0."""
    from PIL import Image

    img = np.random.default_rng(ftype).integers(0, 256, (11, 13, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    data = png.encode_png(img, ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    back = png.decode_png(data)
    if channels == 1:
        np.testing.assert_array_equal(back[..., :3], np.repeat(img[..., None], 3, -1))
    else:
        np.testing.assert_array_equal(back[..., :channels], img)
    if channels in (1, 3):
        assert (back[..., 3] == 255).all()


@pytest.mark.parametrize("depth,ctype,interlace,match", [
    (8, 6, 2, "interlace method 2"), (4, 2, 0, "colour type 2 at bit depth 4"),
    (1, 4, 0, "colour type 4 at bit depth 1"),
    (16, 3, 0, "colour type 3 at bit depth 16")])
def test_png_refuses_what_it_cannot_decode(depth, ctype, interlace, match):
    from renderer_tpu_torch.assets.gltf_loader import GltfLoadingError

    ihdr = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)
    data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"")) + png._chunk(b"IEND", b""))
    with pytest.raises(GltfLoadingError, match=match):
        png.decode_png(data)


def test_apps_entry_points_default_to_the_card():
    import inspect

    from renderer_tpu_torch.apps import sandbox, testbox, triangle
    from renderer_tpu_torch.assets import gltf_loader, ntex, proxy
    from renderer_tpu_torch.materials import atlas_device, bc7

    for fn in (sandbox.Sandbox.__init__, sandbox.run_loop, sandbox.main,
               sandbox.build_bench, testbox.load_testbox, testbox.main, triangle.main,
               gltf_loader.load_gltf, proxy.load_gltf_proxy, ntex.decode,
               ntex.decode_file, bc7.decode_blocks, atlas_device.realize_atlas,
               trt.Renderer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
