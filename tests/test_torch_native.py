"""The port's host library (renderer_tpu_torch/tools/native.py) on the CPU.

The same seeded inputs go through the port's library, the port's numpy plain
version (inside native.plain()) and the JAX package's library; all three
must be bit-equal:
- the draw prologue (native.draw_prologue and frame_view on a scene),
- the atlas blit (native.atlas_blit_wrap and build_atlas),
- the BC7 encoders (bc7_encode, bc7_encode_mode6) and the numpy mode-6
  encoder,
- the animation paths: queue_animated (the one-call prologue) and
  get_node_transforms (the single and layered samplers) on the loader
  fixture and the skinned character, as tests/test_assets.py's
  TestNativeQueuePrologue holds the JAX package's.
It also pins the build policy: the library lands under build/native/, a
compiler that fails raises with its log, and only a missing compiler
selects the numpy path, which status() reports.
"""

import contextlib

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from renderer_tpu.assets import gltf_loader as jgl
from renderer_tpu.assets import proxy as jproxy
from renderer_tpu.materials import atlas as jatlas
from renderer_tpu.scene import draw_stream as jds
from renderer_tpu.tools import native as jnative
from renderer_tpu_torch.assets import gltf_loader as tgl
from renderer_tpu_torch.assets import proxy as tproxy
from renderer_tpu_torch.core import math3d as tmath3d
from renderer_tpu_torch.materials import atlas as tatlas
from renderer_tpu_torch.scene import draw_stream as tds
from renderer_tpu_torch.tools import native
from tests.make_loader_fixture import GLTF_PATH

# A draw key holds its vertex library's id, a counter of each package's
# process; the two packages' scenes are compared with those bits cleared
# (each scene here has one library, so the order does not depend on them).
_LIBRARY_BITS = np.uint64(((1 << 10) - 1) << 26)


def _no_library(keys):
    return keys & ~_LIBRARY_BITS


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if native._compiler() is None:
        pytest.skip("no C++ compiler: both packages take their numpy paths")
    assert native.load() is not None, native.status()
    assert jnative.load() is not None


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """native's load state reset, its build directory under tmp_path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", None)
    return tmp_path


def test_library_is_built_under_build_native():
    st = native.status()
    assert st["path"] == "native"
    lib = native.library_path()
    assert st["library"] == str(lib) and lib.is_file()
    assert lib.parent.parts[-2:] == ("build", "native")
    assert lib.name.startswith("librenderer_native-")


def test_failed_build_raises_with_the_log(fresh_native, monkeypatch):
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.load()
    assert not list(fresh_native.glob("*.so"))  # no half-built library


def test_only_a_missing_compiler_selects_numpy(fresh_native, monkeypatch, capsys):
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert native.load() is None
    assert native.load() is None
    st = native.status()
    assert st["path"] == "numpy" and "g++" in st["reason"]
    # announced once
    assert capsys.readouterr().err.count("numpy plain versions") == 1
    assert native.draw_prologue(np.zeros(0, np.uint64), np.zeros((0, 4, 4), np.float32),
                                *[np.zeros(0, np.int32)] * 3, 1) is None


def test_plain_forces_the_numpy_path():
    with native.plain():
        assert native.load() is None
        assert native.status()["path"] == "numpy"
    assert native.load() is not None


def _random_draws(rng, n):
    keys = rng.integers(0, 1 << 20, n).astype(np.uint64) << np.uint64(40)
    keys[rng.random(n) < 0.5] = keys[0]  # runs of equal keys (merge groups)
    transforms = rng.standard_normal((n, 4, 4)).astype(np.float32)
    material = rng.integers(0, 64, n).astype(np.int32)
    joints = rng.integers(0, 512, n).astype(np.int32)
    skinned = rng.integers(0, 2, n).astype(np.int32)
    return keys, transforms, material, joints, skinned


@pytest.mark.parametrize("n", [1, 7, 300])
def test_draw_prologue_matches_the_jax_library(n):
    rng = np.random.default_rng(n)
    args = _random_draws(rng, n)
    cap = 1 << int(np.ceil(np.log2(max(n, 1))))
    got = native.draw_prologue(*args, cap)
    want = jnative.draw_prologue(*args, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _draw_scene(pkg, rng):
    """A scene of many draws over a few meshes and materials, with repeats
    (instance merging), queued in a seeded order (the skinned column is
    covered by the animation tests below)."""
    registry, builder = pkg.MaterialRegistry(), pkg.VertexLibraryBuilder()
    meshes = []
    for i in range(5):
        p = rng.standard_normal((4, 3)).astype(np.float32)
        meshes.append(builder.add_mesh(
            p, np.zeros((4, 2), np.float32), np.tile([0, 0, 1.0], (4, 1)).astype(np.float32),
            np.tile([1, 0, 0, 1.0], (4, 1)).astype(np.float32),
            np.array([0, 1, 2, 2, 1, 3], np.uint32)))
    builder.build()
    mats = [registry.create_material(f"m{i}", pkg.PbrMaterialParameters(
        base_color_factor=(0.1 * i, 0.5, 0.5, 1.0))) for i in range(3)]
    scene = pkg.Scene()
    for _ in range(200):
        m, k = rng.integers(0, 5), rng.integers(0, 3)
        scene.queue_mesh(meshes[m], mats[k], None,
                         rng.standard_normal((4, 4)).astype(np.float32))
    return scene


def test_frame_view_native_plain_and_jax_are_equal():
    scenes = [_draw_scene(pkg, np.random.default_rng(3)) for pkg in (trt, trt, jrt)]
    fv_native = tds.frame_view(scenes[0])
    with native.plain():
        fv_plain = tds.frame_view(scenes[1])
    fv_jax = jds.frame_view(scenes[2])
    assert fv_native.order.dtype == np.int32 and fv_plain.order.dtype == np.int64
    for fv in (fv_plain, fv_jax):
        np.testing.assert_array_equal(fv_native.order, fv.order)
        np.testing.assert_array_equal(_no_library(fv_native.sorted_keys),
                                      _no_library(fv.sorted_keys))
        np.testing.assert_array_equal(fv_native.pdf, fv.pdf)
        np.testing.assert_array_equal(fv_native.pdi, fv.pdi)
    # the same scene on both paths: the geometry keys too
    scene = scenes[0]
    scene._fv_cache = None
    with native.plain():
        assert tds.frame_view(scene).geom_key == fv_native.geom_key


@pytest.mark.parametrize("h,w", [(1, 1), (5, 3), (16, 33)])
def test_atlas_blit_matches_plain_and_jax(h, w):
    rng = np.random.default_rng(h * 100 + w)
    src = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    base = rng.integers(0, 1 << 32, (h + 9, w + 12), dtype=np.uint64).astype(np.uint32)
    got, plain, want = base.copy(), base.copy(), base.copy()
    assert native.atlas_blit_wrap(src, got, 3, 4)
    with native.plain():
        assert not native.atlas_blit_wrap(src, plain, 3, 4)
        tatlas._blit_wrap(src, plain, 3, 4)
    jnative.atlas_blit_wrap(src, want, 3, 4)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


def test_atlas_blit_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        native.atlas_blit_wrap(np.zeros((4, 4, 4), np.uint8),
                               np.zeros((5, 5), np.uint32), 1, 1)


def test_build_atlas_native_plain_and_jax_are_equal():
    def registry(pkg):
        rng = np.random.default_rng(11)
        reg = pkg.MaterialRegistry()
        for i, (h, w) in enumerate([(8, 8), (13, 7), (32, 64)]):
            img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            reg.register_texture(pkg.Texture([img], pkg.TextureKind.SRGB_COLOR,
                                             name=f"t{i}"))
        return reg

    got = tatlas._build_atlas_uncached(registry(trt))
    with native.plain():
        plain = tatlas._build_atlas_uncached(registry(trt))
    want = jatlas._build_atlas_uncached(registry(jrt))
    for name in ("data", "table", "srgb", "flat", "wrap"):
        np.testing.assert_array_equal(getattr(got, name), getattr(plain, name))
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _images():
    rng = np.random.default_rng(5)
    x, y = np.meshgrid(np.linspace(0, 255, 37), np.linspace(0, 255, 22))
    grad = np.stack([x, y, (x + y) / 2, np.full_like(x, 255)], -1)
    grad = np.clip(grad + rng.normal(0, 8, grad.shape), 0, 255).astype(np.uint8)
    cutout = grad.copy()
    cutout[..., 3] = np.where(rng.random(x.shape) < 0.3, 0, 255)
    noise = rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)
    return {"gradient": grad, "alpha-cutout": cutout, "noise": noise}


@pytest.mark.parametrize("image", ["gradient", "alpha-cutout", "noise"])
def test_bc7_encoders_match_the_jax_library(image):
    img = _images()[image]
    np.testing.assert_array_equal(native.bc7_encode(img), jnative.bc7_encode(img))
    np.testing.assert_array_equal(native.bc7_encode_mode6(img),
                                  jnative.bc7_encode_mode6(img))
    out_t = np.zeros_like(native.bc7_encode_mode6(img))
    out_j = np.zeros_like(out_t)
    np.testing.assert_array_equal(native._bc7_encode_mode6_numpy(img, out_t),
                                  jnative._bc7_encode_mode6_numpy(img, out_j))
    with native.plain():  # the encoder's plain version is the numpy mode 6
        np.testing.assert_array_equal(native.bc7_encode(img), out_t)


# -- the animation paths --------------------------------------------------------


def _snapshot(scene):
    n = scene._n
    return (scene._keys[:n].copy(), scene._transforms[:n].copy(),
            scene._material_id[:n].copy(), scene._joints_offset[:n].copy(),
            scene._skinned[:n].copy(), scene._morph_weights[:n].copy(),
            scene.joint_palette.copy(), scene._joint_cursor)


def _assert_snapshots_equal(a, b, other_package=False):
    names = ("keys", "transforms", "material_id", "joints_offset", "skinned",
             "morph_weights", "palette", "joint_cursor")
    if other_package:
        a = (_no_library(a[0]),) + a[1:]
        b = (_no_library(b[0]),) + b[1:]
    for name, x, y in zip(names, a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def _queue(pkg, gltf, times, transform):
    playing = [(t % a.end_time, a) for t, a in zip(times, gltf.animations)]
    scene = pkg.Scene(world_space=pkg.GLTF)
    ok = gltf.queue_animated(scene, transform, playing)
    return ok, _snapshot(scene), gltf.get_node_transforms(playing)


@contextlib.contextmanager
def _jax_plain():
    """The JAX package's numpy paths (its library unloaded, as
    tests/test_make_ntex.py does it)."""
    lib, failed = jnative._lib, jnative._load_failed
    jnative._lib, jnative._load_failed = None, True
    try:
        yield
    finally:
        jnative._lib, jnative._load_failed = lib, failed


def _differing(a, b):
    """Number of differing values, snapshot field by field."""
    return sum(int(np.count_nonzero(x != y)) for x, y in zip(a, b)
               if isinstance(x, np.ndarray))


def _four_paths(tgltf, jgltf, times, transform):
    """queue_animated + get_node_transforms through the port's library, the
    port's plain version, the JAX package's library and the JAX package's
    numpy path. The port's library equals the JAX library bit for bit, and
    the port's plain version the JAX numpy path. Returns how many values
    the library and the plain version differ in (the same in both
    packages)."""
    def run(pkg, gltf, ctx):
        gltf.invalidate_caches()
        with ctx:
            ok, snap, nodes = _queue(pkg, gltf, times, transform)
            cache = list(gltf._prologue_cache.values())
        gltf.invalidate_caches()
        nodes = [np.full((4, 4), np.nan, np.float32) if m is None else m for m in nodes]
        return ok, snap + tuple(nodes), cache

    ok_n, snap_n, cache_n = run(trt, tgltf, contextlib.nullcontext())
    ok_p, snap_p, cache_p = run(trt, tgltf, native.plain())
    ok_j, snap_j, _ = run(jrt, jgltf, contextlib.nullcontext())
    ok_jp, snap_jp, _ = run(jrt, jgltf, _jax_plain())
    assert cache_n and all(v is not None for v in cache_n)  # the native prologue ran
    assert cache_p and all(v is None for v in cache_p)
    assert ok_n == ok_p == ok_j == ok_jp
    _assert_snapshots_equal(snap_n, snap_j, other_package=True)
    _assert_snapshots_equal(snap_p, snap_jp, other_package=True)
    for a, b in zip(snap_n[8:], snap_j[8:]):  # node transforms
        np.testing.assert_array_equal(a, b)
    for a, b in zip(snap_p[8:], snap_jp[8:]):
        np.testing.assert_array_equal(a, b)
    return _differing(snap_n, snap_p)


def _character(pkg, proxy):
    return proxy.make_skinned_character(pkg.VertexLibraryBuilder(), pkg.MaterialRegistry(),
                                        n_joints=5, segments=8, radial=6)


# The reference's own drift: at these play times the JAX package's library
# and its numpy path differ in the last bit of a few values (the layered
# two-animation pose, re-decomposed in f64 by each in its own order); the
# port reproduces both sides exactly, so it shows the same count.
_REFERENCE_DRIFT = {(1.9, 0.4): 17}


@pytest.mark.parametrize("times", [(0.0, 0.0), (0.7, 1.3), (1.9, 0.4), (0.6,)])
def test_skinned_character_paths_equal(times):
    tg, jg = _character(trt, tproxy), _character(jrt, jproxy)
    tr = np.array(tmath3d.trs(np.array([0.3, 0.0, -0.2], np.float32),
                              np.array([0, 0, 0, 1], np.float32),
                              np.array([1.1, 1.0, 0.9], np.float32)), np.float32)
    assert _four_paths(tg, jg, times, tr) == _REFERENCE_DRIFT.get(times, 0)


@pytest.mark.parametrize("times", [(0.0, 0.0), (0.5, 0.25), (0.3,)])
def test_loader_fixture_paths_equal(times):
    """Two skins and weights channels: palettes for several skins and
    per-draw morph weights through the native block path."""
    tg = tgl.load_gltf(GLTF_PATH, trt.VertexLibraryBuilder(), trt.MaterialRegistry(),
                       device="cpu")
    jg = jgl.load_gltf(GLTF_PATH, jrt.VertexLibraryBuilder(), jrt.MaterialRegistry())
    assert len(tg.skins) >= 2 and tg.has_morph
    assert _four_paths(tg, jg, times, np.eye(4, dtype=np.float32)) == 0


def test_past_end_rolls_back_and_names_the_animation():
    tg = _character(trt, tproxy)
    bad = float(tg.animations[1].end_time) + 1.0
    scene = trt.Scene(world_space=trt.GLTF)
    with pytest.raises(tgl.AnimationError, match="bob"):
        tg.queue_animated(scene, np.eye(4, dtype=np.float32),
                          [(0.1, tg.animations[0]), (bad, tg.animations[1])])
    assert scene._joint_cursor == 0 and scene.draw_count == 0
