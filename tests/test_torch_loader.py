"""The port's glTF parser against the JAX package's on the CPU.

- Every accessor of tests/fixtures/strided.gltf (interleaved, tight, offset,
  u8/u16/u32, MAT4, sparse) reads to the same values and dtype.
- load_gltf of the fixture, and of a GLB packed in memory from it, gives
  equal node transforms, material parameters, embedded-PNG mips (the port's
  png.py against Pillow), vertex-library arrays (morph banks included),
  animation channels and skins.
- The malformed inputs of tests/test_loader_validation.py, and the loader's
  other refusals, raise the same GltfLoadingError (type and message).
- The port's CPU render of the fixture matches
  tests/golden/loader-fixture-golden.npz within the golden tolerance (±2 u8
  on < 0.5% of pixels) with every overflow stat 0.
"""

import base64
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker

import renderer_tpu as jrt
import renderer_tpu_torch as trt
from renderer_tpu.assets import gltf_loader as jgl
from renderer_tpu_torch.assets import gltf_loader as tgl
from tests.make_loader_fixture import BIN_PATH, GLTF_PATH

GOLDEN = Path(__file__).parent / "golden" / "loader-fixture-golden.npz"
N_ACCESSORS = len(json.loads(GLTF_PATH.read_text())["accessors"])


def _load(pkg, loader, path):
    registry, builder = pkg.MaterialRegistry(), pkg.VertexLibraryBuilder()
    kw = {"device": "cpu"} if pkg is trt else {}
    gltf = loader.load_gltf(path, builder, registry, **kw)
    return registry, builder.build(), gltf


def _glb_bytes() -> bytes:
    """The fixture as one GLB: its JSON (buffer 0 without a uri) and its
    .bin as the BIN chunk."""
    gltf = json.loads(GLTF_PATH.read_text())
    del gltf["buffers"][0]["uri"]
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    binc = BIN_PATH.read_bytes()
    binc += b"\0" * (-len(binc) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binc), 0x004E4942) + binc)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body


@pytest.fixture(scope="module", params=["gltf", "glb"])
def both(request, tmp_path_factory):
    if request.param == "gltf":
        path = GLTF_PATH
    else:
        path = tmp_path_factory.mktemp("glb") / "strided.glb"
        path.write_bytes(_glb_bytes())
    return _load(jrt, jgl, path), _load(trt, tgl, path)


@pytest.mark.parametrize("index", range(N_ACCESSORS))
def test_accessor_reads_like_jax(index):
    gltf = json.loads(GLTF_PATH.read_text())
    spec = gltf["accessors"][index]
    ja = jgl._Accessors(gltf, GLTF_PATH.parent, None)
    ta = tgl._Accessors(gltf, GLTF_PATH.parent, None)
    want = ja.read(index, spec["componentType"], spec["type"])
    got = ta.read(index, spec["componentType"], spec["type"])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype", [5120, 5121, 5122, 5123, 5126])
def test_dequantize_anim_like_jax(ctype):
    rng = np.random.default_rng(ctype)
    dt = tgl._CTYPE_NP[ctype]
    if ctype == 5126:
        v = rng.normal(size=(16, 4)).astype(dt)
    else:
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, (16, 4), endpoint=True).astype(dt)
    want = jgl._dequantize_anim(v, ctype)
    got = tgl._dequantize_anim(v, ctype)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_nodes_like_jax(both):
    (_, _, jg), (_, _, tg) = both
    assert tg.root_nodes == jg.root_nodes
    for a, b in zip(jg.nodes, tg.nodes, strict=True):
        assert (a.name, a.mesh, a.skin, a.children) == (b.name, b.mesh, b.skin, b.children)
        np.testing.assert_array_equal(b.transform, a.transform)
        assert (a.weights is None) == (b.weights is None)
        if a.weights is not None:
            np.testing.assert_array_equal(b.weights, a.weights)
    for a, b in zip(jg.mesh_weights, tg.mesh_weights, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)


def test_materials_like_jax(both):
    (jreg, _, jg), (treg, _, tg) = both
    for a, b in zip(jg.materials, tg.materials, strict=True):
        assert (a.name, a.id) == (b.name, b.id)
        pa, pb = vars(a.params), vars(b.params)
        for k in pa:
            if k in ("base_color", "metallic_roughness", "normal", "occlusion", "emissive"):
                assert (pa[k] is None) == (pb[k] is None), k
                if pa[k] is not None:
                    assert pa[k].slot == pb[k].slot
            else:
                assert pa[k] == pb[k], k
    for k in ("base_color_factor", "emissive_occlusion", "alpha_rgh_mtl_normal",
              "tex_indices", "alpha_mode"):
        np.testing.assert_array_equal(getattr(treg, k), getattr(jreg, k), k)


def test_embedded_png_mips_like_jax(both):
    """The fixture's embedded PNG decoded by the port's png.py (JAX: Pillow),
    then the same mip chain."""
    (_, _, jg), (_, _, tg) = both
    assert len(tg.textures) == len(jg.textures) == 1
    a, b = jg.textures[0], tg.textures[0]
    assert (a.name, a.kind, a.wrap_s, a.wrap_t, a.slot) == \
        (b.name, b.kind, b.wrap_s, b.wrap_t, b.slot)
    assert len(a.mips) == len(b.mips) == 4
    for x, y in zip(a.mips, b.mips, strict=True):
        np.testing.assert_array_equal(y, x)


def test_vertex_library_like_jax(both):
    (_, jlib, jg), (_, tlib, tg) = both
    for k in ("positions", "uvs", "normals", "tangents", "joints", "weights",
              "indices", "morph_pos", "morph_nrm", "morph_row0", "morph_step"):
        a, b = getattr(jlib, k), getattr(tlib, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, k)
    shape = [[(m.vertex_offset, m.vertex_count, m.index_count, m.morph_count, m.skinned)
              for m, _ in prims] for prims in jg.meshes]
    assert [[(m.vertex_offset, m.vertex_count, m.index_count, m.morph_count, m.skinned)
             for m, _ in prims] for prims in tg.meshes] == shape


def test_animations_like_jax(both):
    (_, _, jg), (_, _, tg) = both
    assert len(tg.animations) == len(jg.animations) == 2
    for a, b in zip(jg.animations, tg.animations, strict=True):
        assert (a.name, a.start_time, a.end_time) == (b.name, b.start_time, b.end_time)
        for ca, cb in zip(a.nodes_channels, b.nodes_channels, strict=True):
            assert (ca is None) == (cb is None)
            for x, y in zip(ca or [], cb or [], strict=True):
                assert (x.interpolation, x.path) == (y.interpolation, y.path)
                for k in ("times", "values", "in_tangents", "out_tangents"):
                    u, v = getattr(x, k), getattr(y, k)
                    assert (u is None) == (v is None), k
                    if u is not None:
                        assert u.dtype == v.dtype, k
                        np.testing.assert_array_equal(v, u, k)


def test_skins_like_jax(both):
    (_, _, jg), (_, _, tg) = both
    assert len(tg.skins) == len(jg.skins) == 2
    for a, b in zip(jg.skins, tg.skins, strict=True):
        assert [j.node_index for j in a.joints] == [j.node_index for j in b.joints]
        for x, y in zip(a.joints, b.joints, strict=True):
            np.testing.assert_array_equal(y.inverse_bind_matrix, x.inverse_bind_matrix)


# -- refusals: the same GltfLoadingError in both packages -------------------


def _acc_case(views, accessors, buf):
    def run(gl):
        gltf = {"bufferViews": views, "accessors": accessors,
                "buffers": [{"byteLength": len(buf)}]}
        return gl._Accessors(gltf, None, buf).read(0, 5126, "VEC3")
    return run


def _glb(chunks, total=None):
    body = b""
    for ctype, payload in chunks:
        pad = (-len(payload)) % 4
        body += struct.pack("<II", len(payload) + pad, ctype)
        body += payload + (b" " if ctype == 0x4E4F534A else b"\x00") * pad
    data = struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body
    return data if total is None else data[:total]


_JSON = (0x4E4F534A, b'{"asset": {"version": "2.0"}}')


def _fixture_json():
    return json.loads(GLTF_PATH.read_text())


def _edit(fn):
    """A load_gltf case: the fixture JSON edited by fn, written next to the
    fixture's .bin."""
    def run(gl, tmp_path):
        gltf = _fixture_json()
        gltf["buffers"][0]["uri"] = GLTF_PATH.with_name("strided.bin").as_posix()
        fn(gltf)
        p = tmp_path / "case.gltf"
        p.write_text(json.dumps(gltf))
        pkg = trt if gl is tgl else jrt
        kw = {"device": "cpu"} if gl is tgl else {}
        return gl.load_gltf(p, pkg.VertexLibraryBuilder(), pkg.MaterialRegistry(), **kw)
    return run


def _set(path, value):
    def fn(g):
        node = g
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return fn


def _del(path):
    def fn(g):
        node = g
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return fn


def _png_case(ihdr_tail):
    """The fixture with its embedded image replaced by a PNG whose IHDR
    carries (bit depth, colour type, interlace)."""
    def fn(g):
        from renderer_tpu_torch.assets import png

        depth, ctype, interlace = ihdr_tail
        ihdr = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
        data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", b"") + png._chunk(b"IEND", b""))
        g["buffers"].append({"byteLength": len(data), "uri": "data:;base64,"
                             + base64.b64encode(data).decode()})
        g["bufferViews"].append({"buffer": len(g["buffers"]) - 1,
                                 "byteLength": len(data)})
        g["images"][0]["bufferView"] = len(g["bufferViews"]) - 1
    return fn


_F32_24 = np.arange(24, dtype=np.float32).tobytes()
REFUSALS = {
    "accessor-past-view": _acc_case(
        [{"buffer": 0, "byteOffset": 0, "byteLength": 48}],
        [{"bufferView": 0, "componentType": 5126, "type": "VEC3", "count": 8}], _F32_24),
    "accessor-offset-past-view": _acc_case(
        [{"buffer": 0, "byteOffset": 0, "byteLength": 48}],
        [{"bufferView": 0, "componentType": 5126, "type": "VEC3", "count": 4,
          "byteOffset": 12}], _F32_24),
    "strided-past-view": _acc_case(
        [{"buffer": 0, "byteOffset": 0, "byteLength": 64, "byteStride": 24}],
        [{"bufferView": 0, "componentType": 5126, "type": "VEC3", "count": 4}], bytes(64)),
    "truncated-buffer": _acc_case(
        [{"buffer": 0, "byteOffset": 0, "byteLength": 96}],
        [{"bufferView": 0, "componentType": 5126, "type": "VEC3", "count": 8}], bytes(40)),
    "component-type": _acc_case(
        [{"buffer": 0, "byteLength": 48}],
        [{"bufferView": 0, "componentType": 5123, "type": "VEC3", "count": 4}], _F32_24),
    "accessor-type": _acc_case(
        [{"buffer": 0, "byteLength": 48}],
        [{"bufferView": 0, "componentType": 5126, "type": "VEC2", "count": 4}], _F32_24),
    "glb-truncated-bin": lambda gl: gl._parse_glb(
        _glb([_JSON, (0x004E4942, bytes(64))])[:-32]),
    "glb-truncated-json": lambda gl: gl._parse_glb(_glb([_JSON])[:20]),
    "glb-bad-magic": lambda gl: gl._parse_glb(b"glTX" + _glb([_JSON])[4:]),
    "glb-version-1": lambda gl: gl._parse_glb(
        _glb([_JSON])[:4] + struct.pack("<I", 1) + _glb([_JSON])[8:]),
    "glb-no-json": lambda gl: gl._parse_glb(_glb([(0x004E4942, bytes(8))])),
    "dequantize-u32": lambda gl: gl._dequantize_anim(np.zeros((1, 4), np.uint32), 5125),
    "unknown-alpha-mode": _edit(_set(["materials", 0, "alphaMode"], "BLEND ")),
    "no-pbr": _edit(_del(["materials", 0, "pbrMetallicRoughness"])),
    "tex-coord-1": _edit(_set(["materials", 0, "pbrMetallicRoughness",
                               "baseColorTexture", "texCoord"], 1)),
    "no-scene": _edit(_del(["scene"])),
    "empty-scene": _edit(_set(["scenes", 0, "nodes"], [])),
    "node-cycle": _edit(_set(["nodes", 1, "children"], [0])),
    "version-3": _edit(_set(["asset", "version"], "3.0")),
    "missing-indices": _edit(_del(["meshes", 0, "primitives", 0, "indices"])),
    "index-u8": _edit(lambda g: g["accessors"][
        g["meshes"][0]["primitives"][0]["indices"]].update(componentType=5121)),
    "missing-position": _edit(_del(["meshes", 0, "primitives", 0, "attributes",
                                    "POSITION"])),
    "missing-material": _edit(_del(["meshes", 0, "primitives", 0, "material"])),
    "bad-interpolation": _edit(_set(["animations", 0, "samplers", 0,
                                     "interpolation"], "SMOOTH")),
    "input-without-min-max": _edit(lambda g: [
        g["accessors"][s["input"]].pop(k, None)
        for a in g["animations"] for s in a["samplers"] for k in ("min", "max")]),
    "skin-index-out-of-range": _edit(_set(["nodes", 1, "skin"], 9)),
    "ibm-count": _edit(lambda g: g["skins"][0]["joints"].append(0)),
    "image-without-source": _edit(_del(["images", 0, "bufferView"])),
    "png-interlaced": _edit(_png_case((8, 6, 1))),
    "png-depth-4": _edit(_png_case((4, 3, 0))),
}


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_like_jax(case, tmp_path):
    fn = REFUSALS[case]
    nargs = fn.__code__.co_argcount
    call = (lambda gl: fn(gl, tmp_path)) if nargs == 2 else fn
    got = _raised(lambda: call(tgl))
    assert got is not None and got[0] == "GltfLoadingError", got
    if case.startswith("png-"):
        # an interlaced and a 4-bit image, both without image data: Pillow
        # refuses them as truncated (OSError), the port names the stream
        assert "PNG image data is not a complete zlib stream" in got[1], got
        return
    assert got == _raised(lambda: call(jgl))


def test_fixture_render_matches_the_golden():
    """The port's CPU frame of the fixture (every animation playing at
    t = 0.7 s, 160×96, 4×MSAA) against the JAX package's golden."""
    from renderer_tpu_torch.core import math3d

    registry, _lib, gltf = _load(trt, tgl, GLTF_PATH)
    scene = trt.Scene(world_space=trt.GLTF)
    scene.camera.position, scene.camera.orientation = math3d.look_at(
        np.array([0.3, 1.2, 4.0], np.float32), np.array([0.3, 0.5, 0.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32))
    gltf.queue_animated(scene, math3d.IDENTITY,
                        [(0.7 % a.end_time, a) for a in gltf.animations])
    r = trt.Renderer(registry, trt.RenderConfig(width=160, height=96, msaa_samples=4),
                     device="cpu")
    img = r.render_frame(scene, debug_mode=0)
    assert sum(v for k, v in r.frame_stats().items() if "overflow" in k) == 0
    want = np.load(GOLDEN)["loader-fixture"]
    diff = np.abs(img.astype(int) - want.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.005, f"{(diff > 2).mean():.2%} drifted (max {diff.max()})"
