"""glTF sampler wrap modes (REPEAT / CLAMP_TO_EDGE / MIRRORED_REPEAT), on the
port's CPU path: the twin of tests/test_sampler_wrap.py, held to the same
GL-spec oracle.

BEYOND the reference: it parses glTF `samplers` but never uses them — every
texture goes through one repeat-mode sampler (descriptors.rs:90-105). Here
the per-texture per-axis address mode is honored by the atlas sampler
(raster/shade.make_sampler `apply_wrap`) with matching border texels
(materials/atlas._with_mode_border), and parsed from glTF sampler wrapS /
wrapT GL enums (assets/gltf_loader.py).

The oracle below implements the OpenGL-spec formulation directly — address
transform on the coordinate, per-tap texel-index wrapping, bilinear weights
— with no shared code with the atlas-border mechanism the sampler uses.
"""

import json
import shutil

import torch
import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker
import renderer_tpu_torch as rt
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.materials.atlas import _build_atlas_uncached
from renderer_tpu_torch.materials.registry import (
    MaterialRegistry,
    Texture,
    TextureKind,
    TextureWrap,
)
from renderer_tpu_torch.raster import shade

GL_REPEAT, GL_CLAMP, GL_MIRROR = 10497, 33071, 33648


def gl_bilinear_oracle(img, u, v, wrap_s, wrap_t):
    """GL-spec single-mip bilinear: coordinate address transform, floor to
    taps, per-tap index wrap (REPEAT wraps indices; CLAMP and MIRROR both
    clamp tap indices after the coordinate transform — the GL spec treats
    post-mirror filtering as clamp-to-edge), bilinear weights. f64."""
    h, w = img.shape[:2]

    def coord(t, mode):
        if mode == TextureWrap.REPEAT:
            return t - np.floor(t)
        if mode == TextureWrap.CLAMP_TO_EDGE:
            return np.clip(t, 0.0, 1.0)
        m = t * 0.5 - np.floor(t * 0.5)
        return 1.0 - np.abs(2.0 * m - 1.0)

    def idx(i, n, mode):
        if mode == TextureWrap.REPEAT:
            return np.mod(i, n)
        return np.clip(i, 0, n - 1)

    uf = coord(np.asarray(u, np.float64), wrap_s) * w - 0.5
    vf = coord(np.asarray(v, np.float64), wrap_t) * h - 0.5
    iu = np.floor(uf).astype(np.int64)
    iv = np.floor(vf).astype(np.int64)
    fu = (uf - iu)[..., None]
    fv = (vf - iv)[..., None]
    tex = img.astype(np.float64) / 255.0

    def tap(du, dv):
        return tex[idx(iv + dv, h, wrap_t), idx(iu + du, w, wrap_s)]

    return (
        tap(0, 0) * (1 - fu) * (1 - fv)
        + tap(1, 0) * fu * (1 - fv)
        + tap(0, 1) * (1 - fu) * fv
        + tap(1, 1) * fu * fv
    )


def _registry_with_modes(rng, modes):
    """One random LINEAR (no sRGB decode → exact vs the oracle) single-mip
    texture per (wrap_s, wrap_t) pair. Distinct sizes exercise non-square
    rects."""
    registry = MaterialRegistry()
    texs = []
    for k, (ws, wt) in enumerate(modes):
        img = rng.integers(0, 256, size=(5 + k, 7 - k, 4), dtype=np.uint8)
        t = Texture([img], TextureKind.LINEAR_COLOR, f"wrap-{ws}{wt}",
                    wrap_s=ws, wrap_t=wt)
        registry.register_texture(t)
        texs.append((t, img))
    return registry, texs


def _materials(atlas, with_wrap=True):
    m = {"atlas": atlas.data, "atlas_table": atlas.table, "atlas_srgb": atlas.srgb}
    if with_wrap:
        m["atlas_wrap"] = atlas.wrap
    return from_numpy_arrays(m, device="cpu")


def _uv_grid():
    # crosses negatives, zero, exact integers, and several periods
    u = np.linspace(-2.25, 3.5, 24, dtype=np.float32)
    v = np.linspace(-1.75, 2.5, 18, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    return uu, vv


MODES = [
    (TextureWrap.REPEAT, TextureWrap.REPEAT),
    (TextureWrap.CLAMP_TO_EDGE, TextureWrap.CLAMP_TO_EDGE),
    (TextureWrap.MIRRORED_REPEAT, TextureWrap.MIRRORED_REPEAT),
    (TextureWrap.CLAMP_TO_EDGE, TextureWrap.MIRRORED_REPEAT),
    (TextureWrap.MIRRORED_REPEAT, TextureWrap.REPEAT),
]


class TestSamplerWrapModes:
    def setup_method(self):
        rng = np.random.default_rng(29)
        self.registry, self.texs = _registry_with_modes(rng, MODES)
        self.atlas = _build_atlas_uncached(self.registry)

    def _sample(self, tex, uu, vv, with_wrap=True):
        mats = _materials(self.atlas, with_wrap)
        uv = torch.as_tensor(np.stack([uu, vv], axis=-1))
        slot = torch.full(uu.shape, tex.slot, dtype=torch.int32)
        # lod_base forces mip 0 through the no-derivative path:
        # lod = lod_base + log2(max(w, h)); single-mip textures make any
        # residual rounding land on the same rect regardless
        lod0 = torch.full(uu.shape, float(-np.log2(max(tex.width, tex.height))),
                          dtype=torch.float32)
        sampler = shade.make_sampler(mats, uv, lod0, trilinear=False)
        return np.asarray(sampler(slot))

    @pytest.mark.parametrize("mode_idx", range(len(MODES)))
    def test_matches_gl_oracle(self, mode_idx):
        ws, wt = MODES[mode_idx]
        tex, img = self.texs[mode_idx]
        uu, vv = _uv_grid()
        got = self._sample(tex, uu, vv)
        want = gl_bilinear_oracle(img, uu, vv, ws, wt)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_absent_wrap_table_is_repeat(self):
        """A materials dict without atlas_wrap (hand-built dicts; registries
        with only repeat textures, engine/renderer._materials) samples in
        pure-repeat mode — the pre-wrap sampler, bit for bit."""
        tex, img = self.texs[0]  # the (REPEAT, REPEAT) texture
        uu, vv = _uv_grid()
        with_table = self._sample(tex, uu, vv, with_wrap=True)
        without = self._sample(tex, uu, vv, with_wrap=False)
        np.testing.assert_array_equal(with_table, without)

    def test_clamp_holds_far_from_the_edge(self):
        """Several periods out, CLAMP returns exactly the edge texel."""
        idx = 1  # (CLAMP, CLAMP)
        tex, img = self.texs[idx]
        got = self._sample(tex, np.full((3, 3), 50.0, np.float32),
                           np.full((3, 3), -50.0, np.float32))
        want = img[0, -1].astype(np.float64) / 255.0  # v clamps low, u high
        np.testing.assert_allclose(got, np.broadcast_to(want, (3, 3, 4)),
                                   atol=2e-5)


class TestAtlasBorders:
    def test_border_texels_match_modes(self):
        rng = np.random.default_rng(31)
        registry, texs = _registry_with_modes(rng, MODES)
        atlas = _build_atlas_uncached(registry)

        def packed(rgba):
            return (int(rgba[0]) | int(rgba[1]) << 8 | int(rgba[2]) << 16
                    | int(rgba[3]) << 24)

        for (ws, wt), (tex, img) in zip(MODES, texs):
            x, y, w, h = atlas.table[tex.slot, 0]
            assert (w, h) == img.shape[1::-1][:2] == (img.shape[1], img.shape[0])
            top = atlas.data[y - 1, x : x + w]
            left = atlas.data[y : y + h, x - 1]
            # REPEAT wraps to the far edge; CLAMP and MIRROR replicate the
            # near edge (a 1-texel mirror reflection IS the edge texel)
            want_top = img[-1] if wt == TextureWrap.REPEAT else img[0]
            want_left = (img[:, -1] if ws == TextureWrap.REPEAT
                         else img[:, 0])
            np.testing.assert_array_equal(
                top, [packed(p) for p in want_top])
            np.testing.assert_array_equal(
                left, [packed(p) for p in want_left])
            assert tuple(atlas.wrap[tex.slot]) == (ws, wt)


class TestGltfSamplerParse:
    def test_wrap_modes_parse_from_samplers(self, tmp_path):
        """Inject glTF samplers into a copy of the committed loader fixture
        and check the registered Texture carries them (the reference parses
        `samplers` and ignores them, gltf crate; we honor them)."""
        from tests.make_loader_fixture import BIN_PATH, GLTF_PATH

        g = json.loads(GLTF_PATH.read_text())
        g["samplers"] = [{"wrapS": GL_CLAMP, "wrapT": GL_MIRROR}]
        g["textures"][0]["sampler"] = 0
        (tmp_path / GLTF_PATH.name).write_text(json.dumps(g))
        shutil.copy(BIN_PATH, tmp_path / BIN_PATH.name)

        from renderer_tpu_torch.assets.gltf_loader import load_gltf

        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        gltf = load_gltf(tmp_path / GLTF_PATH.name, builder, registry, device="cpu")
        tex = gltf.textures[0]
        assert (tex.wrap_s, tex.wrap_t) == (TextureWrap.CLAMP_TO_EDGE,
                                            TextureWrap.MIRRORED_REPEAT)

    def test_missing_sampler_defaults_to_repeat(self):
        from tests.make_loader_fixture import GLTF_PATH, BIN_PATH  # noqa: F401
        from renderer_tpu_torch.assets.gltf_loader import load_gltf

        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        gltf = load_gltf(GLTF_PATH, builder, registry, device="cpu")
        tex = gltf.textures[0]
        assert (tex.wrap_s, tex.wrap_t) == (TextureWrap.REPEAT,
                                            TextureWrap.REPEAT)

    def test_explicit_sampler_beats_samplerless_claim(self):
        """A samplerless texture referencing an image must not pin the image
        to default REPEAT when another texture samples it with an explicit
        non-repeat sampler (per-image wrap state picks the explicit one)."""
        from renderer_tpu_torch.assets.gltf_loader import _image_wrap_modes

        g = {
            "samplers": [{"wrapS": GL_CLAMP, "wrapT": GL_CLAMP}],
            "textures": [{"source": 0},                  # samplerless first
                         {"source": 0, "sampler": 0}],   # explicit second
        }
        assert _image_wrap_modes(g) == {
            0: (TextureWrap.CLAMP_TO_EDGE, TextureWrap.CLAMP_TO_EDGE)}

    def test_conflicting_explicit_samplers_keep_first_and_warn(self):
        from renderer_tpu_torch.assets.gltf_loader import _image_wrap_modes

        g = {
            "samplers": [{"wrapS": GL_CLAMP, "wrapT": GL_CLAMP},
                         {"wrapS": GL_MIRROR, "wrapT": GL_MIRROR}],
            "textures": [{"source": 0, "sampler": 0},
                         {"source": 0, "sampler": 1}],
        }
        with pytest.warns(UserWarning, match="conflicting sampler"):
            wrap = _image_wrap_modes(g)
        assert wrap == {
            0: (TextureWrap.CLAMP_TO_EDGE, TextureWrap.CLAMP_TO_EDGE)}

    def test_proxy_loader_parses_wrap_modes(self, tmp_path):
        """load_gltf_proxy registers the same wrap modes as load_gltf would
        for the same asset (the sandbox's missing-buffers fallback path must
        not diverge from the real loader)."""
        from renderer_tpu_torch.assets import png
        from renderer_tpu_torch.tools.make_ntex import main as make_ntex

        img = np.zeros((16, 16, 4), np.uint8)
        img[..., 3] = 255
        png.write_png(tmp_path / "checker.png", img)
        assert make_ntex(["--silent", "--assume-color",
                          str(tmp_path / "checker.png")]) == 0

        g = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "samplers": [{"wrapS": GL_MIRROR, "wrapT": GL_CLAMP}],
            "images": [{"uri": "checker.png"}],
            "textures": [{"source": 0, "sampler": 0}],
            "materials": [{"pbrMetallicRoughness":
                           {"baseColorTexture": {"index": 0}}}],
            "meshes": [{"primitives": [
                {"attributes": {"POSITION": 0}, "indices": 1, "material": 0}
            ]}],
            "accessors": [
                {"count": 3, "min": [-1, -1, -1], "max": [1, 1, 1]},
                {"count": 3},
            ],
        }
        (tmp_path / "proxy.gltf").write_text(json.dumps(g))

        from renderer_tpu_torch.assets.proxy import load_gltf_proxy

        registry = rt.MaterialRegistry()
        builder = rt.VertexLibraryBuilder()
        gltf = load_gltf_proxy(tmp_path / "proxy.gltf", builder, registry, device="cpu")
        tex = gltf.textures[0]
        assert (tex.wrap_s, tex.wrap_t) == (TextureWrap.MIRRORED_REPEAT,
                                            TextureWrap.CLAMP_TO_EDGE)
